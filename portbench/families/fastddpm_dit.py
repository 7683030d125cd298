"""DiT-XL/8 as a pixel-space slice denoiser, served int8_deep, as
``export-serving --model fastddpm_dit --quant int8_deep`` and ``serve``
make it: a checkpoint of the seeded model under DiT's names (its fixed
``pos_embed`` table included), ``export_serving_bundle``
(``calibrate_fastddpm`` over the sampler's own trajectory, the 112 block
linears in int8; serving runs kernel L at the 57 LayerNorms, kernel A at
the block linears (its GELU form at ``fc1``), kernel E's gated form at the
56 gated residuals and torch's fused attention at the 28 attention cores),
and ``engine_from_bundle``.  The served call's noise is the ``fastddpm``
family's; the sampler reads the first of the two output channels.

Compared: each sampled answer against this network's float32 reference
sampler (TF32 off) on the same noise: the RMS difference over the
reference's standard deviation (rel-RMSE, ``core.gap_readings``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench import core
from portbench.families import fastddpm
from portbench.families.fastddpm import batch_noise
from portbench.reference import counts, counts_dit
from portbench.reference import fastddpm_dit as ref
from portbench.weights import draw

needs_rows = True
NUMBER = "rel_rmse"
REF_BLOCK = 8


def _w(cfg):
    wd = cfg["widths"]
    return (int(wd["hidden_size"]), int(wd["depth"]), int(wd["patch_size"]),
            int(wd["in_channels"]), int(wd["out_channels"]))


def _heads(cfg):
    return int(cfg["widths"]["num_heads"])


# the adaLN linears' biases: N(0, 0.5^2), so that a block's gates, scales
# and shifts are of order 0.5 and the blocks carry the answer
ADA_BIAS_STD = 0.5


def _rule(shapes: Dict[str, Tuple[int, ...]]):
    """PyTorch's default init's variance (U(-1/sqrt(fan), 1/sqrt(fan))
    for weights and biases, the fan a bias's weight's) as normals, the
    adaLN linears and the final layer included, which DiT's adaLN-Zero
    init zeroes (zeroed, every block would be the identity and the answer
    zero); the adaLN biases N(0, ``ADA_BIAS_STD``^2).  With the default
    init's adaLN rows (about 0.06) every block stays within a few percent
    of the identity: int8 at the block linears moved one forward's answer
    by 0.15 % and int4 by 2.8 %, below bf16's own rounding (1.5 %), so no
    check could see the linears; with these biases 1.6 %, 28 % and 1.2 %
    (the reference at 256^2, one forward, scales from its own input)."""
    def rule(name: str, shape: Tuple[int, ...]):
        if name.endswith("adaLN_modulation.1.bias"):
            return ("normal", ADA_BIAS_STD, 0.0)
        weight = (shapes[name[:-len("bias")] + "weight"]
                  if name.endswith(".bias") else shape)
        return ("normal", 1.0 / math.sqrt(3.0 * math.prod(weight[1:])), 0.0)

    return rule


def weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    hidden, depth, patch, cin, cout = _w(cfg)
    shapes = ref.param_shapes(hidden, depth, patch, cin, cout)
    w = draw(shapes, _rule(shapes), seed, device)
    w["pos_embed"] = ref.pos_embed(
        hidden, int(cfg["image_size"]) // patch).to(device)
    return w


def build(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], calib: List,
          workdir: str, device, engine: Dict[str, Any]):
    hidden = _w(cfg)[0]
    return fastddpm.build(
        core.merged(cfg, {"widths": {"base_features": hidden,
                                     "time_dim": hidden}}),
        w, calib, workdir, device, engine)


def sites(cfg: Dict[str, Any], batch: int):
    hidden, depth, patch, _, _ = _w(cfg)
    return counts_dit.kernel_sites(batch, int(cfg["image_size"]), hidden,
                                   depth, patch)


def slice_ideal_s(cfg: Dict[str, Any]) -> float:
    hidden, depth, patch, cin, cout = _w(cfg)
    return counts.ideal_s(counts_dit.model_ops(
        int(cfg["image_size"]), hidden, depth, patch,
        int(cfg["sampler"]["steps"]), cin, cout))


@torch.no_grad()
def compare(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], samples: List,
            pool: np.ndarray, device, batch: int, calib: List, bits=None):
    """Each sampled answer's RMS distance from the float32 reference
    sampler on the same noise and the reference's standard deviation, by
    sample; with ``bits`` the reference sampler with its int8_deep linears
    served at that precision, calibrated on ``calib``'s trajectories,
    stands in for the answers."""
    hw, steps = int(cfg["image_size"]), int(cfg["sampler"]["steps"])
    n_t, heads = cfg["sampler"]["num_timesteps"], _heads(cfg)
    x_t, zs = batch_noise(batch, hw, steps, device)
    with core.fp32():
        quant = (ref.calibrated(w, calib, bits, device, steps, n_t, heads)
                 if bits else None)
        errs, norms = [], []
        for i in range(0, len(samples), REF_BLOCK):
            chunk = samples[i:i + REF_BLOCK]
            rows = torch.tensor([r for _, _, _, r in chunk], device=device)
            cond = torch.from_numpy(np.stack([pool[v, p] for v, p, _, _ in
                                              chunk])).to(device)
            noise = (x_t[rows], [z[rows] for z in zs])
            want = ref.sample(w, cond, *noise, None, n_t, heads).double()
            got = (ref.sample(w, cond, *noise, quant, n_t, heads) if bits
                   else torch.from_numpy(np.stack([y for _, _, y, _ in
                                                   chunk])).to(device)
                   ).double()
            errs += (got - want).square().mean(dim=(1, 2, 3)).sqrt().tolist()
            norms += want.std(dim=(1, 2, 3)).tolist()
        return errs, norms
