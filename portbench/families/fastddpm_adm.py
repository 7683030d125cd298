"""ADM's 256^2 diffusion UNet, served int8_deep, as ``export-serving
--model fastddpm_adm --quant int8_deep`` and ``serve`` make it: a
checkpoint of the seeded model under guided-diffusion's names,
``export_serving_bundle`` (``calibrate_fastddpm`` over the sampler's own
trajectory, the 121 convs whose input is at 128^2 or less in int8;
serving runs K3 at every GroupNorm, its scale-shift mode at the 42
out_layers norms, kernel A at the int8 convs and torch's fused attention
at the 16 attention cores), and ``engine_from_bundle`` with the default
GroupNorm path.  The build and the served call's noise are the
``fastddpm`` family's; the sampler reads the first of the two output
channels.

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
from portbench.families.fastddpm import batch_noise, build  # noqa: F401
from portbench.reference import counts, counts_adm
from portbench.reference import fastddpm_adm as ref
from portbench.weights import draw

needs_rows = True
NUMBER = "rel_rmse"
REF_BLOCK = 8
# the GroupNorms' leaves, by the layer that holds them
_NORMS = ("in_layers.0", "out_layers.0", "norm", "out.0")


def _b(cfg):
    return int(cfg["widths"]["base_features"])


def _d(cfg):
    return int(cfg["widths"]["time_dim"])


def _rule(shapes: Dict[str, Tuple[int, ...]]):
    """PyTorch's default init's variance (U(-1/sqrt(fan), 1/sqrt(fan))
    for weights and biases, the fan a bias's weight's) as normals, the
    convs that ADM's training init zeroes (out_layers, proj_out, out)
    included; GroupNorm scales and shifts drawn around the identity."""
    def rule(name: str, shape: Tuple[int, ...]):
        layer = name.rsplit(".", 1)[0]
        if layer.endswith(_NORMS) and len(shape) == 1:
            return (("normal", 0.2, 1.0) if name.endswith("weight")
                    else ("normal", 0.05, 0.0))
        weight = (shapes[name[:-len("bias")] + "weight"]
                  if name.endswith(".bias") else shape)
        return ("normal", 1.0 / math.sqrt(3.0 * math.prod(weight[1:])), 0.0)

    return rule


def weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = ref.param_shapes(_b(cfg), _d(cfg), cfg["widths"]["in_channels"],
                              cfg["widths"]["out_channels"])
    return draw(shapes, _rule(shapes), seed, device)


def sites(cfg: Dict[str, Any], batch: int):
    return counts_adm.kernel_sites(batch, int(cfg["image_size"]), _b(cfg))


def slice_ideal_s(cfg: Dict[str, Any]) -> float:
    return counts.ideal_s(counts_adm.model_ops(
        int(cfg["image_size"]), _b(cfg), _d(cfg),
        int(cfg["sampler"]["steps"])))


@torch.no_grad()
def compare(cfg: Dict[str, Any], w: Dict[str, torch.Tensor], samples: List,
            pool: np.ndarray, device, batch: int, calib: List, bits=None):
    """Each sampled answer's RMS distance from the float32 reference
    sampler on the same noise and the reference's standard deviation, by
    sample; with ``bits`` the reference sampler with its int8_deep sites
    served at that precision, calibrated on ``calib``'s trajectories,
    stands in for the answers."""
    hw, steps = int(cfg["image_size"]), int(cfg["sampler"]["steps"])
    n_t = cfg["sampler"]["num_timesteps"]
    x_t, zs = batch_noise(batch, hw, steps, device)
    with core.fp32():
        quant = (ref.calibrated(w, calib, bits, device, steps, n_t)
                 if bits else None)
        errs, norms = [], []
        for i in range(0, len(samples), REF_BLOCK):
            chunk = samples[i:i + REF_BLOCK]
            rows = torch.tensor([r for _, _, _, r in chunk], device=device)
            cond = torch.from_numpy(np.stack([pool[v, p] for v, p, _, _ in
                                              chunk])).to(device)
            noise = (x_t[rows], [z[rows] for z in zs])
            want = ref.sample(w, cond, *noise, None, n_t).double()
            got = (ref.sample(w, cond, *noise, quant, n_t) if bits else
                   torch.from_numpy(np.stack([y for _, _, y, _ in chunk]))
                   .to(device)).double()
            errs += (got - want).square().mean(dim=(1, 2, 3)).sqrt().tolist()
            norms += want.std(dim=(1, 2, 3)).tolist()
        return errs, norms
