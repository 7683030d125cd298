"""Operations and bytes of the DDPM UNet that Fast-DDPM publishes
(``reference/fastddpm_pmub.py``), served ``int8_deep``, from its shapes,
by the rules of ``reference/counts.py``.

Every launch that one denoiser call makes of kernel A and of K3 is a site:
kernel A at the 99 int8 convs (float32 out), the 1x1 attention
projections at 16^2 and 8^2 and the 1x1 shortcuts with them, and the conv
after each upsample into a map of 128^2 or less, which reads the
upsampled codes; K3 at all 71 GroupNorms, int8 out where the conv it
feeds is int8 (the attention norms without SiLU), bf16 out at the 11 of
the full-size level.  The rest runs in bf16: the full-size level,
conv_in, conv_out, the five stride-2 downsamples, the attention's two
batched matmuls and the dense layers.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference import fastddpm_pmub as ref
from portbench.reference.counts import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    Site,
    conv_site,
)

# fp32 operations per element of K3: 3 for the sums, 2 for the affine, 5
# for SiLU (exp counted as one), 3 for the quantizer
GN_SUMS, GN_AFFINE, GN_SILU, GN_QUANT = 3, 2, 5, 3


def _level(name: str) -> int:
    """The level of the maps a site reads (0: full size)."""
    parts = name.split(".")
    if parts[0] == "mid":
        return len(ref.CH_MULT) - 1
    if parts[0] in ("down", "up"):
        return int(parts[1]) - (parts[2] == "upsample")
    return 0


def _convs(ch: int):
    """(name, level read, ci, co, k) of every conv."""
    for key, shape in ref.param_shapes(ch).items():
        if len(shape) == 4 and key.endswith(".weight"):
            name = key[:-len(".weight")]
            yield name, _level(name), shape[1], shape[0], shape[2]


def _norms(ch: int):
    """(name, level, channels, the conv it feeds, SiLU after it)."""
    for key, shape in ref.param_shapes(ch).items():
        name = key[:-len(".weight")]
        if len(shape) != 1 or not key.endswith(".weight") or \
                "norm" not in name.rsplit(".", 1)[-1]:
            continue
        leaf = name.rsplit(".", 1)[-1]
        base = name[:-len(leaf) - 1]
        conv = {"norm1": f"{base}.conv1", "norm2": f"{base}.conv2",
                "norm": f"{base}.q", "norm_out": "conv_out"}[leaf]
        yield name, _level(name), shape[0], conv, leaf != "norm"


def gn_site(name: str, n: int, h: int, c: int, int8_out: bool,
            silu: bool) -> Site:
    """K3 at one GroupNorm: bf16 in, int8 codes or bf16 out."""
    elems = n * h * h * c
    ops = GN_SUMS + GN_AFFINE + GN_SILU * silu + GN_QUANT * int8_out
    return (name, float(ops * elems),
            float((2 + (1 if int8_out else 2)) * elems + 8 * c + 4),
            PEAK_FP32_FLOPS)


def kernel_sites(n: int, hw: int = 256, ch: int = 128
                 ) -> Dict[str, List[Site]]:
    """Kernel A's and K3's sites of one int8_deep denoiser call of ``n``
    rows."""
    deep = set(ref.deep_sites(ch))
    a = [conv_site(name, n, hw >> lvl, ci, co, k, 4)
         for name, lvl, ci, co, k in _convs(ch) if name in deep]
    k3 = [gn_site(name, n, hw >> lvl, c, conv in deep, silu)
          for name, lvl, c, conv, silu in _norms(ch)]
    return {"kernel_a": a, "k3": k3}


def model_ops(hw: int = 256, ch: int = 128, d: int = 512, steps: int = 10
              ) -> List[Site]:
    """Every conv, attention matmul and dense layer of one served slice:
    ``steps`` denoiser calls, the int8_deep sites int8 and the rest bf16."""
    deep = set(ref.deep_sites(ch))
    one = list(kernel_sites(1, hw, ch)["kernel_a"])
    for name, lvl, ci, co, k in _convs(ch):
        if name in deep:
            continue
        h = (hw >> lvl) // (2 if ".downsample." in name else 1)
        one.append((name, 2.0 * h * h * co * k * k * ci, 0.0,
                    PEAK_BF16_FLOPS))
    for name, lvl, c, _, silu in _norms(ch):
        if not silu:  # an attention block: q k^T and the weights times v
            tokens = (hw >> lvl) ** 2
            one.append((f"{name[:-len('.norm')]}.core",
                        2 * 2.0 * tokens * tokens * c, 0.0, PEAK_BF16_FLOPS))
    dense = ch * d + d * d + sum(
        shape[0] * shape[1] for key, shape in ref.param_shapes(ch, d).items()
        if key.endswith("temb_proj.weight"))
    one.append(("time_mlp", 2.0 * dense, 0.0, PEAK_BF16_FLOPS))
    return [(f"step{s}/{name}", ops, nbytes, peak)
            for s in range(steps) for name, ops, nbytes, peak in one]
