"""Operations and bytes of ADM's diffusion UNet
(``reference/fastddpm_adm.py``), served ``int8_deep``, from its shapes, by
the rules of ``reference/counts.py``.

Every launch that one denoiser call makes of kernel A and of K3 is a site:
kernel A at the 121 int8 convs (float32 out): every conv whose input,
after a down-ResBlock's pool or an up-ResBlock's repeat, is at 128^2 or
less, the 1x1 ``qkv``, ``proj_out`` and skips among them; K3 at all 101
GroupNorms, int8 out where the conv it feeds is int8 and reads the norm's
own maps (the attention norms without SiLU), bf16 out at the full-size
level and at the five down-ResBlocks' first norms (their maps are pooled
before the quantizer), and at the 42 out_layers norms with the ResBlock's
(scale, shift) row read besides.  The rest runs in bf16: the full-size
level, the first and last convs, the up-ResBlock into 256^2, the attention
cores and the dense layers.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference import fastddpm_adm as ref
from portbench.reference.counts import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    Site,
    conv_site,
)
from portbench.reference.counts_pmub import GN_AFFINE, GN_QUANT, GN_SILU, \
    GN_SUMS


def _convs(ch: int):
    """(name, level read, ci, co, k) of every conv."""
    levels = ref.conv_levels(ch)
    for key, shape in ref.param_shapes(ch).items():
        if len(shape) >= 3 and key.endswith(".weight"):
            name = key[:-len(".weight")]
            yield name, levels[name], shape[1], shape[0], shape[-1]


def _norms(ch: int):
    """(name, level of its maps, channels, the conv it feeds, SiLU after
    it, codes out where that conv is int8, scale-shift)."""
    for kind, name, lvl_in, lvl_out, ci, co in ref._blocks(ch):
        if kind == "attn":
            yield f"{name}.norm", lvl_in, co, f"{name}.qkv", False, True, False
            continue
        yield (f"{name}.in_layers.0", lvl_in, ci, f"{name}.in_layers.2",
               True, kind != "down", False)
        yield (f"{name}.out_layers.0", lvl_out, co, f"{name}.out_layers.3",
               True, True, True)
    yield "out.0", 0, ch, "out.2", True, True, False


def gn_site(name: str, n: int, h: int, c: int, int8_out: bool, silu: bool,
            scale_shift: bool) -> Site:
    """K3 at one GroupNorm: bf16 in, int8 codes or bf16 out; a scale-shift
    norm reads its ``(n, 2 c)`` float32 rows besides."""
    elems = n * h * h * c
    ops = GN_SUMS + GN_AFFINE + GN_SILU * silu + GN_QUANT * int8_out
    return (name, float(ops * elems),
            float((2 + (1 if int8_out else 2)) * elems + 8 * c + 4
                  + 8 * n * c * scale_shift), PEAK_FP32_FLOPS)


def kernel_sites(n: int, hw: int = 256, ch: int = 256
                 ) -> Dict[str, List[Site]]:
    """Kernel A's and K3's sites of one int8_deep denoiser call of ``n``
    rows."""
    deep = set(ref.deep_sites(ch))
    a = [conv_site(name, n, hw >> lvl, ci, co, k, 4)
         for name, lvl, ci, co, k in _convs(ch) if name in deep]
    k3 = [gn_site(name, n, hw >> lvl, c, codes and conv in deep, silu, post)
          for name, lvl, c, conv, silu, codes, post in _norms(ch)]
    return {"kernel_a": a, "k3": k3}


def model_ops(hw: int = 256, ch: int = 256, d: int = 1024, steps: int = 10
              ) -> List[Site]:
    """Every conv, attention matmul and dense layer of one served slice:
    ``steps`` denoiser calls, the int8_deep sites int8 and the rest bf16."""
    deep = set(ref.deep_sites(ch))
    one = list(kernel_sites(1, hw, ch)["kernel_a"])
    for name, lvl, ci, co, k in _convs(ch):
        if name not in deep:
            h = hw >> lvl
            one.append((name, 2.0 * h * h * co * k * k * ci, 0.0,
                        PEAK_BF16_FLOPS))
    for kind, name, lvl, _, _, c in ref._blocks(ch):
        if kind == "attn":  # q k^T and the weights times v, every head
            tokens = (hw >> lvl) ** 2
            one.append((f"{name}.core", 2 * 2.0 * tokens * tokens * c, 0.0,
                        PEAK_BF16_FLOPS))
    dense = ch * d + d * d + sum(
        shape[0] * shape[1] for key, shape in ref.param_shapes(ch, d).items()
        if key.endswith("emb_layers.1.weight"))
    one.append(("time_mlp", 2.0 * dense, 0.0, PEAK_BF16_FLOPS))
    return [(f"step{s}/{name}", ops, nbytes, peak)
            for s in range(steps) for name, ops, nbytes, peak in one]
