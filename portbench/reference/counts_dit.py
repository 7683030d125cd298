"""Operations and bytes of DiT-XL/8 (``reference/fastddpm_dit.py``),
served ``int8_deep``, from its shapes, by the rules of
``reference/counts.py``.

Every launch that one denoiser call makes of kernel A and of kernel L is a
site.  Kernel A at the 112 block linears, as 1x1 convs over the ``(H / p)
x (W / p)`` token map: ``qkv``, ``proj`` and ``fc2`` with float32 out,
``fc1`` with its GELU form's int8 codes (``fc2``'s input) out.  Kernel L at
the 57 LayerNorms (two a block and the final layer's): bf16 x in, int8
codes out (the 56 that feed ``qkv`` and ``fc1``) or bf16 (the final
layer's), the image's ``(B, 2 C)`` float32 (shift, scale) rows read once;
its float32 operations (the normalization, the modulation and, for codes,
the quantizer) are counted at 67 TFLOP/s, its float64 sums left out (about
a tenth of its byte time at the FP64 rate).  The rest runs in bf16: the
patch embedding, the attention cores, the time MLP, the adaLN linears and
the final linear.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference import fastddpm_dit as ref
from portbench.reference.counts import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    Site,
    conv_site,
)

# float32 operations an element of kernel L: x - mean, * rstd,
# * (1 + scale), + shift; the quantizer's division, clamp and rounding
L_OPS, L_QUANT = 4, 3


def l_site(name: str, n: int, tokens: int, c: int, codes: bool) -> Site:
    """Kernel L at one LayerNorm of ``n`` images of ``tokens`` tokens:
    bf16 in, codes or bf16 out, the ``(n, 2 c)`` float32 rows read."""
    elems = n * tokens * c
    return (name, float((L_OPS + L_QUANT * codes) * elems),
            float((2 + (1 if codes else 2)) * elems + 8 * n * c),
            PEAK_FP32_FLOPS)


def _grid(hw: int, patch: int) -> int:
    return hw // patch


def kernel_sites(n: int, hw: int = 256, hidden: int = ref.HIDDEN,
                 depth: int = ref.DEPTH, patch: int = ref.PATCH
                 ) -> Dict[str, List[Site]]:
    """Kernel A's and kernel L's sites of one int8_deep denoiser call of
    ``n`` rows."""
    g, c, m = _grid(hw, patch), hidden, ref.MLP_RATIO * hidden
    a, lsites = [], []
    for i in range(depth):
        name = f"blocks.{i}"
        a += [conv_site(f"{name}.attn.qkv", n, g, c, 3 * c, 1, 4),
              conv_site(f"{name}.attn.proj", n, g, c, c, 1, 4),
              conv_site(f"{name}.mlp.fc1", n, g, c, m, 1, 1),
              conv_site(f"{name}.mlp.fc2", n, g, m, c, 1, 4)]
        lsites += [l_site(f"{name}.norm1", n, g * g, c, True),
                   l_site(f"{name}.norm2", n, g * g, c, True)]
    lsites.append(l_site("final_layer.norm_final", n, g * g, c, False))
    return {"kernel_a": a, "kernel_l": lsites}


def model_ops(hw: int = 256, hidden: int = ref.HIDDEN,
              depth: int = ref.DEPTH, patch: int = ref.PATCH,
              steps: int = 10, cin: int = 3, cout: int = 2) -> List[Site]:
    """Every linear, conv and attention matmul of one served slice:
    ``steps`` denoiser calls, the block linears int8 and the rest bf16."""
    g, c = _grid(hw, patch), hidden
    tokens = g * g
    one = list(kernel_sites(1, hw, hidden, depth, patch)["kernel_a"])
    for i in range(depth):  # q k^T and the weights times v, every head
        one.append((f"blocks.{i}.attn.core", 2 * 2.0 * tokens * tokens * c,
                    0.0, PEAK_BF16_FLOPS))
    po = patch * patch * cout
    one += [
        ("x_embedder.proj", 2.0 * tokens * c * cin * patch * patch, 0.0,
         PEAK_BF16_FLOPS),
        ("t_embedder.mlp", 2.0 * (ref.FREQ * c + c * c), 0.0,
         PEAK_BF16_FLOPS),
        ("adaLN_modulation", 2.0 * c * (6 * c * depth + 2 * c), 0.0,
         PEAK_BF16_FLOPS),
        ("final_layer.linear", 2.0 * tokens * c * po, 0.0, PEAK_BF16_FLOPS)]
    return [(f"step{s}/{name}", ops, nbytes, peak)
            for s in range(steps) for name, ops, nbytes, peak in one]
