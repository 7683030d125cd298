"""Kernel L: a LayerNorm over each token's channels, then DiT's modulation
by per-image rows, emitting int8 codes or a float row.

Counterpart: no Pallas kernel (the JAX package serves no transformer).
The CUDA source is ``csrc/layernorm_modulate.cu``: one pass that reads x
once and writes the codes (or the float row) once; it says what bounds
the kernel on the card.

Semantics: ``nn.LayerNorm(C, elementwise_affine=False, eps)`` over the
last axis (biased variance), then DiT's ``modulate``, ``y (1 + scale[b])
+ shift[b]``, with ``shift, scale = shift_scale.chunk(2, dim=1)`` (DiT's
order), then, with ``quant_scale``, the int8 quantizer ``clip(round(y /
scale), -127, 127)`` of the next int8 site, else ``y`` in x's type.  The
statistics are exact sums in float64 rounded once to float32
(:func:`layernorm_modulate_plain` says how), the rest float32 operations
in a fixed order.

:func:`layernorm_modulate` launches the kernel for a CUDA tensor and runs
:func:`layernorm_modulate_plain` for a CPU tensor; it never falls back.
Each launch adds one to ``layernorm_modulate.launches``, and one that
emits codes to ``layernorm_modulate.launches_codes`` too.
"""

from __future__ import annotations

from typing import Optional

import torch

from mrisr_tpu_torch import _build

_DTYPES = (torch.bfloat16, torch.float32)
# the widest row the kernel holds in registers, by x's type
MAX_C = {torch.bfloat16: 4096, torch.float32: 2048}


def row_stats(x: torch.Tensor, eps: float):
    """``(mean, rstd)`` of each row of ``x`` ``(..., C)`` as the kernel
    takes them: float64 sums of the values and of their squares (exact for
    bf16 rows unless their magnitudes span about 2^13, so the order of the
    sum does not matter), ``mean = s r``, ``var = max(s2 r - mean^2, 0)``
    with ``r = 1 / C``, ``rstd = 1 / sqrt(var + eps)`` in float64, each then
    rounded to float32.  Returns ``(..., 1)`` float32 tensors."""
    xd = x.double()
    r = 1.0 / x.shape[-1]
    mean = xd.sum(dim=-1, keepdim=True) * r
    var = torch.clamp_min((xd * xd).sum(dim=-1, keepdim=True) * r
                          - mean * mean, 0.0)
    return mean.float(), (1.0 / torch.sqrt(var + eps)).float()


def layernorm_modulate_plain(x: torch.Tensor, shift_scale: torch.Tensor, *,
                             eps: float = 1e-6,
                             quant_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of kernel L, in plain torch ops: :func:`row_stats`,
    then ``((x - mean) * rstd) * (1 + scale) + shift`` in float32, op by
    op, then the codes (true division, round half to even, clamp) or the
    cast to x's type.  x ``(B, ..., C)``, ``shift_scale`` ``(B, 2 C)``."""
    b, c = x.shape[0], x.shape[-1]
    mean, rstd = row_stats(x, eps)
    view = (b,) + (1,) * (x.dim() - 2) + (c,)
    shift = shift_scale[:, :c].float().reshape(view)
    opsc = (1 + shift_scale[:, c:].float()).reshape(view)
    y = ((x.float() - mean) * rstd) * opsc + shift
    if quant_scale is None:
        return y.to(x.dtype)
    return torch.clamp(torch.round(y / quant_scale), -127, 127).to(torch.int8)


def layernorm_modulate(x: torch.Tensor, shift_scale: torch.Tensor, *,
                       eps: float = 1e-6,
                       quant_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x ``(B, ..., C)`` contiguous bfloat16 or float32 (B images of
    tokens, C a multiple of 8 up to :data:`MAX_C`); ``shift_scale`` ``(B,
    2 C)`` float32 on x's device whose rows may lie apart (stride 1 along a
    row: a slice of all the blocks' adaLN rows); ``quant_scale`` one
    float32 value on x's device (shape ``()`` or ``(1,)``, a per-step row
    of the next int8 site's activation scale) for int8 codes, None for x's
    type.  Returns x's shape, the plain version's bits."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"layernorm_modulate: x must be bfloat16 or "
                         f"float32, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("layernorm_modulate: x must be a contiguous (B, ..., "
                         "C) tensor")
    b, c = x.shape[0], x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C[x.dtype]:
        raise ValueError(f"layernorm_modulate: C must be a multiple of 8 in "
                         f"[8, {MAX_C[x.dtype]}], got {c}")
    if (shift_scale.dtype != torch.float32
            or tuple(shift_scale.shape) != (b, 2 * c)
            or shift_scale.stride(1) != 1
            or shift_scale.device != x.device):
        raise ValueError(f"layernorm_modulate: shift_scale must be ({b}, "
                         f"{2 * c}) float32 on {x.device}, its rows "
                         "contiguous")
    if quant_scale is not None and (
            not isinstance(quant_scale, torch.Tensor)
            or quant_scale.dtype != torch.float32
            or quant_scale.numel() != 1 or quant_scale.dim() > 1
            or quant_scale.device != x.device):
        raise ValueError(f"layernorm_modulate: quant_scale must be one "
                         f"float32 value of shape () or (1,) on {x.device}")
    if x.device.type == "cpu":
        return layernorm_modulate_plain(x, shift_scale, eps=eps,
                                        quant_scale=quant_scale)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_modulate: unsupported device {x.device}")
    out = torch.empty(x.shape, device=x.device,
                      dtype=x.dtype if quant_scale is None else torch.int8)
    if x.data_ptr() % 16:
        raise ValueError("layernorm_modulate: x must be 16-byte aligned")
    lib = _build.library("layernorm_modulate")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.layernorm_modulate_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            shift_scale.data_ptr(), shift_scale.stride(0),
            None if quant_scale is None else quant_scale.data_ptr(),
            out.data_ptr(), b, x.numel() // (b * c), c, float(eps), stream)
    _build.check(err, "layernorm_modulate")
    layernorm_modulate.launches += 1
    layernorm_modulate.launches_codes += int(quant_scale is not None)
    return out


layernorm_modulate.launches = 0
layernorm_modulate.launches_codes = 0
