"""The int8 activation quantizer: ``clip(round(x / a), -127, 127)`` as codes.

Counterpart: no Pallas kernel.  The JAX package's quantizer
(``mrisr_tpu/serve/quant.py:_quant_input``, ``qin_and_scale`` in
``mrisr_tpu/serve/quant_diffusion.py``) is one XLA expression that XLA fused
into the int8 conv reading its codes.  The CUDA source is
``csrc/quantize_int8.cu``: one streaming pass that reads x once and writes
the codes once; it says what bounds the kernel on the card.

:func:`quantize_int8` launches the kernel for a CUDA tensor and runs
:func:`quantize_int8_plain` for a CPU tensor; it never falls back.  Each
launch adds one to ``quantize_int8.launches``.
"""

from __future__ import annotations

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.device import sm_count

_DTYPES = (torch.bfloat16, torch.float32)


def quantize_int8_plain(x: torch.Tensor, a_scale: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version: the expression in torch ops (true division, round
    half to even, clamp, then the int8 conversion)."""
    return torch.clamp(torch.round(x.float() / a_scale), -127,
                       127).to(torch.int8)


def quantize_int8(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``x`` at the activation scale ``a_scale``: x contiguous
    bfloat16 or float32 of any shape, ``a_scale`` one float32 value (shape
    ``()`` or ``(1,)``, e.g. a per-step row taken by ``index_select``) on x's
    device, which the kernel reads from device memory.  Returns x's shape
    in int8, the plain version's codes bit for bit."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_int8: x must be bfloat16 or float32, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: x must be contiguous")
    if (not isinstance(a_scale, torch.Tensor)
            or a_scale.dtype != torch.float32 or a_scale.numel() != 1
            or a_scale.dim() > 1 or a_scale.device != x.device):
        raise ValueError(f"quantize_int8: a_scale must be one float32 value "
                         f"of shape () or (1,) on {x.device}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x, a_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {x.device}")
    out = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    if out.numel() == 0:
        return out
    lib = _build.library("quantize_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.quantize_int8_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), a_scale.data_ptr(),
            out.data_ptr(), x.numel(), sm_count(x.device), stream)
    _build.check(err, "quantize_int8")
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0
