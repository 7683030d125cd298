"""A float conv's bias, and a residual block's closing add, in one pass:
``y = (y + b) + (r + rb)`` in place, every sum rounded to y's type.

Counterpart: no Pallas kernel.  On the TPU, XLA fused a conv's bias into
the conv and the residual add into its reader.  On the card cuDNN runs a
conv without its bias, and torch adds the bias after it in a broadcast add
that its vectorized elementwise kernel does not take; a residual block's
``h + x`` is then a second pass over the same map.  The CUDA source is
``csrc/bias_residual.cu``: one streaming pass that reads y (and r) once and
writes y once; it says what bounds the kernel on the card.

:func:`bias_residual` launches the kernel for a CUDA tensor and runs
:func:`bias_residual_plain` for a CPU tensor; it never falls back.  Each
launch adds one to ``bias_residual.launches``, and one that takes an ``r``
to ``bias_residual.launches_residual`` too.
"""

from __future__ import annotations

from typing import Optional

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.device import sm_count

_DTYPES = (torch.bfloat16, torch.float32)
# the longest bias row the kernel stages in shared memory
MAX_C = 4096


def bias_residual_plain(y: torch.Tensor, b: torch.Tensor,
                        r: Optional[torch.Tensor] = None,
                        rb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, in place into ``y``: torch's own sequence after a
    cuDNN conv, ``y.add_(b)`` (the conv's bias), ``r + rb`` (the shortcut
    conv's bias, into a new tensor: r is not written), then the residual
    add, each rounded to y's type.  Returns y."""
    y.add_(b)
    if r is not None:
        y.add_(r if rb is None else r + rb)
    return y


def bias_residual(y: torch.Tensor, b: torch.Tensor,
                  r: Optional[torch.Tensor] = None,
                  rb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y + b`` (a float conv's bias), then ``+ r`` or ``+ (r + rb)`` (a
    residual block's input, or its shortcut conv's bias-less output and
    that conv's bias), written in place into ``y``; returns y, the plain
    version's bits.  ``y``: contiguous bfloat16 or float32 ``(..., C)``
    (an NHWC map), ``C`` a multiple of 8 up to :data:`MAX_C`; ``b`` and
    ``rb``: contiguous ``(C,)`` of y's type; ``r``: contiguous, y's shape
    and type, read only (it may not overlap y); all on y's device."""
    if y.dtype not in _DTYPES:
        raise ValueError(f"bias_residual: y must be bfloat16 or float32, got "
                         f"{y.dtype}")
    if y.dim() < 1:
        raise ValueError("bias_residual: y must have a channel dimension")
    c = y.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"bias_residual: C must be a multiple of 8 in "
                         f"[8, {MAX_C}], got {c}")
    if rb is not None and r is None:
        raise ValueError("bias_residual: rb (r's bias) needs r")
    for name, t, shape in (("b", b, (c,)), ("r", r, tuple(y.shape)),
                           ("rb", rb, (c,))):
        if t is None:
            continue
        if t.dtype != y.dtype:
            raise ValueError(f"bias_residual: {name} must be {y.dtype}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"bias_residual: {name} must have shape "
                             f"{shape}, got {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"bias_residual: {name} must be on {y.device}, "
                             f"got {t.device}")
    if not all(t.is_contiguous() for t in (y, b, r, rb) if t is not None):
        raise ValueError("bias_residual: y, b, r and rb must be contiguous")
    if y.device.type == "cpu":
        return bias_residual_plain(y, b, r, rb)
    if y.device.type != "cuda":
        raise ValueError(f"bias_residual: unsupported device {y.device}")
    if y.numel() == 0:
        return y
    lib = _build.library("bias_residual")
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.bias_residual_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16), b.data_ptr(),
            None if r is None else r.data_ptr(),
            None if rb is None else rb.data_ptr(), y.numel(), c,
            sm_count(y.device), stream)
    _build.check(err, "bias_residual")
    bias_residual.launches += 1
    bias_residual.launches_residual += int(r is not None)
    return y


bias_residual.launches = 0
bias_residual.launches_residual = 0
