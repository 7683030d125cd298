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

The gated form, :func:`gated_residual` (plain version
:func:`gated_residual_plain`), is DiT's gated residual ``x + gate[b] *
y``: y the float32 output of a block's ``proj`` or ``fc2`` (kernel A's
float epilogue), the gate a float32 adaLN row an image, written in place
into the residual stream x, as one pass of the same file's own kernel.
Each of its launches adds one to ``bias_residual.launches`` and to
``bias_residual.launches_gate``.
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


def gated_residual_plain(x: torch.Tensor, gate: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Plain version, in place into ``x``: ``x.float() + gate * y`` in
    float32 (the product rounded, then the sum), rounded to x's type.
    Returns x."""
    view = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return x.copy_(x.float() + gate.reshape(view) * y)


def gated_residual(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
    """``x + gate[b, c] * y`` written in place into ``x``; returns x, the
    plain version's bits.  ``x``: contiguous bfloat16 or float32 ``(B,
    ..., C)`` (B images of tokens), ``C`` a multiple of 8 up to
    :data:`MAX_C`; ``gate``: ``(B, C)`` float32 whose rows may lie apart
    (stride 1 along a row: a slice of the adaLN rows); ``y``: contiguous
    float32 of x's shape, not overlapping x; all on x's device."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"gated_residual: x must be bfloat16 or float32, "
                         f"got {x.dtype}")
    if x.dim() < 2:
        raise ValueError("gated_residual: x must be (B, ..., C)")
    b, c = x.shape[0], x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"gated_residual: C must be a multiple of 8 in "
                         f"[8, {MAX_C}], got {c}")
    if (gate.dtype != torch.float32 or tuple(gate.shape) != (b, c)
            or gate.stride(1) != 1 or gate.device != x.device):
        raise ValueError(f"gated_residual: gate must be ({b}, {c}) float32 "
                         f"on {x.device}, its rows contiguous")
    if (y.dtype != torch.float32 or y.shape != x.shape
            or y.device != x.device):
        raise ValueError(f"gated_residual: y must be float32 of x's shape "
                         f"{tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gated_residual: x and y must be contiguous")
    if x.device.type == "cpu":
        return gated_residual_plain(x, gate, y)
    if x.device.type != "cuda":
        raise ValueError(f"gated_residual: unsupported device {x.device}")
    if x.numel() == 0:
        return x
    if (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("gated_residual: x and y must be 16-byte aligned")
    lib = _build.library("bias_residual")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.gated_residual_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), gate.data_ptr(),
            gate.stride(0), y.data_ptr(), x.numel(), c, b, sm_count(x.device),
            stream)
    _build.check(err, "gated_residual")
    bias_residual.launches += 1
    bias_residual.launches_gate += 1
    return x


bias_residual.launches = 0
bias_residual.launches_residual = 0
bias_residual.launches_gate = 0
