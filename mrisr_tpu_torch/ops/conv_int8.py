"""Kernel A: int8 SAME conv + fused serving epilogue, NHWC.

Counterpart: what XLA generated on the TPU for ``serve/quant.py``:
``_conv3x3(..., preferred=int32)`` + ``_requant_epilogue`` (int8 out) or the
final layer's ``acc * scale + qbias`` (float32 out).  The CUDA source is
``csrc/conv_int8.cu``.

    y = f32(conv(x, w)) * s + b ;  relu ;  int8: clip(round(y), +-127)

or, with ``gelu_scale`` (DiT's fc1, whose codes fc2 reads), the codes of
GELU's tanh form at the next site's activation scale:
``clip(round(gelu(y) / gelu_scale), +-127)``.

:func:`conv2d_int8` launches the kernel for a CUDA tensor and runs
:func:`conv2d_int8_plain` for a CPU tensor; it never falls back.  The
kernel has two main loops, picked by :func:`conv_path` from the shape
alone: ``"tc"`` (wgmma on the tensor cores, fed by TMA) and ``"dp4a"``.
On the tensor cores a 1x1 site takes the GEMM form (:func:`conv_form`): a
persistent GEMM over the (N H W, Ci) codes in 128 x 128 tiles.  Each
launch adds one to ``conv2d_int8.launches`` and to the count of its path,
``conv2d_int8.launches_tc`` or ``conv2d_int8.launches_dp4a``; a launch of
the GEMM form to ``conv2d_int8.launches_gemm`` too (inside
``launches_tc``), and a GELU launch to ``conv2d_int8.launches_gelu``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mrisr_tpu_torch import _build


PATHS = ("tc", "dp4a")
# wgmma's narrowest output tile is 8 columns; TMA rows need 16-byte strides
TC_MIN_COLS = 8
TC_CI_MULTIPLE = 16


def conv_path(ci: int, co: int, k: int) -> str:
    """The main loop kernel A runs for a ``k``x``k`` conv of ``ci`` -> ``co``
    channels: ``"tc"`` (tensor cores) when ``ci`` is a multiple of 16 and
    ``co >= 8``, else ``"dp4a"`` (at full width: enc1/Conv_0's ``ci = 2``
    and the final 1x1 conv's ``co = 1``)."""
    if k not in (1, 3):
        raise ValueError(f"conv_path: kernel size {k} is not 1 or 3")
    if ci % TC_CI_MULTIPLE == 0 and co >= TC_MIN_COLS:
        return "tc"
    return "dp4a"


# the GEMM form indexes output rows in 32 bits (its tiles are 128 rows)
GEMM_MAX_ROWS = 2 ** 31 - 128
_FORM_CODE = {"dp4a": 0, "tc": 1, "gemm": 2}


def conv_form(m: int, ci: int, co: int, k: int) -> str:
    """The form kernel A takes for a ``k``x``k`` conv of ``ci`` -> ``co``
    channels over ``m`` = N H W pixels: ``"gemm"`` (the tensor cores'
    persistent GEMM) for a 1x1 site on the tensor-core path with fewer than
    :data:`GEMM_MAX_ROWS` pixels, else :func:`conv_path`'s path.  On the
    card the GEMM form timed faster than the conv form at every 1x1 site of
    the benchmark's networks at batch 32, down to 64 output tiles (half
    the SMs), and at 2 tiles in the card tests' shapes (PERF.md)."""
    path = conv_path(ci, co, k)
    if path == "tc" and k == 1 and m < GEMM_MAX_ROWS:
        return "gemm"
    return path


def count_launch(fn, path: str) -> None:
    """One launch of ``fn``'s kernel through ``path``."""
    fn.launches += 1
    setattr(fn, f"launches_{path}", getattr(fn, f"launches_{path}") + 1)


def reset_launches(*fns) -> None:
    """Set the launch counts of the given wrappers, every path's (and every
    other ``launches_*`` count they keep), to 0."""
    for fn in fns:
        fn.launches = 0
        for name in [n for n in vars(fn) if n.startswith("launches_")]:
            setattr(fn, name, 0)
        for path in PATHS:
            setattr(fn, f"launches_{path}", 0)


def check_tc_aligned(what: str, *tensors: torch.Tensor) -> None:
    """TMA reads from 16-byte-aligned base addresses."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: the tensor-core path needs 16-byte "
                             f"aligned tensors")


def pack_conv(w_int8: torch.Tensor) -> torch.Tensor:
    """HWIO ``(kh, kw, Ci, Co)`` int8 table -> ``(Co, kh, kw, Ci)``
    K-contiguous, the kernel's weight layout."""
    return w_int8.permute(3, 0, 1, 2).contiguous()


def epilogue_plain(acc: torch.Tensor, s: torch.Tensor, b: torch.Tensor, *,
                   relu: bool, out_float: bool) -> torch.Tensor:
    """The shared float32 epilogue of the plain versions.  ``acc`` holds
    exact integer sums (float64); its float32 cast rounds like the kernel's
    int32 -> float32 conversion."""
    y = acc.float() * s + b
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_float:
        return y
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def gelu_codes_plain(y: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The GELU form's codes of the float32 epilogue ``y``: torch's GELU
    (tanh form), then the quantizer (true division by ``a``, round half to
    even, clamp)."""
    g = F.gelu(y, approximate="tanh")
    return torch.clamp(torch.round(g / a), -127, 127).to(torch.int8)


def conv2d_int8_plain(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                      b: torch.Tensor, *, relu: bool = True,
                      out_float: bool = False,
                      gelu_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain version of kernel A.  The conv runs on float64 copies of the
    codes: exact, since |acc| <= 127 * 127 * 9 * 1024 ~ 1.5e8 is past
    float32's 2^24 but far inside float64's 2^53."""
    k = wp.shape[1]
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   wp.permute(0, 3, 1, 2).double(), padding=k // 2)
    acc = acc.permute(0, 2, 3, 1)
    if gelu_scale is not None:
        y = epilogue_plain(acc, s, b, relu=False, out_float=True)
        return gelu_codes_plain(y, gelu_scale).contiguous()
    return epilogue_plain(acc, s, b, relu=relu,
                          out_float=out_float).contiguous()


def conv2d_int8(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                b: torch.Tensor, *, relu: bool = True,
                out_float: bool = False,
                gelu_scale: Optional[torch.Tensor] = None,
                _form: Optional[str] = None) -> torch.Tensor:
    """x ``(N, H, W, Ci)`` int8 codes, wp ``(Co, k, k, Ci)`` int8 from
    :func:`pack_conv` (k = 1 or 3), s/b ``(Co,)`` float32.  Returns
    ``(N, H, W, Co)`` int8 codes, or float32 with ``out_float``.
    ``gelu_scale``: one float32 value on x's device (the next int8 site's
    per-step activation scale): the codes of GELU(y) at that scale, in the
    GEMM form (a 1x1 site on the tensor-core path), with ``relu`` and
    ``out_float`` False; the kernel's fast exponential puts a few codes in
    1e5 a boundary apart from the plain version's.  The form is
    :func:`conv_form`'s.  ``_form`` is for tests only: ``"tc"`` runs a
    site of the GEMM form in the conv form, for the card tests and
    ``chip_smoke.py``'s per-site table, which hold the two forms to each
    other."""
    if gelu_scale is not None:
        if relu or out_float:
            raise ValueError("conv2d_int8: the GELU form emits codes, with "
                             "no ReLU")
        if (not isinstance(gelu_scale, torch.Tensor)
                or gelu_scale.dtype != torch.float32
                or gelu_scale.numel() != 1 or gelu_scale.device != x.device):
            raise ValueError(f"conv2d_int8: gelu_scale must be one float32 "
                             f"value on {x.device}")
    if x.device.type == "cpu":
        return conv2d_int8_plain(x, wp, s, b, relu=relu, out_float=out_float,
                                 gelu_scale=gelu_scale)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8: unsupported device {x.device}")
    n, h, w, ci = x.shape
    co, k, k2, wci = wp.shape
    if k != k2 or k not in (1, 3) or wci != ci:
        raise ValueError(f"conv2d_int8: weight {tuple(wp.shape)} does not "
                         f"fit input {tuple(x.shape)}")
    for name, t, dt in (("x", x, torch.int8), ("w", wp, torch.int8),
                        ("s", s, torch.float32), ("b", b, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv2d_int8: {name} must be a contiguous "
                             f"{dt} tensor on {x.device}")
    if s.numel() != co or b.numel() != co:
        raise ValueError("conv2d_int8: s and b need one value per channel")
    form = conv_form(n * h * w, ci, co, k)
    if _form is not None:
        if _form != "tc" or form != "gemm":
            raise ValueError(f"conv2d_int8: _form='tc' moves a GEMM-form site "
                             f"to the conv form; not _form={_form!r} at a "
                             f"{k}x{k} conv of {ci} -> {co} channels")
        form = _form
    path = "dp4a" if form == "dp4a" else "tc"
    if gelu_scale is not None and form != "gemm":
        raise ValueError(f"conv2d_int8: the GELU form runs in the tensor-core "
                         f"path's GEMM form only (a 1x1 conv, Ci {ci} a "
                         f"multiple of 16, Co {co} >= 8)")
    if path == "tc":
        check_tc_aligned("conv2d_int8", x, wp)
    out = torch.empty((n, h, w, co), device=x.device,
                      dtype=torch.float32 if out_float else torch.int8)
    lib = _build.library("conv_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.conv_int8_launch(
            x.data_ptr(), wp.data_ptr(), s.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, h, w, ci, co, k, int(relu), int(out_float),
            _FORM_CODE[form],
            None if gelu_scale is None else gelu_scale.data_ptr(), stream,
        )
    _build.check(err, "conv2d_int8")
    count_launch(conv2d_int8, path)
    conv2d_int8.launches_gemm += form == "gemm"
    conv2d_int8.launches_gelu += gelu_scale is not None
    return out


conv2d_int8.launches_gelu = conv2d_int8.launches_gemm = 0
reset_launches(conv2d_int8)
