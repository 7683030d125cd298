"""Kernel B: int8 ConvTranspose(k=2, s=2) + requant epilogue + fused concat,
or, in its float mode, the dequantized float32 output.

Counterpart: the Pallas TPU kernel ``mrisr_tpu/ops/upconv_pallas.py``
(``pack_upconv``, ``upconv2x2_int8``), which computes the same function as
``serve/quant.py:_upconv_int8(impl="convt")``.  The CUDA source is
``csrc/upconv_int8.cu``.  With kernel == stride the op is one
``(N*H*W, C) @ (C, 4*Co)`` product per batch; phase (a, b) of input pixel
(h, w) lands at output (2h + a, 2w + b).

:func:`upconv2x2_int8` launches the kernel for a CUDA tensor and runs
:func:`upconv2x2_int8_plain` for a CPU tensor; it never falls back.  Its
main loop is kernel A's, picked by :func:`upconv_path` from the shape
alone; each launch adds one to ``upconv2x2_int8.launches`` and to
``upconv2x2_int8.launches_tc`` or ``upconv2x2_int8.launches_dp4a``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.ops.conv_int8 import (
    TC_CI_MULTIPLE,
    TC_MIN_COLS,
    check_tc_aligned,
    count_launch,
    epilogue_plain,
    reset_launches,
)


def upconv_path(c: int, co: int) -> str:
    """The main loop kernel B runs for ``c`` input channels and ``4 * co``
    product columns: ``"tc"`` when ``c`` is a multiple of 16 (every UNet and
    Fast-DDPM site), else ``"dp4a"``."""
    if c % TC_CI_MULTIPLE == 0 and 4 * co >= TC_MIN_COLS:
        return "tc"
    return "dp4a"


def pack_upconv(w_int8: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(2, 2, C, Co)`` int8 kernel -> ``(w2, scale4, bias4)``.

    w2 is ``(C, 4*Co)`` with columns ordered (a, b, co), as the reference's
    ``pack_upconv``; it is the transposed view of a contiguous
    ``(4*Co, C)`` tensor, the kernel's K-contiguous layout.  The flax kernel
    is applied spatially flipped: ``y[2h+a, 2w+b]`` uses ``K[1-a, 1-b]``.
    scale4/bias4 tile the per-channel factors over the 4 phases.
    """
    a2, b2, c, co = w_int8.shape
    if (a2, b2) != (2, 2):
        raise ValueError("pack_upconv expects a 2x2 stride-2 kernel")
    w2t = w_int8.flip(0, 1).permute(0, 1, 3, 2).reshape(4 * co, c)
    return (w2t.contiguous().t(), scale.float().repeat(4),
            bias.float().repeat(4))


def upconv2x2_int8_plain(x: torch.Tensor, w2: torch.Tensor,
                         scale4: torch.Tensor, bias4: torch.Tensor,
                         skip: Optional[torch.Tensor] = None,
                         out_float: bool = False) -> torch.Tensor:
    """Plain version of kernel B: the product in float64 (exact for int8
    codes), the float32 epilogue, then the phase reshape and the concat."""
    n, h, w, c = x.shape
    co = w2.shape[1] // 4
    if out_float and skip is not None:
        raise ValueError("upconv2x2_int8: out_float takes no skip")
    acc = x.reshape(-1, c).double() @ w2.double()
    y = epilogue_plain(acc, scale4, bias4, relu=False, out_float=out_float)
    y = y.reshape(n, h, w, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, 2 * h, 2 * w, co)
    return y if skip is None else torch.cat([y, skip], dim=-1)


def upconv2x2_int8(x: torch.Tensor, w2: torch.Tensor, scale4: torch.Tensor,
                   bias4: torch.Tensor, skip: Optional[torch.Tensor] = None,
                   out_float: bool = False) -> torch.Tensor:
    """x ``(N, H, W, C)`` int8 codes; w2/scale4/bias4 from
    :func:`pack_upconv`, where scale4 already folds the next conv's
    activation scale.  skip: optional ``(N, 2H, 2W, Cs)`` int8, written
    into the output's trailing channels.  Returns ``(N, 2H, 2W, Co[+Cs])``
    int8, or with ``out_float`` (no skip) the float32 ``acc * scale4 +
    bias4`` of ``(N, 2H, 2W, Co)``."""
    if out_float and skip is not None:
        raise ValueError("upconv2x2_int8: out_float takes no skip")
    if x.device.type == "cpu":
        return upconv2x2_int8_plain(x, w2, scale4, bias4, skip, out_float)
    if x.device.type != "cuda":
        raise ValueError(f"upconv2x2_int8: unsupported device {x.device}")
    n, h, w, c = x.shape
    if w2.shape[0] != c or w2.shape[1] % 4:
        raise ValueError(f"upconv2x2_int8: weight {tuple(w2.shape)} does not "
                         f"fit input {tuple(x.shape)}")
    co = w2.shape[1] // 4
    w2t = w2.t()
    if not w2t.is_contiguous():
        raise ValueError("upconv2x2_int8: w2 must be the (C, 4*Co) view "
                         "that pack_upconv returns")
    checks = [("x", x, torch.int8), ("w2", w2t, torch.int8),
              ("scale4", scale4, torch.float32),
              ("bias4", bias4, torch.float32)]
    cs = 0
    if skip is not None:
        if skip.shape[:3] != (n, 2 * h, 2 * w):
            raise ValueError(f"upconv2x2_int8: skip {tuple(skip.shape)} does "
                             f"not fit output {(n, 2 * h, 2 * w)}")
        cs = skip.shape[3]
        checks.append(("skip", skip, torch.int8))
    for name, t, dt in checks:
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"upconv2x2_int8: {name} must be a contiguous "
                             f"{dt} tensor on {x.device}")
    if scale4.numel() != 4 * co or bias4.numel() != 4 * co:
        raise ValueError("upconv2x2_int8: scale4/bias4 need 4*Co values")
    path = upconv_path(c, co)
    if path == "tc":
        check_tc_aligned("upconv2x2_int8", x, w2t)
    out = torch.empty((n, 2 * h, 2 * w, co + cs), device=x.device,
                      dtype=torch.float32 if out_float else torch.int8)
    lib = _build.library("upconv_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.upconv_int8_launch(
            x.data_ptr(), w2t.data_ptr(), scale4.data_ptr(), bias4.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(),
            n, h, w, c, co, cs, int(out_float), int(path == "tc"), stream,
        )
    _build.check(err, "upconv2x2_int8")
    count_launch(upconv2x2_int8, path)
    return out


reset_launches(upconv2x2_int8)
