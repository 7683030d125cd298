"""Kernel K3: fused GroupNorm + SiLU (+ the int8 quantizer), NHWC.

Counterpart: the Pallas TPU kernel ``mrisr_tpu/ops/groupnorm_pallas.py``
(``groupnorm_silu_pallas``, launcher ``_gn_silu_call``).  The CUDA source
is ``csrc/groupnorm_silu.cu``; it says how the statistics are reduced
across blocks and what bounds the kernel on the card: one read of x and one
write of the output.

Semantics: ``flax.linen.GroupNorm(num_groups, epsilon)`` (float32
statistics, biased variance E[x^2] - E[x]^2) folded into one multiply-add
per element, then SiLU, then, with ``quant_scale``, the symmetric int8
quantizer ``clip(round(y * (1 / scale)), -127, 127)`` that the following
int8 conv reads.

Unlike the TPU kernel there is no eligibility rule: no block has to hold
a whole image, so every shape with group size 4 (every DiffResBlock site)
runs, 256^2 included, in the convs' own NHWC layout.

:func:`groupnorm_silu` launches the kernel for a CUDA tensor and runs
:func:`groupnorm_silu_plain` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch

from mrisr_tpu_torch import _build

GROUP_SIZE = 4   # the kernel's group size: channels // max(1, channels // 4)
_GB, _ROWS = 32, 8  # groups and pixel lanes of a block (csrc/groupnorm_silu.cu)
_OUT_MODE = {torch.float32: 0, torch.bfloat16: 1}

Scale = Union[float, torch.Tensor, None]


def _scale_tensor(quant_scale, device) -> torch.Tensor:
    return torch.as_tensor(quant_scale, dtype=torch.float32,
                           device=device).reshape(-1)


def groupnorm_silu_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, *, num_groups: int,
                         eps: float = 1e-5, quant_scale: Scale = None,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Plain version of K3: the kernel's float32 chain with the group sums
    taken in float64, in plain torch ops.  x ``(B, H, W, C)``; returns int8
    codes with ``quant_scale``, else ``out_dtype``."""
    b, h, w, c = x.shape
    gs = c // num_groups
    xg = x.to(torch.float32).reshape(b, h * w, num_groups, gs)
    xd = xg.double()
    n = h * w * gs
    mean = (xd.sum(dim=(1, 3)) / n).float()
    ex2 = ((xd * xd).sum(dim=(1, 3)) / n).float()
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    ga = gamma.to(torch.float32).reshape(num_groups, gs) * inv[..., None]
    be = beta.to(torch.float32).reshape(num_groups, gs) - mean[..., None] * ga
    y = xg * ga[:, None] + be[:, None]
    y = y * torch.sigmoid(y)
    if quant_scale is not None:
        inv_a = 1.0 / _scale_tensor(quant_scale, x.device)
        q = torch.clamp(torch.round(y * inv_a), -127, 127).to(torch.int8)
        return q.reshape(b, h, w, c)
    return y.to(out_dtype).reshape(b, h, w, c)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tiling(n: int, hw: int, c: int, sms: int):
    """``(tile_px, tiles)``: pixels per block and blocks per (sample, 32
    groups), aiming at 8 blocks of 256 threads per SM, with at least 64
    pixels (8 per thread) a tile."""
    gy = math.ceil(c // GROUP_SIZE / _GB)
    tiles = max(1, min(math.ceil(hw / 64), math.ceil(8 * sms / (n * gy))))
    tile_px = math.ceil(math.ceil(hw / tiles) / _ROWS) * _ROWS
    return tile_px, math.ceil(hw / tile_px)


def groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   *, num_groups: int, eps: float = 1e-5,
                   quant_scale: Scale = None,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused GroupNorm + SiLU (+ int8 quantize) on NHWC.

    x ``(B, H, W, C)`` float32 or bfloat16; gamma/beta ``(C,)``.  With
    ``quant_scale`` (a float, or a one-element float32 tensor on x's device:
    the following conv's per-step activation scale, read by the kernel from
    device memory) returns int8 codes; without it, ``out_dtype`` (float32
    or bfloat16).  On the card the group size must be 4."""
    if x.dim() != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"groupnorm_silu: x {tuple(x.shape)} does not split "
                         f"into {num_groups} groups")
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, gamma, beta, num_groups=num_groups,
                                    eps=eps, quant_scale=quant_scale,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    b, h, w, c = x.shape
    if c // num_groups != GROUP_SIZE:
        raise ValueError(f"groupnorm_silu: the kernel takes groups of "
                         f"{GROUP_SIZE} channels, got {c // num_groups}")
    if x.dtype not in _OUT_MODE or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("groupnorm_silu: x must be a contiguous, 16-byte "
                         "aligned float32 or bfloat16 tensor")
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if gamma.numel() != c or beta.numel() != c:
        raise ValueError("groupnorm_silu: gamma and beta need C values")
    if quant_scale is None:
        if out_dtype not in _OUT_MODE:
            raise ValueError(f"groupnorm_silu: out_dtype {out_dtype} is not "
                             "float32 or bfloat16")
        scale, mode, dtype = None, _OUT_MODE[out_dtype], out_dtype
    else:
        scale = _scale_tensor(quant_scale, x.device)
        if scale.numel() != 1 or scale.device != x.device:
            raise ValueError("groupnorm_silu: quant_scale must be one value "
                             f"on {x.device}")
        mode, dtype = 2, torch.int8
    out = torch.empty((b, h, w, c), device=x.device, dtype=dtype)
    if out.numel() == 0:
        return out
    index = x.device.index if x.device.index is not None else (
        torch.cuda.current_device())
    tile_px, tiles = _tiling(b, h * w, c, _sm_count(index))
    if b * tiles >= 2 ** 31:
        raise ValueError("groupnorm_silu: the batch exceeds one launch; "
                         "split it")
    partial = torch.empty((b, tiles, c // GROUP_SIZE, 2), device=x.device,
                          dtype=torch.float64)
    coef = torch.empty((b, c, 2), device=x.device, dtype=torch.float32)
    lib = _build.library("groupnorm_silu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.groupnorm_silu_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), gamma.data_ptr(),
            beta.data_ptr(), None if scale is None else scale.data_ptr(),
            partial.data_ptr(), coef.data_ptr(), out.data_ptr(), mode, b,
            h * w, c, tile_px, tiles, eps, stream,
        )
    _build.check(err, "groupnorm_silu")
    groupnorm_silu.launches += 1
    return out


groupnorm_silu.launches = 0
