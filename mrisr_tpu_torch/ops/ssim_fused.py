"""Kernel K1: fused mean SSIM per image.

Counterpart: the Pallas TPU kernel ``mrisr_tpu/ops/ssim_pallas.py``
(``ssim_pallas``, launcher ``_ssim_pallas_batched``).  The CUDA source is
``csrc/ssim.cu``; it says how the work is tiled and reduced, and what bounds
it on the card: the 8 bytes per pixel of x and y, at 3.35 TB/s.

:func:`ssim_fused` launches the kernel for a CUDA tensor and runs
:func:`ssim_fused_plain` for a CPU tensor; it never falls back.  Its
per-image reduction is deterministic (no float atomics).
"""

from __future__ import annotations

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.ops.ssim import ssim_map

MAX_WIN = 11


def ssim_fused_plain(x: torch.Tensor, y: torch.Tensor,
                     data_range: float = 1.0, win_size: int = 7,
                     k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Plain version of K1: the plain SSIM map (``ops/ssim.py``), averaged
    per image.  ``(..., H, W) -> (...)`` float32."""
    return ssim_map(x, y, data_range, win_size, k1, k2).mean(dim=(-2, -1))


def ssim_fused(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
               win_size: int = 7, k1: float = 0.01,
               k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM per image: ``(..., H, W) -> (...)`` float32, skimage's
    defaults.  Inputs are read as float32, like ``ssim_pallas``."""
    if x.shape != y.shape or x.dim() < 2:
        raise ValueError(f"ssim_fused: need two (..., H, W) tensors of one "
                         f"shape, got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return ssim_fused_plain(x, y, data_range, win_size, k1, k2)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"ssim_fused: x and y must both lie on one CUDA "
                         f"device, got {x.device} and {y.device}")
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    if win_size % 2 != 1 or not 3 <= win_size <= MAX_WIN:
        raise ValueError(f"ssim_fused: win_size must be odd in [3, "
                         f"{MAX_WIN}], got {win_size}")
    if h < win_size or w < win_size:
        raise ValueError(f"ssim_fused: images {h}x{w} are smaller than the "
                         f"{win_size}x{win_size} window")
    xf = x.reshape(-1, h, w).to(torch.float32).contiguous()
    yf = y.reshape(-1, h, w).to(torch.float32).contiguous()
    n = xf.shape[0]
    out = torch.empty(n, device=x.device, dtype=torch.float32)
    if n == 0:
        return out.reshape(lead)
    lib = _build.library("ssim")
    tiles = lib.ssim_tiles(h, w, win_size)
    if n * tiles >= 2 ** 31:
        raise ValueError(f"ssim_fused: {n} images of {h}x{w} exceed one "
                         f"launch; split the batch")
    partial = torch.empty((n, tiles), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssim_launch(
            xf.data_ptr(), yf.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, win_size, (k1 * data_range) ** 2, (k2 * data_range) ** 2,
            stream,
        )
    _build.check(err, "ssim_fused")
    ssim_fused.launches += 1
    return out.reshape(lead)


ssim_fused.launches = 0
