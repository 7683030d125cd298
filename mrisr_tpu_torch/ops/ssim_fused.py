"""Kernel K1: fused mean SSIM per image.

Counterpart: the Pallas TPU kernel ``mrisr_tpu/ops/ssim_pallas.py``
(``ssim_pallas``, launcher ``_ssim_pallas_batched``).  The CUDA source is
``csrc/ssim.cu``: one pass of column strips, a warp sliding down a band of
rows with the vertical window in registers, so each input byte is read
once (bar the strip and band halos); it says what bounds it on the card.
:func:`plan` is its tiling, in Python so that the CPU tests can check it.

:func:`ssim_fused` launches the kernel for a CUDA tensor and runs
:func:`ssim_fused_plain` for a CPU tensor; it never falls back.  Its
per-image reduction is deterministic (no float atomics).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.device import sm_count
from mrisr_tpu_torch.ops.ssim import ssim_map

MAX_WIN = 11
STRIP = 128  # output columns a warp: 32 lanes x 4 (csrc/ssim.cu)
BAND_MIN = 16  # output rows a warp walks, at least (the band halo re-read)
WARPS = 4  # warps (strip x band tiles) a block (csrc/ssim.cu)


class Plan(NamedTuple):
    """K1's tiling of an ``(h, w)`` image: ``strips`` strips of
    :data:`STRIP` output columns by ``bands`` bands of ``band`` output rows,
    one warp each; the last strip and band may be short, none is empty."""

    strips: int
    bands: int
    band: int
    smem: int = 0  # shared memory a block, bytes: K1 uses none

    @property
    def tiles(self) -> int:
        return self.strips * self.bands


def plan(n: int, h: int, w: int, win: int, sms: int,
         blocks_per_sm: int) -> Plan:
    """The bands that finish soonest: a warp's time is about its rows
    (band + win - 1, each read and summed once), and the card runs
    ``sms * blocks_per_sm`` blocks of :data:`WARPS` warps at a time, so the
    cost is waves x rows.  Fewer bands (less halo) on a tie; bands of at
    least :data:`BAND_MIN` rows unless the map is shorter."""
    vh, vw = h - win + 1, w - win + 1
    strips = math.ceil(vw / STRIP)
    slots = max(1, sms * blocks_per_sm)
    best = None
    for bands in range(1, max(1, vh // BAND_MIN) + 1):
        band = math.ceil(vh / bands)
        bands = math.ceil(vh / band)
        waves = math.ceil(math.ceil(n * strips * bands / WARPS) / slots)
        cost = (waves * (band + win - 1), bands)
        if best is None or cost < best[0]:
            best = (cost, Plan(strips, bands, band))
    return best[1]


@functools.cache
def _blocks_per_sm(win: int) -> int:
    blocks = _build.library("ssim").ssim_blocks_per_sm(win)
    if blocks < 1:
        raise RuntimeError(f"ssim_fused: no block of the win {win} kernel "
                           "fits an SM")
    return blocks


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
    p = plan(n, h, w, win_size, sm_count(x.device), _blocks_per_sm(win_size))
    if n * p.tiles >= 2 ** 31:
        raise ValueError(f"ssim_fused: {n} images of {h}x{w} exceed one "
                         f"launch; split the batch")
    partial = torch.empty((n, p.tiles), device=x.device, dtype=torch.float32)
    lib = _build.library("ssim")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssim_launch(
            xf.data_ptr(), yf.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, win_size, p.strips, p.bands, p.band,
            (k1 * data_range) ** 2, (k2 * data_range) ** 2, stream,
        )
    _build.check(err, "ssim_fused")
    ssim_fused.launches += 1
    return out.reshape(lead)


ssim_fused.launches = 0
