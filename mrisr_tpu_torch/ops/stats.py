"""Per-slice normalization (counterpart: ``mrisr_tpu/ops/stats.py``).

The reference z-scores every slice independently:
``(x - x.mean()) / (x.std() + 1e-6)`` with the population (ddof=0) std
(reference ``src/ModelDataGenerator.py:73-75``).  Statistics are taken in
float32 over the trailing two (H, W) dims, whatever the leading shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

ZSCORE_EPS = 1e-6


def zscore_slices(x: torch.Tensor, eps: float = ZSCORE_EPS) -> torch.Tensor:
    """Z-score each (H, W) slice: population std, eps added outside the sqrt."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = (xf - mean).square().mean(dim=(-2, -1), keepdim=True)
    return (xf - mean) / (var.sqrt() + eps)


def slice_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slice (mean, population std) over the trailing two dims."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1))
    var = (xf - mean[..., None, None]).square().mean(dim=(-2, -1))
    return mean, var.sqrt()


def minmax_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Min-max each image over its trailing two dims to [0, 1] (the
    reference's per-image normalization before SSIM/PSNR in the FastDDPM
    eval, ``notebooks/FastDDPM_Training_Fixed.ipynb:cell21``)."""
    xf = x.float()
    lo = xf.amin(dim=(-2, -1), keepdim=True)
    hi = xf.amax(dim=(-2, -1), keepdim=True)
    return (xf - lo) / (hi - lo + eps)
