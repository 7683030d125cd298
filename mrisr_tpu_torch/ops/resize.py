"""Bilinear resize with the reference's semantics (counterpart:
``mrisr_tpu/ops/resize.py``).

The reference resizes every slice to 256x256 with torchvision's
``TF.resize(..., BILINEAR)`` (antialias off for tensors) and
``F.interpolate(mode='bilinear', align_corners=False)``; both use
half-pixel centers, which is what this calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the trailing two dims of ``x`` to ``out_hw``; the identity
    (the same tensor) when they already match."""
    h, w = out_hw
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(h, w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.reshape(*lead, h, w)
