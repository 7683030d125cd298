"""Bilinear resize with the reference's semantics (counterpart:
``mrisr_tpu/ops/resize.py``).

The reference resizes every slice to 256x256 with torchvision's
``TF.resize(..., BILINEAR)`` (antialias off for tensors) and
``F.interpolate(mode='bilinear', align_corners=False)``; both use
half-pixel centers, which is what this calls.  ``antialias=True`` widens
the kernel by the down-scaling factor, as ``jax.image.resize`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, out_hw: Tuple[int, int],
                 antialias: bool) -> torch.Tensor:
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=antialias)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    antialias: bool = False) -> torch.Tensor:
    """Resize the trailing two dims of ``x`` to ``out_hw``; the identity
    (the same tensor) when they already match."""
    h, w = out_hw
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    lead = x.shape[:-2]
    y = _interpolate(x.reshape(-1, 1, *x.shape[-2:]), out_hw, antialias)
    return y.reshape(*lead, h, w)


def resize_bilinear_nhwc(x: torch.Tensor, out_hw: Tuple[int, int],
                         antialias: bool = False) -> torch.Tensor:
    """Resize ``(B, H, W, C)`` on the H, W dims; the identity (the same
    tensor) when they already match."""
    h, w = out_hw
    if x.shape[1] == h and x.shape[2] == w:
        return x
    y = _interpolate(x.permute(0, 3, 1, 2), out_hw, antialias)
    return y.permute(0, 2, 3, 1)
