"""Progressive 3-stage UNet: gap bisection for the 6 mm spacing
(counterpart: ``mrisr_tpu/models/progressive.py``).

Three bias-free UNets over a 5-slice window ``(B, H, W, 5)`` = [i .. i+4]:

- ``unet1(i, i+4)`` -> i+2
- ``unet2(i, pred i+2)`` -> i+1
- ``unet3(pred i+2, i+4)`` -> i+3

Stage 2 reads stage 1's output, so the stages run in order.  93,111,171
parameters at features 64; state-dict keys ``unet1.enc1.conv.0.weight``
... ``unet3.final.bias``, the names the JAX package's converter reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mrisr_tpu_torch.models.unet import UNet


class ProgressiveUNet(nn.Module):
    def __init__(self, base_features: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.unet1 = UNet(features=base_features, use_bias=False, dtype=dtype)
        self.unet2 = UNet(features=base_features, use_bias=False, dtype=dtype)
        self.unet3 = UNet(features=base_features, use_bias=False, dtype=dtype)

    def forward(self, window: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """window: (B, H, W, 5) -> (pred i+1, pred i+2, pred i+3), each
        (B, H, W, 1)."""
        s_i, s_i4 = window[..., 0:1], window[..., 4:5]
        p2 = self.unet1(torch.cat([s_i, s_i4], dim=-1))
        p1 = self.unet2(torch.cat([s_i, p2], dim=-1))
        p3 = self.unet3(torch.cat([p2, s_i4], dim=-1))
        return p1, p2, p3
