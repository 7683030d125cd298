"""PatchGAN discriminator of the UNet-GAN (counterpart:
``mrisr_tpu/models/discriminator.py``).

The conditional 70x70 PatchGAN (pix2pix convention): input
``concat(pre, post, candidate)`` ``(B, H, W, 3)``; C64 stride 2 (biased, no
BN), C128 and C256 stride 2 and C512 stride 1 (bias-free, BN), then a
biased 1-channel conv; every conv 4x4 with pad 1, LeakyReLU(0.2) after each
but the last.  A ``(B, 30, 30, 1)`` patch map at 256^2; 2,765,633
parameters at base 64.  The layers sit in one ``model`` Sequential, as
pix2pix's ``NLayerDiscriminator`` keeps them: convs at 0, 2, 5, 8, 11,
BatchNorms at 3, 6, 9.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    set_compute_dtype,
)
from mrisr_tpu_torch.models.conv import Conv2d

SLOPE = 0.2


class LeakyReLU(nn.Module):
    """LeakyReLU(0.2) whose slope is first rounded to the input's type:
    ``jax.nn.leaky_relu`` multiplies a bf16 array by the weakly typed 0.2,
    which becomes bf16's 0.2001953125."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, float(torch.tensor(SLOPE, dtype=x.dtype)))


class PatchGAN(nn.Module):
    def __init__(self, in_channels: int = 3, base_features: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = base_features
        layers = [Conv2d(in_channels, f, 4, stride=2, padding=1),
                  LeakyReLU()]
        cin = f
        for width, stride in ((2 * f, 2), (4 * f, 2), (8 * f, 1)):
            layers += [Conv2d(cin, width, 4, stride=stride, padding=1,
                              bias=False),
                       BatchNorm2d(width, eps=BN_EPS, momentum=BN_MOMENTUM),
                       LeakyReLU()]
            cin = width
        layers.append(Conv2d(cin, 1, 4, stride=1, padding=1))
        self.model = nn.Sequential(*layers)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC -> the (B, h, w, 1) patch map, float32
        (float64 for a float64 module)."""
        if min(patch_map_size(n) for n in x.shape[1:3]) <= 0:
            # XLA gives an empty map, whose LSGAN means are a silent NaN;
            # torch's conv would refuse the last layer's input
            raise ValueError(
                f"PatchGAN patch map is empty for input {tuple(x.shape)}: "
                "the input image_size is too small for the 70x70 receptive "
                "field (needs >= 32 pixels per side)")
        h = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))


def patch_map_size(n: int) -> int:
    """The patch map's side for an input side ``n``: three 4x4 stride-2
    convs, then two stride-1 ones, all with pad 1."""
    for _ in range(3):
        n = (n + 2 - 4) // 2 + 1
    return n - 2
