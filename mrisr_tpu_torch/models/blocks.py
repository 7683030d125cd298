"""Shared conv blocks (counterpart: ``mrisr_tpu/models/blocks.py``).

The module layout mirrors the reference PyTorch UNetBlock: a ``conv``
Sequential whose indices 0/1/3/4 are conv/BN/conv/BN, so the reference's
``.pt`` state-dict keys (``enc1.conv.0.weight`` ...) load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.conv import Conv2d

# flax momentum 0.9 == torch momentum 0.1 (torch weighs the NEW batch)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var``
    uses the biased batch variance, as flax's ``BatchNorm`` does
    (``mrisr_tpu/models/blocks.py``); torch's own update uses the unbiased
    one, n / (n - 1) larger, which at a 2x2 bottleneck of batch 4 (n = 16)
    is a 6.7 % difference an update.  Normalization (biased variance), the
    momentum, eps, the eval forward and the state-dict keys are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2.

    ``use_bn=False`` builds the BN-folded inference variant (conv -> ReLU
    x 2, indices 0 and 2); folded convs always carry a bias.
    """

    def __init__(self, in_channels: int, features: int,
                 use_bias: bool = True, use_bn: bool = True):
        super().__init__()
        layers = []
        for i in range(2):
            layers.append(Conv2d(
                in_channels if i == 0 else features, features, 3, padding=1,
                bias=use_bias or not use_bn,
            ))
            if use_bn:
                layers.append(BatchNorm2d(
                    features, eps=BN_EPS, momentum=BN_MOMENTUM))
            layers.append(nn.ReLU(inplace=True))
        self.conv = nn.Sequential(*layers)

    def convs(self):
        """The two Conv2d layers, in order."""
        return [m for m in self.conv if isinstance(m, nn.Conv2d)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=2, stride=2) on NCHW."""
    return F.max_pool2d(x, 2, 2)


def UpConv2x2(in_channels: int, features: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(kernel_size=2, stride=2).  Its weight is
    ``(in, out, 2, 2)``; the flax kernel is the same spatially flipped
    (``ckpt/from_jax.py``)."""
    return nn.ConvTranspose2d(in_channels, features, 2, stride=2)
