"""DeepCNN: a ResNet-style stride-1 baseline, ``(B, H, W, 2) -> (B, H, W, 1)``
(counterpart: ``mrisr_tpu/models/deepcnn.py``).

7x7 stride-1 conv -> BN/ReLU -> 3x3 stride-1 max-pool (pad 1) -> one stage
of residual blocks for each entry of ``num_blocks`` (widths f, 2f, 4f, ...,
all stride 1) -> 1x1 conv to one channel.  The spatial size never shrinks.
11,173,889 parameters at f = 64 with ``num_blocks=(2, 2, 2, 2)``.  Module
names are the reference's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.downsample.0``, ``output_conv``), the names the JAX package's
converter reads (``mrisr_tpu/ckpt/torch_convert.py:_convert_deepcnn``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    max_pool_3x3_s1,
    set_compute_dtype,
)
from mrisr_tpu_torch.models.conv import Conv2d


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class ResidualBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 -> BN, plus the identity (a 1x1
    conv + BN where the width changes), then ReLU.  Convs are bias-free."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = (nn.Sequential(
            Conv2d(in_channels, features, 1, bias=False), _bn(features))
            if in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class DeepCNN(nn.Module):
    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 base_features: int = 64,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = base_features
        self.conv1 = Conv2d(in_channels, f, 7, padding=3, bias=False)
        self.bn1 = _bn(f)
        # one doubling stage per num_blocks entry, as the JAX module builds
        # it: a longer config builds longer
        cin = f
        for i, blocks in enumerate(num_blocks):
            width = f * 2 ** i
            layer = []
            for _ in range(blocks):
                layer.append(ResidualBlock(cin, width))
                cin = width
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        self.num_layers = len(num_blocks)
        self.output_conv = Conv2d(cin, out_channels, 1)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C_in) NHWC -> (B, H, W, C_out), float32 (float64
        for a float64 module)."""
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        h = max_pool_3x3_s1(h)
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i + 1}")(h)
        h = self.output_conv(h).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))
