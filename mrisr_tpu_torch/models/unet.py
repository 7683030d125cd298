"""UNet for slice interpolation (counterpart: ``mrisr_tpu/models/unet.py``).

``(B, H, W, 2) -> (B, H, W, 1)`` NHWC at the interface, like the reference.
Inside, the input is permuted to NCHW, which for an NHWC tensor is already
``channels_last`` memory, so cuDNN runs its NHWC kernels with no copy.
Topology: 4-level encoder f -> 2f -> 4f -> 8f with 2x2 max-pool, bottleneck
16f, decoder ConvTranspose(2, 2) + skip concat + double conv, final 1x1.
31,042,945 parameters at f=64 (31,037,057 without conv biases).
``dtype=torch.bfloat16`` is flax's compute dtype (``models/blocks.py``):
float32 parameters, bf16 activations, the output cast to float32.
``remat=True`` is flax's ``nn.remat`` on the nine DoubleConvs: a forward
that autograd records keeps only each block's input and output, and the
backward re-runs the block (``models/blocks.py:remat``).  The modules and
state-dict keys are the same either way; a no-grad forward (eval, serving,
calibration) runs the blocks as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    DoubleConv,
    UpConv2x2,
    max_pool_2x2,
    remat,
    set_compute_dtype,
)
from mrisr_tpu_torch.models.conv import Conv2d

BLOCKS_DOWN = ("enc1", "enc2", "enc3", "enc4")
BLOCKS_UP = ("dec4", "dec3", "dec2", "dec1")


class UNet(nn.Module):
    def __init__(self, features: int = 64, use_bias: bool = True,
                 use_bn: bool = True, in_channels: int = 2,
                 out_channels: int = 1, dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        self.features = features
        self.use_bias = use_bias
        self.use_bn = use_bn
        self.remat = remat
        f = features

        def dc(cin, cout):
            return DoubleConv(cin, cout, use_bias=use_bias, use_bn=use_bn)

        self.enc1 = dc(in_channels, f)
        self.enc2 = dc(f, 2 * f)
        self.enc3 = dc(2 * f, 4 * f)
        self.enc4 = dc(4 * f, 8 * f)
        self.bottleneck = dc(8 * f, 16 * f)
        self.upconv4 = UpConv2x2(16 * f, 8 * f)
        self.dec4 = dc(16 * f, 8 * f)
        self.upconv3 = UpConv2x2(8 * f, 4 * f)
        self.dec3 = dc(8 * f, 4 * f)
        self.upconv2 = UpConv2x2(4 * f, 2 * f)
        self.dec2 = dc(4 * f, 2 * f)
        self.upconv1 = UpConv2x2(2 * f, f)
        self.dec1 = dc(2 * f, f)
        self.final = Conv2d(f, out_channels, 1)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C_in) NHWC -> (B, H, W, C_out) float32 (float64
        for a float64 module; float32 from a bf16 compute dtype)."""
        rematerialize = self.remat and torch.is_grad_enabled()

        def block(name, h):
            m = getattr(self, name)
            return remat(m, h) if rematerialize else m(h)

        h = x.permute(0, 3, 1, 2)
        skips = []
        for name in BLOCKS_DOWN:
            h = block(name, h)
            skips.append(h)
            h = max_pool_2x2(h)
        h = block("bottleneck", h)
        for name, skip in zip(BLOCKS_UP, reversed(skips)):
            h = getattr(self, f"upconv{name[-1]}")(h)
            h = torch.cat([h, skip], dim=1)
            h = block(name, h)
        h = self.final(h).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))
