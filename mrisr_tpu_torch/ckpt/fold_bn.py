"""Inference-time BatchNorm folding (counterpart: ``mrisr_tpu/ckpt/fold_bn.py``).

With running statistics fixed, BN is a per-channel affine map and folds
into the conv before it:

    w' = w * s,  b' = (b - mean) * s + bias,  s = scale / sqrt(var + eps)

computed in float64 and cast to float32, as the reference does.
"""

from __future__ import annotations

import torch
from torch import nn

from mrisr_tpu_torch.models.blocks import BN_EPS
from mrisr_tpu_torch.models.unet import BLOCKS_DOWN, BLOCKS_UP, UNet


def _fold_conv(conv: nn.Conv2d, bn: nn.BatchNorm2d, out: nn.Conv2d) -> None:
    w = conv.weight.detach().double()                       # (O, I, kh, kw)
    b = (conv.bias.detach().double() if conv.bias is not None
         else torch.zeros(w.shape[0], dtype=torch.float64, device=w.device))
    s = bn.weight.detach().double() / torch.sqrt(
        bn.running_var.detach().double() + BN_EPS)
    out.weight.copy_((w * s[:, None, None, None]).float())
    out.bias.copy_(((b - bn.running_mean.detach().double()) * s
                    + bn.bias.detach().double()).float())


@torch.no_grad()
def fold_unet_batchnorm(model: UNet) -> UNet:
    """UNet(use_bn=True) -> an equivalent UNet(use_bn=False) in eval form,
    on the same device.  Works for biased (M2) and bias-free UNets."""
    if not model.use_bn:
        raise ValueError("fold_unet_batchnorm expects a UNet with BatchNorm")
    device = next(model.parameters()).device
    folded = UNet(features=model.features, use_bn=False,
                  in_channels=model.enc1.convs()[0].in_channels,
                  out_channels=model.final.out_channels).to(device)
    for name in (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP):
        src, dst = getattr(model, name).conv, getattr(folded, name).conv
        _fold_conv(src[0], src[1], dst[0])
        _fold_conv(src[3], src[4], dst[2])
    for name in ("upconv4", "upconv3", "upconv2", "upconv1", "final"):
        getattr(folded, name).load_state_dict(getattr(model, name).state_dict())
    return folded.eval()
