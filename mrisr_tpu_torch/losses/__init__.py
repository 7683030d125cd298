"""Loss library (counterpart: ``mrisr_tpu/losses/__init__.py``).

- mse / l1 -- the workhorse losses.
- ssim_loss -- 1 - SSIM with the skimage-default window, on the plain
  differentiable path (``ops/ssim.py``; the fused kernel K1 is forward only).
- perceptual -- the Gabor/LoG distance or VGG16 features (perceptual.py,
  vgg.py).
- lsgan_* -- Least-Squares GAN objectives.
- combined_loss -- MSE + lambda_s (1 - SSIM) + lambda_p perceptual.
- progressive_loss -- weighted multi-output MSE, w = (0.5, 1.0, 0.5).

Tensors are NHWC, ``(B, H, W, C)``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mrisr_tpu_torch.losses.perceptual import (  # noqa: F401  (re-export)
    make_gabor_perceptual_fn,
    make_perceptual_fn,
)
from mrisr_tpu_torch.ops.ssim import ssim_loss  # noqa: F401  (re-export)

Losses = Tuple[torch.Tensor, Dict[str, torch.Tensor]]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


# LSGAN: D minimizes (D(real)-1)^2 + D(fake)^2; G minimizes (D(fake)-1)^2.


def lsgan_d_loss(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * ((d_real - 1.0).square().mean() + d_fake.square().mean())


def lsgan_g_loss(d_fake: torch.Tensor) -> torch.Tensor:
    return (d_fake - 1.0).square().mean()


def combined_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    perceptual_fn: Optional[Callable] = None,
    lambda_perceptual: float = 0.1,
    lambda_ssim: float = 0.1,
    ssim_data_range: float = 1.0,
) -> Losses:
    """MSE + lambda_s (1 - SSIM) + lambda_p perceptual on ``(B, H, W, 1)``.

    Returns ``(total, components)`` with the keys ``mse``, ``ssim`` and, with
    a ``perceptual_fn``, ``perceptual``: the trainer names its history
    series from them."""
    m = mse(pred, target)
    s = ssim_loss(pred[..., 0], target[..., 0], data_range=ssim_data_range)
    comps = {"mse": m, "ssim": s}
    total = m + lambda_ssim * s
    if perceptual_fn is not None:
        p = perceptual_fn(pred, target)
        comps["perceptual"] = p
        total = total + lambda_perceptual * p
    return total, comps


def progressive_loss(
    preds: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    window: torch.Tensor,
    w_i1: float = 0.5,
    w_i2: float = 1.0,
    w_i3: float = 0.5,
) -> Losses:
    """Weighted MSE of the three stage outputs against slices i+1, i+2 and
    i+3 of the ``(B, H, W, 5)`` window."""
    p1, p2, p3 = preds
    l1_ = mse(p1, window[..., 1:2])
    l2_ = mse(p2, window[..., 2:3])
    l3_ = mse(p3, window[..., 3:4])
    total = w_i1 * l1_ + w_i2 * l2_ + w_i3 * l3_
    return total, {"i1": l1_, "i2": l2_, "i3": l3_, "total": total}
