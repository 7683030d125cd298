"""Perceptual feature distance without pretrained weights (counterpart:
``mrisr_tpu/losses/perceptual.py``).

The default perceptual term is a fixed feature space, built in numpy
exactly as the JAX package builds it, so both packages use the same bank:

- a Gabor bank (4 orientations x 2 phases at 2 frequencies) and one
  Laplacian-of-Gaussian channel, 17 zero-mean 9x9 filters of unit L1 norm;
- applied over a 3-level Gaussian pyramid (5x5 blur, stride 2, edge
  padding), the mean L1 distance of the cropped responses averaged over the
  levels.

``make_perceptual_fn`` keeps the JAX package's selection: ``'auto'`` takes
VGG16 when an npz of weights exists (``MRISR_VGG16_NPZ`` or an explicit
path) and the Gabor distance otherwise; ``'vgg-random'`` is explicit only.

Layouts: images are NHWC ``(B, H, W, 1)`` at the interface and NCHW inside;
the bank is HWIO ``(K, K, 1, F)`` in numpy and OIHW ``(F, 1, K, K)`` here.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

PerceptualFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _gabor_kernel(size: int, sigma: float, theta: float, wavelength: float,
                  phase: float) -> np.ndarray:
    """Single odd/even Gabor filter, zero-mean, unit L1 norm."""
    half = size // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    xr = x * math.cos(theta) + y * math.sin(theta)
    yr = -x * math.sin(theta) + y * math.cos(theta)
    envelope = np.exp(-(xr ** 2 + 0.25 * yr ** 2) / (2.0 * sigma ** 2))
    carrier = np.cos(2.0 * math.pi * xr / wavelength + phase)
    k = envelope * carrier
    k -= k.mean()  # zero DC response: distance ignores absolute intensity
    return k / (np.abs(k).sum() + 1e-12)


def _log_kernel(size: int, sigma: float) -> np.ndarray:
    """Laplacian-of-Gaussian, zero-mean, unit L1 norm."""
    half = size // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    r2 = x ** 2 + y ** 2
    k = (r2 - 2.0 * sigma ** 2) / sigma ** 4 * np.exp(-r2 / (2.0 * sigma ** 2))
    k -= k.mean()
    return k / (np.abs(k).sum() + 1e-12)


def _gaussian_blur_kernel(sigma: float = 1.0, size: int = 5) -> np.ndarray:
    half = size // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    k = np.exp(-(x ** 2 + y ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _filter_bank(size: int = 9) -> np.ndarray:
    """(size, size, 1, F) fixed bank: 4 orientations x 2 phases x 2
    frequencies of Gabor + 1 LoG = 17 channels."""
    kernels = []
    for wavelength, sigma in ((4.0, 2.0), (8.0, 4.0)):
        for i in range(4):
            theta = math.pi * i / 4.0
            for phase in (0.0, math.pi / 2.0):
                kernels.append(_gabor_kernel(size, sigma, theta, wavelength,
                                             phase))
    kernels.append(_log_kernel(size, 1.4))
    bank = np.stack(kernels, axis=-1)[:, :, None, :]  # (K, K, 1, F)
    return bank.astype(np.float32)


def make_gabor_perceptual_fn(levels: int = 3, kernel_size: int = 9,
                             dtype: torch.dtype = torch.float32
                             ) -> PerceptualFn:
    """Fixed multi-scale Gabor/LoG feature distance: ``perceptual(pred,
    target)`` -> scalar mean-L1 feature distance of ``(B, H, W, 1)``
    images.  The filters move to each input's device at its first call."""
    bank_np = _filter_bank(kernel_size).transpose(3, 2, 0, 1)  # OIHW
    blur_np = _gaussian_blur_kernel()[None, None].astype(np.float32)
    half = kernel_size // 2
    on: Dict[torch.device, tuple] = {}

    def filters(device: torch.device):
        if device not in on:
            on[device] = (torch.from_numpy(np.ascontiguousarray(bank_np)).to(
                device, dtype), torch.from_numpy(blur_np).to(device, dtype))
        return on[device]

    def features(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
        f = F.conv2d(x, bank, padding=half)  # SAME
        # drop the half-width border: SAME padding feeds zeros to the edge
        # taps, which would leak absolute intensity; tiny pyramid levels
        # keep >= 2x2 pixels
        ch = min(half, (f.shape[2] - 2) // 2, (f.shape[3] - 2) // 2)
        if ch > 0:
            f = f[:, :, ch:-ch, ch:-ch]
        return f

    def downsample(x: torch.Tensor, blur: torch.Tensor) -> torch.Tensor:
        # edge replication keeps the blur shift-equivariant
        return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="replicate"), blur,
                        stride=2)

    def perceptual(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        bank, blur = filters(pred.device)
        # pred and target through one filter-bank and blur pass a level
        both = torch.cat([pred, target], dim=0).permute(0, 3, 1, 2).to(dtype)
        n = pred.shape[0]
        total = torch.zeros((), dtype=torch.promote_types(dtype, torch.float32),
                            device=pred.device)
        for _ in range(levels):
            f = features(both, bank)
            total = total + (f[:n] - f[n:]).abs().mean().to(total.dtype)
            both = downsample(both, blur)
        return total / levels

    return perceptual


def make_perceptual_fn(kind: str = "auto", npz_path: Optional[str] = None,
                       dtype: torch.dtype = torch.float32) -> PerceptualFn:
    """The perceptual-fn factory of the trainers and the CLI.

    kind:
      'auto'       -- VGG16 weights if an npz is available (explicit path or
                      ``MRISR_VGG16_NPZ``), else the Gabor distance.
      'gabor'      -- the fixed Gabor/LoG multi-scale distance.
      'vgg'        -- VGG16; needs weights (raises without them).
      'vgg-random' -- seeded random VGG features (explicit only)."""
    from mrisr_tpu_torch.losses import vgg as vgg_mod

    resolved = npz_path or os.environ.get("MRISR_VGG16_NPZ")
    have_weights = bool(resolved and os.path.exists(resolved))
    if kind == "auto":
        kind = "vgg" if have_weights else "gabor"
    if kind == "gabor":
        return make_gabor_perceptual_fn(dtype=dtype)
    if kind == "vgg":
        if not have_weights:
            raise FileNotFoundError(
                "kind='vgg' needs pretrained weights: set MRISR_VGG16_NPZ "
                "or pass npz_path (HWIO arrays conv{i}_kernel/conv{i}_bias; "
                "converter: losses/vgg.py:convert_torch_vgg16). "
                "Use kind='gabor' (default under 'auto') for the "
                "weight-free distance.")
        return vgg_mod.make_perceptual_fn(npz_path=resolved, dtype=dtype)
    if kind == "vgg-random":
        # allow_env=False: stays random even when MRISR_VGG16_NPZ is set,
        # or a vgg vs vgg-random ablation compares identical arms
        return vgg_mod.make_perceptual_fn(npz_path=None, dtype=dtype,
                                          allow_env=False)
    raise ValueError(f"unknown perceptual kind: {kind!r}")
