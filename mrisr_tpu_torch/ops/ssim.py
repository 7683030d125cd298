"""SSIM / PSNR with scikit-image semantics (counterpart: ``mrisr_tpu/ops/ssim.py``).

SSIM is the reference's acceptance metric (``skimage.metrics.
structural_similarity`` with ``data_range=1.0`` and its defaults):

- a 7x7 *uniform* window (not Gaussian),
- sample covariance, ``NP / (NP - 1)`` with ``NP = 7 * 7 = 49``,
- K1 = 0.01, K2 = 0.03,
- the (win // 2)-pixel border cropped before the mean, so a VALID filter
  gives exactly the retained values.

This module is the plain, differentiable path (the SSIM loss uses it).  The
window sums are direct ``win``-tap sums, rows first, then columns, in the
order of the TPU kernel's ``_filt`` (``mrisr_tpu/ops/ssim_pallas.py:39-48``)
and of the K1 kernel.  They do not go through cuDNN, so TF32 never touches
them and the plain path is full float32 on the card as on the CPU, with no
context manager needed.  No running or summed-area window: ``E[x^2] - E[x]^2``
is a difference of nearly equal numbers, and a running sum over 256 rows of
x^2 would lose the digits it needs.

:func:`ssim` picks the fused kernel K1 (``ops/ssim_fused.py``) for a CUDA
tensor and this path for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """VALID mean filter over the trailing two dims by direct shifted sums:
    ``(..., H, W) -> (..., H - win + 1, W - win + 1)``."""
    vh, vw = x.shape[-2] - win + 1, x.shape[-1] - win + 1
    acc = x[..., 0:vh, :]
    for d in range(1, win):
        acc = acc + x[..., d:d + vh, :]
    acc2 = acc[..., 0:vw]
    for d in range(1, win):
        acc2 = acc2 + acc[..., d:d + vw]
    return acc2 * (1.0 / float(win * win))


def ssim_map(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Cropped SSIM map: ``(..., H, W) -> (..., H - win + 1, W - win + 1)``,
    float32 (float64 for float64 inputs)."""
    if x.shape != y.shape:
        raise ValueError(f"ssim: shapes differ, {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    dt = torch.promote_types(x.dtype, torch.float32)
    xf, yf = x.to(dt), y.to(dt)
    np_ = float(win_size * win_size)
    cov_norm = np_ / (np_ - 1.0)  # skimage use_sample_covariance=True

    ux = _uniform_filter_valid(xf, win_size)
    uy = _uniform_filter_valid(yf, win_size)
    uxx = _uniform_filter_valid(xf * xf, win_size)
    uyy = _uniform_filter_valid(yf * yf, win_size)
    uxy = _uniform_filter_valid(xf * yf, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 7,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Mean SSIM per image: ``(..., H, W) -> (...)``, skimage defaults.

    ``use_kernel=None`` runs K1 for a CUDA tensor and the plain path for a
    CPU tensor; ``True`` demands K1 (a CPU tensor raises); ``False`` runs
    the plain path anywhere."""
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        if x.device.type != "cuda":
            raise ValueError(f"ssim(use_kernel=True): the fused kernel runs "
                             f"on CUDA tensors, got {x.device}")
        from mrisr_tpu_torch.ops.ssim_fused import ssim_fused

        return ssim_fused(x, y, data_range=data_range, win_size=win_size)
    return ssim_map(x, y, data_range, win_size).mean(dim=(-2, -1))


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB over the trailing two dims (skimage's
    ``10 * log10(data_range**2 / MSE)``); ``inf`` for identical images."""
    mse = (x.float() - y.float()).square().mean(dim=(-2, -1))
    return 10.0 * torch.log10((data_range * data_range) / mse)


def ssim_loss(pred: torch.Tensor, target: torch.Tensor,
              data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """Differentiable ``1 - SSIM`` scalar loss (mean over the batch), on
    the plain path (K1 is forward only)."""
    return 1.0 - ssim(pred, target, data_range, win_size,
                      use_kernel=False).mean()
