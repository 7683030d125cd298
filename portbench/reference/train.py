"""Plain reference of the M2 UNet's training step under the
``unet_combined`` recipe: the UNet in training mode (BatchNorm over the
batch, biased variance, eps 1e-5), the loss MSE + 0.1 (1 - SSIM) + 0.1 x a
fixed Gabor/LoG feature distance, and Adam (lr 1e-4, betas 0.9 / 0.999,
eps 1e-8).

- SSIM: scikit-image's defaults at data range 1: a 7 x 7 uniform window,
  VALID, sample covariance (49 / 48), K1 0.01, K2 0.03, the map's mean.
- The feature distance: 17 zero-mean 9 x 9 filters of unit L1 norm (Gabor
  at 4 orientations x 2 phases x wavelengths 4 and 8 with sigma half the
  wavelength and aspect 0.5, and a LoG of sigma 1.4), SAME, the 4-pixel
  border cropped; the mean absolute difference of the responses, averaged
  over a 3-level pyramid (5 x 5 Gaussian of sigma 1, edge padding,
  stride 2).

``low=True`` is float8 training (the control): every conv's input and
weights rounded to float8 e4m3 in the forward, and the gradients that flow
back through those roundings to float8 e5m2.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.unet import DOWN, UP

BN_EPS = 1e-5
LAMBDA_SSIM = 0.1
LAMBDA_PERCEPTUAL = 0.1


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: e4m3 on the way forward, e5m2 on the
    gradient coming back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float8_e5m2).to(g.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def forward_train(w: Dict[str, torch.Tensor], x: torch.Tensor,
                  low: bool = False) -> torch.Tensor:
    """``(B, H, W, 2) -> (B, H, W, 1)``, BatchNorm on the batch's
    statistics; ``low``: the control's float8 convs."""
    cast = fp8 if low else (lambda t: t)

    def conv(h, name, pad, transposed=False):
        f = F.conv_transpose2d if transposed else F.conv2d
        kw = {"stride": 2} if transposed else {"padding": pad}
        return f(cast(h), cast(w[f"{name}.weight"]), w[f"{name}.bias"], **kw)

    def bn(h, name):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = (h - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        return ((h - mean) * torch.rsqrt(var + BN_EPS)
                * w[f"{name}.weight"][:, None, None]
                + w[f"{name}.bias"][:, None, None])

    def block(name, h):
        h = F.relu(bn(conv(h, f"{name}.conv.0", 1), f"{name}.conv.1"))
        return F.relu(bn(conv(h, f"{name}.conv.3", 1), f"{name}.conv.4"))

    h = x.permute(0, 3, 1, 2)
    skips = []
    for name in DOWN:
        h = block(name, h)
        skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    h = block("bottleneck", h)
    for name, skip in zip(UP, reversed(skips)):
        h = conv(h, f"upconv{name[-1]}", 0, transposed=True)
        h = block(name, torch.cat([h, skip], dim=1))
    return conv(h, "final", 0).permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of ``(B, H, W)`` images at data range 1."""
    win = 7
    box = torch.full((1, 1, win, win), 1.0 / win ** 2, dtype=x.dtype,
                     device=x.device)

    def mean(a):
        return F.conv2d(a[:, None], box)[:, 0]

    ux, uy = mean(x), mean(y)
    cov = win * win / (win * win - 1.0)
    vx = cov * (mean(x * x) - ux * ux)
    vy = cov * (mean(y * y) - uy * uy)
    vxy = cov * (mean(x * y) - ux * uy)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
    return s.mean(dim=(-2, -1))


def _centered(k: np.ndarray) -> np.ndarray:
    k = k - k.mean()
    return k / (np.abs(k).sum() + 1e-12)


def filter_bank(size: int = 9) -> np.ndarray:
    """``(17, 1, size, size)``: the Gabor and LoG filters."""
    half = size // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    out = []
    for wavelength, sigma in ((4.0, 2.0), (8.0, 4.0)):
        for i in range(4):
            th = math.pi * i / 4.0
            xr = x * math.cos(th) + y * math.sin(th)
            yr = -x * math.sin(th) + y * math.cos(th)
            env = np.exp(-(xr ** 2 + 0.25 * yr ** 2) / (2.0 * sigma ** 2))
            for phase in (0.0, math.pi / 2.0):
                out.append(_centered(env * np.cos(
                    2.0 * math.pi * xr / wavelength + phase)))
    r2 = x ** 2 + y ** 2
    s = 1.4
    out.append(_centered((r2 - 2 * s ** 2) / s ** 4
                         * np.exp(-r2 / (2 * s ** 2))))
    return np.stack(out)[:, None].astype(np.float32)


def feature_distance(pred: torch.Tensor, target: torch.Tensor,
                     levels: int = 3) -> torch.Tensor:
    bank = torch.from_numpy(filter_bank()).to(pred.device, pred.dtype)
    g = np.exp(-(np.mgrid[-2:3, -2:3] ** 2).sum(0) / 2.0)
    blur = torch.from_numpy((g / g.sum())[None, None]).to(pred.device,
                                                          pred.dtype)
    a, b = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    total = 0.0
    for _ in range(levels):
        fa, fb = F.conv2d(a, bank, padding=4), F.conv2d(b, bank, padding=4)
        c = min(4, (fa.shape[2] - 2) // 2, (fa.shape[3] - 2) // 2)
        if c > 0:
            fa, fb = fa[:, :, c:-c, c:-c], fb[:, :, c:-c, c:-c]
        total = total + (fa - fb).abs().mean()
        a = F.conv2d(F.pad(a, (2, 2, 2, 2), mode="replicate"), blur, stride=2)
        b = F.conv2d(F.pad(b, (2, 2, 2, 2), mode="replicate"), blur, stride=2)
    return total / levels


def loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target).square().mean()
            + LAMBDA_SSIM * (1.0 - ssim(pred[..., 0], target[..., 0]).mean())
            + LAMBDA_PERCEPTUAL * feature_distance(pred, target))


def steps(w0: Dict[str, torch.Tensor], batches: List[torch.Tensor],
          low: bool = False, lr: float = 1e-4
          ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Adam over ``batches`` (``(B, H, W, 3)`` = [pre, post, target])
    from the parameters ``w0``: each step's loss, each parameter's first
    gradient norm, and each parameter's change after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              w0.items() if not k.endswith(("running_mean", "running_var"))}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, first = [], {}
    for i, b in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        l_ = loss(forward_train(params, b[..., :2], low), b[..., 2:3])
        l_.backward()
        if i == 0:
            first = {k: float(p.grad.double().norm()) for k, p in
                     params.items()}
        opt.step()
        losses.append(float(l_.detach()))
    change = {k: float((p.detach() - w0[k]).double().norm())
              for k, p in params.items()}
    return losses, first, change
