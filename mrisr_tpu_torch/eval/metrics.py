"""Metrics with the reference's normalization conventions (counterpart:
``mrisr_tpu/eval/metrics.py``).

Three conventions exist in the reference and give different numbers; all
are kept:

- :func:`compute_metrics` (V6, reference ``src/VolumeVisualization.py:
  237-269``): volume level; BOTH volumes normalized by the ORIGINAL
  volume's min/max range, the prediction clipped to [0, 1], per-slice SSIM
  and PSNR with data_range=1, plus MAE.
- :func:`per_sample_metrics` ``mode='minmax-each'`` (V11,
  ``notebooks/FastDDPM_Training_Fixed.ipynb:cell21``): each image min-max
  normalized on its own.  ``mode='denorm-11'``: [-1, 1] -> [0, 1].
  ``mode='raw'``: as given.
- :func:`spacing_metrics`: 3 mm and 6 mm reported separately, never merged
  (reference README.md:154-157).

SSIM and PSNR run on ``device`` (``None``: the card), where SSIM goes
through the fused kernel K1; on the CPU they take the plain path.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from mrisr_tpu_torch.device import DeviceLike, resolve_device
from mrisr_tpu_torch.ops.ssim import psnr as psnr_op, ssim as ssim_op
from mrisr_tpu_torch.ops.stats import minmax_normalize

ArrayLike = Union[np.ndarray, torch.Tensor]


def _on(a: ArrayLike, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _ssim_psnr(g: torch.Tensor, p: torch.Tensor):
    """Per-image SSIM and PSNR (data_range 1) as float32 numpy, one fetch."""
    both = torch.stack([ssim_op(g, p, data_range=1.0),
                        psnr_op(g, p, data_range=1.0)]).cpu().numpy()
    return both[0], both[1]


def compute_metrics(original: np.ndarray, predicted: np.ndarray,
                    device: DeviceLike = None) -> Dict:
    """Volume metrics, V6 semantics.  original/predicted: ``(Z, H, W)``.

    Returns the scalar stats PLUS the normalized volumes under
    'orig_norm' / 'pred_norm' (numpy ``(Z, H, W)``, as the reference returns
    them for its figures), so this dict is not JSON-safe.  The
    whole-volume 'psnr_mean' includes untouched slices, whose PSNR is inf,
    exactly as V6 does; ``predict_volume``'s 'metrics_predicted_only' gives
    a finite number."""
    device = resolve_device(device)
    orig = np.asarray(original, np.float32)
    pred = np.asarray(predicted, np.float32)
    orig_min = orig.min()
    orig_range = orig.max() - orig_min + 1e-8
    orig_norm = (orig - orig_min) / orig_range
    pred_norm = np.clip((pred - orig_min) / orig_range, 0.0, 1.0)
    s, p = _ssim_psnr(_on(orig_norm, device), _on(pred_norm, device))
    return {
        "ssim_mean": float(s.mean()),
        "ssim_std": float(s.std()),
        "psnr_mean": float(p.mean()),
        "psnr_std": float(p.std()),
        "mae": float(np.mean(np.abs(orig_norm - pred_norm))),
        "orig_norm": orig_norm,
        "pred_norm": pred_norm,
    }


def per_sample_metrics(gt: ArrayLike, pred: ArrayLike,
                       mode: str = "minmax-each",
                       device: DeviceLike = None) -> Dict[str, float]:
    """Per-image metrics over a stack ``(N, H, W)``: mean/std/min/max of
    SSIM and PSNR.  Tensors already on ``device`` stay there: the
    normalization runs on it in float32, right before K1."""
    device = resolve_device(device)
    g, p = _on(gt, device), _on(pred, device)
    if mode == "minmax-each":
        g, p = minmax_normalize(g), minmax_normalize(p)
    elif mode == "denorm-11":
        g, p = (g + 1.0) / 2.0, (p + 1.0) / 2.0
    elif mode != "raw":
        raise ValueError(mode)
    s, q = _ssim_psnr(g, p)
    return {
        "ssim_mean": float(s.mean()), "ssim_std": float(s.std()),
        "ssim_min": float(s.min()), "ssim_max": float(s.max()),
        "psnr_mean": float(q.mean()), "psnr_std": float(q.std()),
        "psnr_min": float(q.min()), "psnr_max": float(q.max()),
        "num_samples": int(len(s)),
    }


def spacing_metrics(gt: ArrayLike, pred: ArrayLike, distances: np.ndarray,
                    mode: str = "minmax-each",
                    device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    """Metrics reported SEPARATELY per spacing, never aggregated.
    distances: ``(N,)`` of 2 (3 mm) / 4 (6 mm) per sample."""
    device = resolve_device(device)
    g, p = _on(gt, device), _on(pred, device)
    dist = np.asarray(distances)
    out: Dict[str, Dict[str, float]] = {}
    for d, label in ((2, "3mm"), (4, "6mm")):
        mask = dist == d
        if mask.any():
            idx = torch.from_numpy(np.flatnonzero(mask)).to(device)
            out[label] = per_sample_metrics(g.index_select(0, idx),
                                            p.index_select(0, idx),
                                            mode=mode, device=device)
    return out
