"""Volume-level prediction, V7-V9 (counterpart: ``mrisr_tpu/eval/volume_eval.py``).

Each stage is a few fixed-shape batched forwards on the card; slice gathers
and volume fills are numpy on the host (small beside the forwards).  The
semantics are the reference's:

- volumes are per-slice z-scored at load (``src/VolumeVisualization.py:26-50``),
- pair models predict every other middle slice from stride-2 triplets
  (V2, ``:53-86``),
- the progressive model fills i+1 / i+2 / i+3 from every 5-slice window,
  later windows overwriting earlier (V7 fill order, ``:933-946``),
- the hierarchical cascade runs one 2-in/1-out model three times, feeding
  its predicted i+2 back in (V9, ``:467-619``); stage 1, then 2, then 3
  fill the volume, so later stages overwrite (``{**s1, **s2, **s3}``),
- metrics via :func:`compute_metrics` (V6 original-range normalization).

``predict_fn`` takes a float32 NHWC tensor on ``device`` and returns one
there (the progressive one returns three).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from mrisr_tpu_torch.data.triplets import (
    eval_hierarchical_pairs,
    eval_progressive_windows,
    eval_volume_triplets,
)
from mrisr_tpu_torch.device import DeviceLike, resolve_device
from mrisr_tpu_torch.eval.metrics import compute_metrics
from mrisr_tpu_torch.ops.resize import resize_bilinear
from mrisr_tpu_torch.ops.stats import zscore_slices


def normalize_volume(volume: np.ndarray) -> np.ndarray:
    """Per-slice z-score, the eval path's load normalization (V1)."""
    return zscore_slices(torch.from_numpy(np.array(volume, np.float32))).numpy()


def _prepare(volume: np.ndarray, image_size: Tuple[int, int],
             normalized: bool) -> np.ndarray:
    vol = np.array(volume, np.float32)  # a writable copy
    if not normalized:
        vol = normalize_volume(vol)
    return resize_bilinear(torch.from_numpy(vol), image_size).numpy()


@torch.no_grad()
def _batched_outputs(fn: Callable, inputs: np.ndarray, batch_size: int,
                     device: torch.device):
    """Apply fn over ``(N, H, W, C)`` in fixed-size batches, wrap-padding
    the tail so every call has one shape.  Returns the list of raw outputs
    (on the device) and the real rows of each."""
    x = torch.from_numpy(np.ascontiguousarray(inputs)).to(device)
    outs, keeps = [], []
    for start in range(0, x.shape[0], batch_size):
        chunk = x[start:start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad > 0:
            chunk = torch.cat([chunk, chunk[:1].expand(pad, *chunk.shape[1:])])
        outs.append(fn(chunk))
        keeps.append(batch_size - pad)
    return outs, keeps


def _batched_apply(fn: Callable, inputs: np.ndarray, batch_size: int,
                   device: torch.device) -> np.ndarray:
    """:func:`_batched_outputs` trimmed and fetched to the host once."""
    outs, keeps = _batched_outputs(fn, inputs, batch_size, device)
    return torch.cat([o[:k] for o, k in zip(outs, keeps)]).cpu().numpy()


def predict_volume(
    predict_fn: Callable,
    volume: np.ndarray,
    batch_size: int = 32,
    image_size: Tuple[int, int] = (256, 256),
    normalized: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Pair-model volume prediction (V7).  predict_fn: ``(B, H, W, 2) ->
    (B, H, W, 1)``.  volume: ``(Z, H, W)`` raw (or already normalized)."""
    device = resolve_device(device)
    work = _prepare(volume, image_size, normalized)
    plan = eval_volume_triplets(work.shape[0])  # (N, 3) [pre, mid, post]
    pairs = np.stack([work[plan[:, 0]], work[plan[:, 2]]], axis=-1)
    preds = _batched_apply(predict_fn, pairs, batch_size, device)[..., 0]

    predicted = work.copy()
    predicted[plan[:, 1]] = preds
    # V6 whole-volume metrics include UNTOUCHED slices (per-slice PSNR
    # inf); also report metrics over the predicted slices only
    return {
        "volume_original": work,
        "volume_predicted": predicted,
        "predicted_indices": plan[:, 1].tolist(),
        "metrics": compute_metrics(work, predicted, device),
        "metrics_predicted_only": compute_metrics(
            work[plan[:, 1]], predicted[plan[:, 1]], device),
    }


def predict_volume_progressive(
    predict_fn: Callable,
    volume: np.ndarray,
    batch_size: int = 16,
    image_size: Tuple[int, int] = (256, 256),
    normalized: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Progressive-UNet volume prediction: every 5-slice window fills
    i+1 / i+2 / i+3.  predict_fn: ``(B, H, W, 5) -> (p1, p2, p3)``, each
    ``(B, H, W, 1)``."""
    device = resolve_device(device)
    work = _prepare(volume, image_size, normalized)
    plan = eval_progressive_windows(work.shape[0])  # (N, 5)
    windows = np.stack([work[plan[:, j]] for j in range(5)], axis=-1)
    outs, keeps = _batched_outputs(predict_fn, windows, batch_size, device)
    p1, p2, p3 = (torch.cat([o[j][:k, ..., 0] for o, k in zip(outs, keeps)])
                  .cpu().numpy() for j in range(3))

    predicted = work.copy()
    # ascending windows; later windows overwrite earlier (reference order)
    for w in range(plan.shape[0]):
        i = plan[w, 0]
        predicted[i + 1] = p1[w]
        predicted[i + 2] = p2[w]
        predicted[i + 3] = p3[w]
    changed = np.unique(np.concatenate([plan[:, 0] + j for j in (1, 2, 3)]))
    return {
        "volume_original": work,
        "volume_predicted": predicted,
        "predicted_indices": changed.tolist(),
        "metrics": compute_metrics(work, predicted, device),
        "metrics_predicted_only": compute_metrics(
            work[changed], predicted[changed], device),
    }


def predict_volume_hierarchical(
    predict_fn: Callable,
    volume: np.ndarray,
    batch_size: int = 32,
    image_size: Tuple[int, int] = (256, 256),
    normalized: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Hierarchical 3-stage cascade with ANY pair model (V9)."""
    device = resolve_device(device)
    work = _prepare(volume, image_size, normalized)
    plan = eval_hierarchical_pairs(work.shape[0])  # (N, 5) [i..i+4]
    s_i, s_i4 = work[plan[:, 0]], work[plan[:, 4]]

    def stage(a, b):
        return _batched_apply(predict_fn, np.stack([a, b], axis=-1),
                              batch_size, device)[..., 0]

    pred_i2 = stage(s_i, s_i4)      # stage 1: (i, i+4) -> i+2
    pred_i1 = stage(s_i, pred_i2)   # stage 2: (i, pred_i2) -> i+1
    pred_i3 = stage(pred_i2, s_i4)  # stage 3: (pred_i2, i+4) -> i+3

    predicted = work.copy()
    predicted[plan[:, 2]] = pred_i2  # stage 1 fills first ...
    predicted[plan[:, 1]] = pred_i1  # ... then stage 2 ...
    predicted[plan[:, 3]] = pred_i3  # ... then stage 3 overwrites
    changed = np.unique(np.concatenate([plan[:, 1], plan[:, 2], plan[:, 3]]))
    return {
        "volume_original": work,
        "volume_predicted": predicted,
        "predicted_indices": changed.tolist(),
        "metrics": compute_metrics(work, predicted, device),
        "metrics_predicted_only": compute_metrics(
            work[changed], predicted[changed], device),
        "stage_predictions": {"i1": pred_i1, "i2": pred_i2, "i3": pred_i3},
    }


def predict_volume_diffusion(
    sample_fn: Callable,
    volume: np.ndarray,
    batch_size: int = 8,
    image_size: Tuple[int, int] = (256, 256),
    normalized: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """FastDDPM volume prediction (V8): sample the middle of each stride-2
    triplet.  sample_fn: ``(B, H, W, 2)`` cond -> ``(B, H, W, 1)``."""
    return predict_volume(sample_fn, volume, batch_size=batch_size,
                          image_size=image_size, normalized=normalized,
                          device=device)
