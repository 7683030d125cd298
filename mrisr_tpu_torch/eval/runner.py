"""Test-set evaluation runner: the README metric contract (counterpart:
``mrisr_tpu/eval/runner.py``).

SSIM/PSNR per spacing: 3 mm (distance-2 triplets) and 6 mm (distance-4)
SEPARATELY, never aggregated (reference README.md:154-157).  Per-sample
normalization follows the notebook eval (min-max each image, ``Fixed:
cell21``) by default.  Batches, predictions and targets stay on the device
from the loader through the model to K1: nothing crosses to the host but
the per-image metric values.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from mrisr_tpu_torch.config import DataConfig
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.volumes import VolumeStore
from mrisr_tpu_torch.device import DeviceLike, resolve_device
from mrisr_tpu_torch.eval.metrics import per_sample_metrics


class _PhaseClock:
    """Wall time per phase ('loader', 'forward', 'metrics') into
    ``timings`` when one is given.  Each phase ends with a device
    synchronize, so the split is true at the cost of those syncs; with no
    ``timings`` it does nothing."""

    def __init__(self, timings: Optional[Dict[str, float]],
                 device: torch.device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[phase] = self.timings.get(phase, 0.0) + now - self.t
        self.t = now


def _limit(loader, max_batches: Optional[int], batch_size: int) -> int:
    n = loader.num_samples
    return n if max_batches is None else min(n, max_batches * batch_size)


@torch.no_grad()
def evaluate_pair_model_test_set(
    predict_fn: Callable,
    store: VolumeStore,
    data_cfg: DataConfig,
    split: str = "test",
    mode: str = "minmax-each",
    max_batches: Optional[int] = None,
    backend: str = "host",
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Dict[str, float]]:
    """predict_fn: ``(B, H, W, 2) -> (B, H, W, 1)`` tensors on ``device``
    (``None``: the card).  Returns ``{'3mm': ..., '6mm': ...}``.
    ``timings``: a dict that receives seconds per phase (see
    :class:`_PhaseClock`)."""
    device = resolve_device(device)
    clock = _PhaseClock(timings, device)
    out: Dict[str, Dict[str, float]] = {}
    bank = None  # built once; the bank does not depend on the distance
    for dist, label in ((2, "3mm"), (4, "6mm")):
        cfg = dataclasses.replace(data_cfg, distance_filter=dist,
                                  augment=False)
        loader = build_loader(store, split, cfg, backend=backend,
                              device=device, bank=bank)
        bank = loader.bank
        preds, gts = [], []
        batches = iter(loader)
        clock.lap("loader")
        for i in range(len(loader) if max_batches is None
                       else min(len(loader), max_batches)):
            batch = next(batches)
            clock.lap("loader")
            preds.append(predict_fn(batch[..., :2])[..., 0])
            gts.append(batch[..., 2])
            clock.lap("forward")
        if not preds:
            continue
        n = _limit(loader, max_batches, cfg.batch_size)
        out[label] = per_sample_metrics(torch.cat(gts)[:n],
                                        torch.cat(preds)[:n], mode=mode,
                                        device=device)
        clock.lap("metrics")
    return out


@torch.no_grad()
def evaluate_progressive_test_set(
    predict_fn: Callable,
    store: VolumeStore,
    data_cfg: DataConfig,
    split: str = "test",
    mode: str = "minmax-each",
    max_batches: Optional[int] = None,
    backend: str = "host",
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Per-stage test metrics for the Progressive UNet: SSIM/PSNR of the
    i+1 / i+2 / i+3 outputs plus their average (the shape of
    ``results/progressive_unet_history.json: test_metrics``).
    predict_fn: ``(B, H, W, 5) -> (p1, p2, p3)``, each ``(B, H, W, 1)``."""
    device = resolve_device(device)
    cfg = dataclasses.replace(data_cfg, augment=False)
    loader = build_loader(store, split, cfg, kind="window", backend=backend,
                          device=device)
    stages = (("i1", 1), ("i2", 2), ("i3", 3))
    preds = {k: [] for k, _ in stages}
    gts = {k: [] for k, _ in stages}
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        for (k, ch), p in zip(stages, predict_fn(batch)):
            preds[k].append(p[..., 0])
            gts[k].append(batch[..., ch])
    n = _limit(loader, max_batches, cfg.batch_size)
    out: Dict[str, Dict[str, float]] = {
        k: per_sample_metrics(torch.cat(gts[k])[:n], torch.cat(preds[k])[:n],
                              mode=mode, device=device)
        for k, _ in stages
    }
    out["average"] = {
        m: sum(out[k][f"{m}_mean"] for k, _ in stages) / 3.0
        for m in ("ssim", "psnr")
    }
    return out


def evaluate_and_save(
    predict_fn: Callable,
    store: VolumeStore,
    data_cfg: DataConfig,
    out_json: Optional[str] = None,
    **kwargs,
) -> Dict:
    """:func:`evaluate_pair_model_test_set`, written to ``out_json``."""
    metrics = evaluate_pair_model_test_set(predict_fn, store, data_cfg,
                                           **kwargs)
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics
