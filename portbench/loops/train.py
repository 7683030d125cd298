"""Training: a job, not a request stream.  Set-up packs a phantom store
(``patients`` x ``slices`` x 256^2, from the seed) as the port's
``VolumeStore``, builds the train loader (``build_loader(..., "train")``)
and the trainer as ``cli.make_trainer`` builds them for ``preset`` in
``compute_dtype``, loads the seeded weights, and drives that trainer
through its first ``first_steps`` steps with ``run_epoch`` on the loader's
first batches: the steps the reference follows.  The window then runs
whole epochs (``run_epoch`` over the loader) until its end.

End-to-end: ``train_slices_per_s``, the triplets of the epochs that ended
inside the window over their time.

Compared, against ``reference/train.py`` on the same first batches and
weights (float32, TF32 off): each first step's loss, each parameter's
first gradient as Adam holds it after one step (``exp_avg / (1 -
beta1)``), and each parameter's change after the steps; a gap is
``|norm_program - norm_reference|`` over the larger of the reference's
norm and the median parameter's, over the parameters whose reference
gradient is at least a thousandth of the median's.  The loader's rows are
checked by themselves: each is a triplet of the store's z-scored slices,
flipped alike.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import core
from portbench.reference import train as ref
from portbench.reference.phantom import phantom_volume, volume_seed, zscore

BETA1 = 0.9
EXCLUDE_BELOW = 1e-3  # of the median parameter's reference gradient


class TimedLoader:
    """The loader, with the benchmark's span around each ``next``."""

    def __init__(self, loader, spans: core.Spans):
        self.loader, self.spans = loader, spans

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.spans.add("loader.next", t, time.perf_counter())
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def _store(path: str, seed: int, patients: int, slices: int, size: int):
    from mrisr_tpu_torch.data.volumes import VolumeStore

    vols = [phantom_volume(slices, size, size, seed=volume_seed(seed, k))
            for k in range(patients)]
    VolumeStore.pack(path, ((f"Phantom-{k:04d}", f"Phantom-{k:04d}/t2", v)
                            for k, v in enumerate(vols)),
                     meta={"phantom_seed": seed % 2 ** 63})
    return VolumeStore.open(path), vols


def _config(cfg: Dict[str, Any], traffic: Dict[str, Any]):
    from mrisr_tpu_torch.config import PRESETS

    p = PRESETS[traffic["preset"]]
    size = int(cfg["image_size"])
    return dataclasses.replace(
        p,
        model=dataclasses.replace(
            p.model, base_features=int(cfg["widths"]["base_features"])),
        data=dataclasses.replace(p.data, batch_size=int(traffic["batch_size"]),
                                 image_size=(size, size)),
        train=dataclasses.replace(p.train,
                                  compute_dtype=traffic["compute_dtype"]))


def _gaps(prog: Dict[str, float], want: Dict[str, float],
          keep: List[str]) -> Dict[str, float]:
    med = statistics.median(want[k] for k in keep)
    return {k: abs(prog[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keep}


def _readings(losses, g1, change, r_losses, r_g1, r_change, keep):
    """The gaps of one run from the reference: the first step's loss and
    the worst step's (relative), and the first gradient's and the change's
    norms by parameter, their worst and their median parameter."""
    g, d = _gaps(g1, r_g1, keep), _gaps(change, r_change, keep)
    return {
        "loss_first": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
        "grad_worst": max(g.values()),
        "grad_median": statistics.median(g.values()),
        "change_worst": max(d.values()),
        "change_median": statistics.median(d.values()),
        "excluded": float(len(r_g1) - len(keep)),
    }


def loader_mismatch(batches: List[torch.Tensor], vols: List[np.ndarray],
                    device) -> float:
    """Each row's distance from the nearest triplet ``(i - d, i + d) -> i``
    (d = 1, 2) of the z-scored volumes under the same flips, over the
    row's norm; the worst row."""
    z = torch.from_numpy(np.stack([zscore(v) for v in vols])).to(device)
    n_v, n_s = z.shape[:2]
    flat = z.reshape(n_v * n_s, -1)
    worst = 0.0
    for b in batches:
        for row in b.permute(0, 3, 1, 2).float():
            best = float("inf")
            for flips in ((), (-1,), (-2,), (-2, -1)):
                r = row.flip(flips) if flips else row
                mid = int(torch.cdist(r[2].reshape(1, -1), flat).argmin())
                v, i = divmod(mid, n_s)
                for d in (1, 2):
                    if i - d < 0 or i + d >= n_s:
                        continue
                    want = torch.stack([z[v, i - d], z[v, i + d], z[v, i]])
                    best = min(best, float((r - want).norm() / want.norm()))
            worst = max(worst, best)
    return worst


def run_cell(bench, name, cfg, traffic, fam, seed: int, seconds: float,
             trace: bool, device: torch.device, t_process: float, *,
             fault=None, control_bits=None,
             log=lambda s: print(s, file=sys.stderr, flush=True)):
    from mrisr_tpu_torch.cli import make_trainer
    from mrisr_tpu_torch.data.pipeline import build_loader

    check = cfg["train_check"]
    spans = core.Spans()
    w = fam.weights(cfg, seed, device)
    tcfg = _config(cfg, traffic)
    n_first = int(traffic.get("first_steps", 3))
    prof_box: List = []
    epochs = []
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        store, vols = _store(os.path.join(workdir, "store"), seed,
                             int(traffic["patients"]),
                             int(cfg["volume"]["slices"]),
                             int(cfg["image_size"]))
        loader = TimedLoader(build_loader(store, "train", tcfg.data,
                                          kind="triplet", device=device),
                             spans)
        trainer = make_trainer(tcfg, len(loader), device)
        module = trainer.state.module
        with torch.no_grad():
            for k, v in module.state_dict().items():
                if k in w:
                    v.copy_(w[k])
        train = trainer._train
        if fault is not None:
            train = fault(train, trainer)

        def timed_train(batch, g):
            t = time.perf_counter()
            try:
                return train(batch, g)
            finally:
                spans.add("step", t, time.perf_counter())

        trainer._train = timed_train
        # the first steps, through the window's own call and feed
        it = iter(loader)
        first = [next(it).clone() for _ in range(n_first)]
        it.close()
        names = [k for k, _ in module.named_parameters()]
        params = dict(module.named_parameters())
        losses, g1 = [], {}
        for i, b in enumerate(first):
            losses.append(trainer.run_epoch([b], True, 0)["loss"])
            if i == 0:
                st = trainer.state.optimizer.state
                g1 = {k: float((st[params[k]]["exp_avg"].double()
                                / (1.0 - BETA1)).norm())
                      if params[k] in st else 0.0 for k in names}
        change = {k: float((params[k].detach().double()
                            - w[k].double()).norm()) for k in names}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        t1 = t0 + seconds
        epoch = 1
        while time.perf_counter() < t1:
            if trace and not prof_box:
                prof_box.append(_profiled_epoch(trainer, loader, epoch,
                                                device))
                epochs.append(prof_box[0][3])
            else:
                a = time.perf_counter()
                trainer.run_epoch(loader, True, epoch)
                epochs.append((a, time.perf_counter(), len(loader)))
            epoch += 1
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        batch_size = int(traffic["batch_size"])
        steps_per_epoch = len(loader)
        del trainer, module, params, loader, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    done = [(a, b, n) for a, b, n in epochs if b <= t1]
    metrics: Dict[str, Any] = {}
    rate = (sum(n for _, _, n in done) * batch_size
            / sum(b - a for a, b, _ in done)) if done else None
    # the per-layer rate leaves the profiled epoch out
    plain = [e for e in epochs if not prof_box or e != prof_box[0][3]]
    trace_rate = (sum(n for _, _, n in plain) * batch_size
                  / sum(b - a for a, b, _ in plain)) if plain else None
    log(f"train: {len(epochs)} epochs of {steps_per_epoch} steps, "
        f"{len(done)} inside the window; losses of the first steps "
        f"{losses}; epoch seconds "
        + " ".join(f"{b - a:.3f}" for a, b, _ in epochs))

    with core.fp32():
        r_losses, r_g1, r_change = ref.steps(w, first)
        c = (ref.steps(w, first, low=True) if control_bits else None)
        rows = loader_mismatch(first, vols, device)
        flops = _step_flops(w, first[0]) if trace else None
    med = statistics.median(r_g1.values())
    keep = [k for k in r_g1 if r_g1[k] >= EXCLUDE_BELOW * med]
    readings = _readings(losses, g1, change, r_losses, r_g1, r_change, keep)
    control = (_readings(*c, r_losses, r_g1, r_change, keep)
               if c is not None else None)
    lim = check["limits"]
    checks = {f"train.{k}": (readings[k], float(lim[k])) for k in lim}
    checks["loader_rows"] = (rows, float(check["loader_rows"]))
    correct = all(core.passes(v, l_) for v, l_ in checks.values())
    control_correct = (all(core.passes(control[k], float(lim[k]))
                           for k in lim) if control else None)

    setup_s = t0 - t_process
    profile = None
    if prof_box:
        prof, h0, h1, _ = prof_box[0]
        profile = core.summarize(prof, h0, h1, spans)
    ctx = core.Context(cell=name, config=cfg, traffic=traffic,
                       rate=trace_rate if trace else rate,
                       spans=spans, window=(t0, t1), profile=profile,
                       slice_ideal_s=(flops / batch_size / core_peak()
                                      if flops else 0.0))
    for m in core.cell_metrics(bench, name, trace):
        if trace:
            v = core.reader(m["name"]).read(ctx)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = rate if m["name"] == "train_slices_per_s" else None
        if v is not None:
            metrics[m["name"]] = (float(v), m["unit"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if profile is not None:
        dev["busy_s"], dev["window_s"] = profile.busy_s, profile.window_s
        breakdown = {"device_ops": profile.top_ops(),
                     "idle_gaps": profile.top_gaps}
    return {"correct": correct, "attempted": n_first + sum(
        n for _, _, n in epochs), "failed": 0, "metrics": metrics,
        "device": dev, "checks": checks, "breakdown": breakdown,
        "readings": readings, "control": control,
        "control_correct": control_correct, "setup_s": setup_s}


def core_peak() -> float:
    from portbench.reference.counts import PEAK_BF16_FLOPS

    return PEAK_BF16_FLOPS


def _step_flops(w: Dict[str, torch.Tensor], batch: torch.Tensor) -> float:
    """Forward and backward FLOPs of one step on the plain reference
    (``torch.utils.flop_counter``)."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              w.items() if not k.endswith(("running_mean", "running_var"))}
    with FlopCounterMode(display=False) as fc:
        ref.forward_train(params, batch[..., :2]).square().mean().backward()
    return float(fc.get_total_flops())


def _profiled_epoch(trainer, loader, epoch: int, device):
    """One whole epoch under ``torch.profiler`` (the device's activity):
    ``(profiler, host start, host end, (start, end, steps))``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA] if device.type == "cuda"
                 else [ProfilerActivity.CPU]) as prof:
        h0 = time.perf_counter()
        trainer.run_epoch(loader, True, epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        h1 = time.perf_counter()
    return prof, h0, h1, (h0, h1, len(loader))
