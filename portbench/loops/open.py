"""Open loop: whole volumes arrive on a schedule, whatever the engine's
state, and each submits its plan's pairs at once (a reader opening a
study; ``predict-volume``'s 3 mm plan of a 60-slice series: 29 requests).

The schedule: ``round(volumes_per_s x seconds)`` arrivals, their times
uniform over the window and sorted (a Poisson process given its count, so
every seed offers the same number of volumes), each a volume of the pool
drawn from the seed.  A volume's latency runs from its due time to the
resolution of its last slice; the generator's lateness (start of its
submission after the due time) is reported beside it.

End-to-end: ``volume_p95_ms`` over every volume due in the window.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

import numpy as np

from portbench.core import percentile
from portbench.loops import LoopOut, Marks

DRAIN_TIMEOUT_S = 60.0


def schedule(seed: int, rate: float, seconds: float, n_vol: int):
    """``(due offsets sorted, volume of each)`` of a run."""
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    n = max(1, round(rate * seconds))
    return np.sort(rng.uniform(0.0, seconds, n)), rng.integers(n_vol, size=n)


def run(engine, pool: np.ndarray, traffic: Dict[str, Any], seed: int,
        seconds: float, window, sample_size: int, rows=None) -> LoopOut:
    n_vol, n_pair = pool.shape[:2]
    due, vols = schedule(seed, float(traffic["volumes_per_s"]), seconds,
                         n_vol)
    n = len(due)
    rng = np.random.default_rng([seed % 2 ** 63, 11])
    keep = set(rng.choice(n, size=min(n, -(-sample_size // n_pair)),
                          replace=False).tolist())
    marks = Marks(engine)
    last = np.zeros(n)
    left = np.full(n, n_pair)
    errors = [0]
    done = threading.Event()
    lateness = np.zeros(n)
    kept = {}
    submitted = [0]

    def resolved(j: int, fut) -> None:
        # the engine's thread alone runs these: no lock needed
        marks.record(fut)
        last[j] = time.perf_counter()
        if fut.exception() is not None:
            errors[0] += 1
        left[j] -= 1
        if submitted[0] == n and not left.any():
            done.set()

    def generate(t0: float) -> None:
        for j in range(n):
            at = t0 + due[j]
            wait = at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lateness[j] = time.perf_counter() - at
            futs = []
            for p in range(n_pair):
                fut = engine.submit(pool[vols[j], p])
                fut.add_done_callback(lambda f, j=j: resolved(j, f))
                if j in keep:
                    futs.append((p, fut))
            if futs:
                kept[j] = futs
        submitted[0] = n
        if not left.any():
            done.set()

    t0 = time.perf_counter() + 0.05
    gen = threading.Thread(target=generate, args=(t0,), daemon=True)
    gen.start()
    t1 = t0 + seconds
    window(t0, t1)
    gen.join(DRAIN_TIMEOUT_S)
    finished = done.wait(DRAIN_TIMEOUT_S)
    out = LoopOut(window=(t0, t1), attempted=n * n_pair, marks=marks.items)
    out.failed = errors[0] + (0 if finished else int(left.sum()))
    lat = (last - (t0 + due)) * 1e3
    if finished:
        out.metrics["volume_p95_ms"] = (percentile(lat, 95), "ms")
    for j, futs in kept.items():
        for p, fut in futs:
            if fut.done() and fut.exception() is None:
                row = rows.pop(id(fut), None) if rows is not None else None
                out.samples.append((int(vols[j]), p, fut.result().copy(),
                                    row))
    out.rate = n * n_pair / (t1 - t0)  # offered
    out.lines.append(
        f"open loop: {n} volumes of {n_pair} pairs at "
        f"{traffic['volumes_per_s']} /s; latency ms p50 "
        f"{percentile(lat, 50):.3f} p95 {percentile(lat, 95):.3f} max "
        f"{lat.max():.3f}; generator late ms p50 "
        f"{percentile(lateness * 1e3, 50):.4f} p95 "
        f"{percentile(lateness * 1e3, 95):.4f} max "
        f"{lateness.max() * 1e3:.4f}")
    out.lateness_ms = lateness * 1e3
    out.latency_ms = lat
    return out
