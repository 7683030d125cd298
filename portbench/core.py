"""What every cell shares: finding things by name, the window arithmetic,
the profiler's summary, the import guard and the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: a configuration (its ``family`` names the
  module ``families/<family>.py`` that builds the served program and
  holds it to its plain reference);
- ``traffic/<traffic>.json``: a traffic mix (its ``loop`` names the
  generator ``loops/<loop>.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import math
import os
import re
import statistics
import sys
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# compared by whole top-level name: the port's name starts with the JAX
# package's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mrisr_tpu")


def benchmark(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def with_deferred(bench: Dict[str, Any]) -> Dict[str, Any]:
    """``bench`` with the entries of ``deferred.json`` added: the cells
    measured but left out of ``BENCHMARK.json`` (the tests and
    ``control.py`` run them)."""
    with open(os.path.join(HERE, "deferred.json")) as f:
        extra = json.load(f)
    return {**bench, **{k: bench[k] + extra[k] for k in
                        ("workloads", "end_to_end", "per_layer")}}


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def data_file(kind: str, name: str, base: str = HERE) -> Dict[str, Any]:
    """``<base>/<kind>/<name>.json``: a configuration or a traffic mix."""
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``portbench.<kind>.<name>``: a family or a loop."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def reader(name: str, base: str = HERE):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``; the name may hold dots)."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], name: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics cell ``name`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (a metric without ``workloads`` goes to
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    own = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in own
                             else [])]


def merged(base: Dict[str, Any], overrides: Optional[Dict[str, Any]]
           ) -> Dict[str, Any]:
    """``base`` with ``overrides`` merged in, nested dicts key by key."""
    out = dict(base)
    for k, v in (overrides or {}).items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


# ------------------------------------------------------------ arithmetic
def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    rank = q / 100.0 * (len(v) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (rank - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def batch_edges(marks: Iterable[Tuple[float, int]], t0: float, t1: float
                ) -> Tuple[float, float, int]:
    """Completed work over the window ``[t0, t1]`` with its edges at batch
    completions.  ``marks``: one ``(time, batch ordinal)`` a resolved
    request.  A batch completes when its first request resolves; the
    window runs from the first completion at or after ``t0`` to the last
    at or before ``t1``, and counts the requests of the batches after the
    first.  Returns ``(start, end, requests)``."""
    first: Dict[int, float] = {}
    count: Dict[int, int] = {}
    for t, b in marks:
        first[b] = min(first.get(b, t), t)
        count[b] = count.get(b, 0) + 1
    inside = sorted((t, b) for b, t in first.items() if t0 <= t <= t1)
    if len(inside) < 2:
        raise ValueError(f"{len(inside)} batch completions in the window: "
                         "a rate needs two")
    return (inside[0][0], inside[-1][0],
            sum(count[b] for _, b in inside[1:]))


def gap_readings(dist: Sequence[float], norms: Sequence[float]
                 ) -> Dict[str, float]:
    """The gap of a sample of answers from the reference, each answer's
    distance over a norm of the reference: ``worst`` its own norm's,
    ``worst_med`` the larger of its own and the sample's median norm (an
    answer whose reference is all but zero does not read huge), and
    ``pooled`` all distances over all norms (root of sums of squares)."""
    med = statistics.median(norms)
    return {
        "worst": max(d / max(n, 1e-30) for d, n in zip(dist, norms)),
        "worst_med": max(d / max(n, med, 1e-30) for d, n in zip(dist, norms)),
        "pooled": math.sqrt(sum(d * d for d in dist)
                            / max(sum(n * n for n in norms), 1e-300)),
    }


def passes(number: float, limit: float) -> bool:
    """The test every compared number meets in a correct run, and the one
    a control or a planted fault has to fail: finite and at most its
    limit."""
    return math.isfinite(number) and number <= limit


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


# ---------------------------------------------------------------- spans
class Spans:
    """Host spans kept in memory: ``name -> [(start, end)]`` on the
    ``time.perf_counter`` clock."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}

    def add(self, name: str, start: float, end: float) -> None:
        self.spans.setdefault(name, []).append((start, end))

    def within(self, name: str, t0: float, t1: float
               ) -> List[Tuple[float, float]]:
        return [(a, b) for a, b in self.spans.get(name, ())
                if a >= t0 and b <= t1]

    def named_at(self, a: float, b: float) -> str:
        """The span name that overlaps ``[a, b]`` the most."""
        best, name = 0.0, "no benchmark span"
        for n, lst in self.spans.items():
            i = bisect.bisect_left(lst, (a - 60.0, a - 60.0))
            cover = sum(max(0.0, min(b, e) - max(a, s))
                        for s, e in lst[i:] if s < b)
            if cover > best:
                best, name = cover, n
        return name


# ------------------------------------------------------------- profiler
@dataclass
class Profile:
    """The summary of a profiled sub-window: device time by kernel name,
    the busy union of kernels and copies, the window, and the gaps."""

    kernels: Dict[str, List[float]] = field(default_factory=dict)
    busy_s: float = 0.0
    window_s: float = 0.0
    top_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def matching(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        secs = sum(v[0] for k, v in self.kernels.items() if rx.search(k))
        n = sum(int(v[1]) for k, v in self.kernels.items() if rx.search(k))
        return secs, n

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        return [[name[:120], v[0]] for name, v in sorted(
            self.kernels.items(), key=lambda kv: -kv[1][0])[:k]]


def summarize(prof, host_t0: float, host_t1: float, spans: Spans) -> Profile:
    """Read a finished ``torch.profiler.profile``: every device event
    (kernels, copies, sets) by name, their union over the window, and the
    ten longest idle gaps named by the benchmark's host span over them.
    Event times are microseconds from the trace's start, which is taken as
    ``host_t0`` on the host clock."""
    import torch

    out = Profile(window_s=host_t1 - host_t0)
    dev = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        dev.append((a, b))
        row = out.kernels.setdefault(e.name, [0.0, 0])
        row[0] += b - a
        row[1] += 1
    if not dev:
        return out
    lo = min(a for a, _ in dev)
    hi = max(b for _, b in dev)
    out.window_s = max(out.window_s, hi - lo)
    out.busy_s = union_length(dev)
    holes = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    out.top_gaps = [[spans.named_at(host_t0 + a, host_t0 + b), b - a]
                    for a, b in holes]
    return out


@contextlib.contextmanager
def fp32() -> Iterator[None]:
    """Full float32 convolutions and matmuls (TF32 off) inside the block:
    the references run so."""
    import torch

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def calibration(cfg: Dict[str, Any], pool, seed: int) -> List:
    """The export's calibration batches: ``serve.calibration``'s count of
    batches of its size, pairs drawn from the pool without repeats within
    a batch."""
    import numpy as np

    c = cfg["serve"]["calibration"]
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    flat = pool.reshape(-1, *pool.shape[2:])
    return [flat[rng.choice(len(flat), size=int(c["batch_size"]),
                            replace=False)] for _ in range(int(c["batches"]))]


# ---------------------------------------------------------------- guard
def forbidden_loaded() -> List[str]:
    """Modules of JAX or the JAX package in ``sys.modules``, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------- result
@dataclass
class Context:
    """What a per-layer reader reads."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    rate: Optional[float] = None            # slices a second, the window's
    engine: Dict[str, float] = field(default_factory=dict)  # counter deltas
    spans: Spans = field(default_factory=Spans)
    window: Tuple[float, float] = (0.0, 0.0)
    profile: Optional[Profile] = None
    sites: Dict[str, List[Tuple[str, float, float, float]]] = field(
        default_factory=dict)               # a kernel's sites a forward
    slice_ideal_s: float = 0.0              # a slice's ops over the peaks
    card_ms_per_slice: Optional[float] = None  # CUDA events, the window's

    def span_ms(self, name: str) -> Optional[float]:
        d = [b - a for a, b in self.spans.within(name, *self.window)]
        return 1e3 * sum(d) / len(d) if d else None

    def roofline(self, kernel: str, pattern: str) -> Optional[float]:
        """Bound time over device time of ``kernel`` in the profiled
        sub-window, in %; the launches counted in whole forwards."""
        from portbench.reference.counts import bound_s

        if self.profile is None or kernel not in self.sites:
            return None
        secs, n = self.profile.matching(pattern)
        per = len(self.sites[kernel])
        if secs <= 0 or n < per:
            return None
        bound = n / per * sum(bound_s(s) for s in self.sites[kernel])
        return 100.0 * bound / secs


def idle_pct(ctx: Context) -> Optional[float]:
    """The share of the profiled sub-window in which no kernel, copy or
    set ran on the card: one minus the union of their intervals over the
    sub-window, in %."""
    p = ctx.profile
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def apply_ms(ctx: Context) -> Optional[float]:
    """Host ms of one call into the engine's forward, the mean over the
    window's calls, from the benchmark's span around each call."""
    return ctx.span_ms("apply")


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: Dict[str, Any],
                checks: Dict[str, Tuple[float, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in
                    metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    # a number that never came (no sample) reads null, never Infinity
    out["check"] = {k: {"value": v if math.isfinite(v) else None,
                        "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)
