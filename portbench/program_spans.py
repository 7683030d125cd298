"""The port's own spans (``mrisr_tpu_torch/utils/profiling.py``), for the
per-layer readers of a traced run: the spans that the port recorded while
the benchmark's profiler ran, and the share of a span's device time that
the spans inside it take.  A port that records no spans gives nothing to
read, and the readers then read None."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional


def recorded(ctx) -> List:
    """The port's spans that started after the cell's window opened
    (``ctx.window``, ``time.perf_counter`` seconds, the spans' clock): the
    cell's profiler starts inside the window, and the port records only
    while it runs, which may outlast the window when its start stalls."""
    try:
        from mrisr_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return []
    t0 = round(ctx.window[0] * 1e9)
    return [s for s in RECORDER.spans() if s.start_ns >= t0]


def device_share(ctx, outer: str, inner: Iterable[str]) -> Optional[float]:
    """The share of an ``outer`` span's device time that the spans named
    in ``inner`` inside it (at any depth) take, in %, the median over the
    whole ``outer`` spans: an inner span whose ``outer`` began before the
    profiler did is left out with it, and the median keeps out the few
    spans that end while the profiler stops, whose device time holds the
    card's stall at the profiler's teardown.  None where no ``outer`` span
    has a device time."""
    spans = recorded(ctx)
    by_key = {s.key: s for s in spans}
    tops = {s.key: s.device_ms for s in spans
            if s.name == outer and s.device_ms}
    if not tops:
        return None
    part = dict.fromkeys(tops, 0.0)
    inner = set(inner)
    for s in spans:
        if s.name not in inner or s.device_ms is None:
            continue
        up = by_key.get(s.parent)
        while up is not None and up.key not in tops:
            up = by_key.get(up.parent)
        if up is not None:
            part[up.key] += s.device_ms
    return statistics.median(100.0 * part[k] / ms for k, ms in tops.items())
