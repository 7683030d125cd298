"""Profiler, spans and debug hooks (counterpart: ``mrisr_tpu/utils/profiling.py``).

- ``profile_trace`` records a ``torch.profiler`` trace (the host's ops of
  every thread, and the card's kernels when there is a card) and writes it
  to ``log_dir`` in the TensorBoard / Perfetto format, as
  ``jax.profiler.trace`` does there.
- ``span`` marks a phase of the program.  While no ``torch.profiler`` is
  recording it reads one flag and records nothing.  While one records (an
  operator's ``profile_trace``, a benchmark's profiled stretch) the span
  keeps its name, parent, ids and host times in ``RECORDER``, with its
  device time where asked, and opens a ``record_function`` of its name, so
  the phase shows in the trace.  The profiler is the switch: there is no
  other.
- ``profiler_events`` places a finished profiler's events on the spans'
  clock.
- ``enable_nan_debug`` flips autograd's anomaly mode, which raises at the
  backward op that produced a NaN (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# ``torch.profiler.profile`` sets ``_is_profiler_enabled`` while it records:
# one flag for every thread (``torch._C._autograd._profiler_enabled()`` is
# the calling thread's alone, and the engine's dispatcher is another thread)
_autograd_profiler = torch.autograd.profiler
_keys = itertools.count(1)
_local = threading.local()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``log_dir`` when it is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # every thread's host ops and spans, not only the caller's: the serving
    # engine's dispatcher is a thread of its own
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir),
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)):
        yield


def _epoch_offset_ns() -> int:
    """``time.time_ns()`` (the epoch clock that the profiler stamps) less
    ``time.perf_counter_ns()`` (the spans' clock), read back to back."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


class Span:
    """One span, live inside its ``with`` block and kept in ``RECORDER``
    after it: ``name``; ``key``, and ``parent``, the ``key`` of the span
    open around it on the same thread (None at the top); ``ids`` (e.g.
    the engine's batch ordinal); ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``; ``device_ms``."""

    __slots__ = ("name", "ids", "key", "parent", "start_ns", "end_ns",
                 "_events", "_device_ms", "_fn")

    def __init__(self, name: str, device_time: bool, ids: Dict):
        self.name = name
        self.ids = ids
        self.key = next(_keys)
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0
        # on the card, a pair of events on the current stream, read when
        # the recorder is read, so the program never waits for them
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if device_time and torch.cuda.is_initialized()
                        else None)
        self._device_ms: Optional[float] = None
        self._fn = None

    def __enter__(self) -> "Span":
        stack = _local.__dict__.setdefault("stack", [])
        if stack:
            self.parent = stack[-1].key
        stack.append(self)
        self._fn = _autograd_profiler.record_function(self.name)
        self._fn.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._fn.__exit__(*exc)
        self._fn = None
        _local.stack.pop()
        RECORDER.add(self)
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the card between the span's start and end on
        the stream that was current at each; None for a host-only span."""
        if self._events is None:
            return None
        if self._device_ms is None:
            self._events[1].synchronize()
            self._device_ms = self._events[0].elapsed_time(self._events[1])
        return self._device_ms


class _Off:
    """What ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class SpanRecorder:
    """The spans that ended while a profiler recorded, in memory: at most
    ``cap`` (``dropped`` counts those past it, until ``clear``).
    ``offset_ns``: the epoch clock less the spans' clock, read when the
    recorder took its first span (``profiler_events`` uses it)."""

    def __init__(self, cap: int = 1 << 16):
        self.cap = cap
        self.dropped = 0
        self.offset_ns = _epoch_offset_ns()
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, s: Span) -> None:
        with self._lock:
            if not self._spans:
                self.offset_ns = _epoch_offset_ns()
            if len(self._spans) < self.cap:
                self._spans.append(s)
            else:
                self.dropped += 1

    def spans(self) -> List[Span]:
        """The spans kept, in the order they ended."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0


RECORDER = SpanRecorder()


def span(name: str, device_time: bool = False, **ids):
    """A context manager that records the block as span ``name`` in
    ``RECORDER`` while a ``torch.profiler`` records, and does nothing
    otherwise.  ``device_time``: on the card, also the time between the
    block's start and end on the current stream (``Span.device_ms``).
    ``ids``: numbers that the spans of one unit of work share."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device_time, ids)


def profiler_events(prof, device: bool = False
                    ) -> List[Tuple[str, int, int]]:
    """A finished ``torch.profiler.profile``'s events as ``(name, start_ns,
    end_ns)`` on the spans' clock (``time.perf_counter_ns``): the trace's
    own zero (``trace_start_ns``, on the epoch clock) less ``RECORDER``'s
    ``offset_ns``.  ``device``: the card's events alone (kernels, copies,
    sets)."""
    zero = (prof.profiler.kineto_results.trace_start_ns()
            - RECORDER.offset_ns)
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, zero + round(e.time_range.start * 1e3),
             zero + round(e.time_range.end * 1e3))
            for e in prof.events()
            if not device or e.device_type == cuda]


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
