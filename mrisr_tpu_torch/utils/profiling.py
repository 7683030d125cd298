"""Profiler and debug hooks (counterpart: ``mrisr_tpu/utils/profiling.py``).

- ``profile_trace`` records a ``torch.profiler`` trace (the host's ops, and
  the card's kernels when there is a card) and writes it to ``log_dir`` in
  the TensorBoard / Perfetto format, as ``jax.profiler.trace`` does there.
- ``enable_nan_debug`` flips autograd's anomaly mode, which raises at the
  backward op that produced a NaN (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``log_dir`` when it is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
