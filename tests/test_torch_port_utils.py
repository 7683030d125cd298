"""The port's utils (logging and profiling) against mrisr_tpu's (CPU): the
cases of tests/test_utils.py, plus profile_trace writing a torch.profiler
trace."""

import json
import logging
import time

import pytest
import torch

from mrisr_tpu.utils.logging import StepTimer as JaxStepTimer
from mrisr_tpu.utils.logging import get_logger as jax_get_logger
from mrisr_tpu_torch.utils import (
    StepTimer,
    enable_nan_debug,
    get_logger,
    profile_trace,
)


def test_step_timer_rates():
    t, want = StepTimer(items_per_step=4), JaxStepTimer(items_per_step=4)
    for _ in range(3):
        with t:
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3
    assert s["elapsed_s"] >= 0.03
    assert 0 < s["steps_per_sec"] <= 100
    # both rates are rounded on their own: allow the rounding
    assert s["items_per_sec"] == pytest.approx(s["steps_per_sec"] * 4,
                                               abs=0.011)
    # the JAX meter summarises the same elapsed time the same way
    want.steps, want.elapsed = t.steps, t.elapsed
    assert want.summary() == s
    t.reset()
    assert t.steps == 0 and t.elapsed == 0.0
    assert t.summary()["steps_per_sec"] == 0.0


def test_logger_singleton():
    a = get_logger("mrisr.port_test")
    b = get_logger("mrisr.port_test")
    assert a is b and len(a.handlers) == 1
    assert a.level == logging.INFO and not a.propagate
    # the JAX package's record format
    want = jax_get_logger("mrisr.port_test_jax").handlers[0].formatter
    assert a.handlers[0].formatter._fmt == want._fmt


def test_profile_trace_noop_and_nan_debug():
    with profile_trace(None):
        pass
    with profile_trace(""):
        pass
    try:
        enable_nan_debug(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    finally:
        enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()


def test_profile_trace_writes_a_trace(tmp_path):
    """A set log_dir gets one Chrome/TensorBoard trace holding the block's
    ops."""
    with profile_trace(str(tmp_path / "trace")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
