"""The readers of the port's own counters and spans, on hand-made inputs:
the engine's phase counters, the device share of the spans inside a
span, and None from a port that records neither."""

import sys
import types

import pytest

from portbench import core, program_spans

ENGINE = {"batches": 4, "total_batch_time_s": 0.2, "assemble_time_s": 0.02,
          "dispatch_s": 0.016, "copy_out_s": 0.008, "resolve_s": 0.004,
          "sync_wait_s": 0.05, "fetch_time_s": 0.058}


def _ctx(engine=None, window=(1.0, 2.0)):
    return core.Context(cell="c", config={}, traffic={"loop": "closed"},
                        engine=dict(engine or {}), window=window)


def test_engine_readers_read_the_counters():
    ctx = _ctx(ENGINE)
    assert core.reader("engine.host_ms_per_batch").read(ctx) == \
        pytest.approx(1e3 * 0.048 / 4)
    assert core.reader("engine.sync_wait_pct").read(ctx) == \
        pytest.approx(25.0)


@pytest.mark.parametrize("name", ["engine.host_ms_per_batch",
                                  "engine.sync_wait_pct"])
def test_engine_readers_read_none_without_the_counters(name):
    old = {k: ENGINE[k] for k in ("batches", "total_batch_time_s",
                                  "assemble_time_s", "fetch_time_s")}
    assert core.reader(name).read(_ctx(old)) is None
    assert core.reader(name).read(_ctx(dict(ENGINE, batches=0,
                                            total_batch_time_s=0.0))) is None


class _Span:
    def __init__(self, key, name, parent, start, end, device_ms):
        self.key, self.name, self.parent = key, name, parent
        self.start_ns, self.end_ns = int(start * 1e9), int(end * 1e9)
        self.device_ms = device_ms


def _recorded(monkeypatch, spans):
    from mrisr_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: list(spans))


def test_forward_share_counts_whole_forwards_since_the_window(monkeypatch):
    _recorded(monkeypatch, [
        # its forward began before the profiler: left out
        _Span(1, "unet.conv", None, 1.10, 1.11, 5.0),
        _Span(3, "unet.conv", 2, 1.21, 1.22, 6.0),
        _Span(4, "unet.pool", 2, 1.22, 1.23, None),
        _Span(5, "unet.upconv", 2, 1.23, 1.24, 2.0),
        _Span(2, "unet.forward", None, 1.20, 1.30, 10.0),
        _Span(7, "unet.conv", 6, 1.31, 1.32, 9.0),
        _Span(6, "unet.forward", None, 1.31, 1.40, 10.0),
        # before the window: another cell's
        _Span(9, "unet.conv", 8, 0.91, 0.92, 9.0),
        _Span(8, "unet.forward", None, 0.90, 0.95, 10.0),
        # past the window's end: the profiler's start stalled
        _Span(11, "unet.conv", 10, 2.10, 2.11, 3.0),
        _Span(10, "unet.forward", None, 2.10, 2.12, 10.0),
    ])
    read = core.reader("forward.outside_ab_pct").read
    # inside A and B: 80, 90 and 30 % of the three whole forwards
    assert read(_ctx()) == pytest.approx(100.0 - 80.0)


def test_sampler_share_is_the_median_step_at_any_depth(monkeypatch):
    _recorded(monkeypatch, [
        _Span(3, "ddpm.gn_chain", 2, 1.1, 1.2, 3.0),
        _Span(2, "ddpm.k3", 1, 1.1, 1.2, None),
        _Span(4, "ddpm.gn_chain", 1, 1.2, 1.3, 2.0),
        _Span(1, "sampler.step", None, 1.1, 1.4, 8.0),
        _Span(6, "sampler.step", None, 1.4, 1.5, 2.0),
        _Span(8, "ddpm.gn_chain", 7, 1.5, 1.6, 4.0),
        _Span(7, "sampler.step", None, 1.5, 1.7, 10.0),
        # a step that ends while the profiler stops: the card's stall
        _Span(10, "ddpm.gn_chain", 9, 1.8, 1.9, 290.0),
        _Span(9, "sampler.step", None, 1.8, 1.9, 300.0),
    ])
    read = core.reader("sampler.gn_chain_pct").read
    # 62.5, 0, 40 and 96.7 % by step
    assert read(_ctx()) == pytest.approx((40.0 + 62.5) / 2)


@pytest.mark.parametrize("name", ["forward.outside_ab_pct",
                                  "sampler.gn_chain_pct"])
def test_span_readers_read_none_without_spans(monkeypatch, name):
    read = core.reader(name).read
    _recorded(monkeypatch, [])
    assert read(_ctx()) is None
    # host-only spans (no card) give no device time
    _recorded(monkeypatch, [_Span(1, "unet.forward", None, 1.1, 1.2, None),
                            _Span(2, "sampler.step", None, 1.1, 1.2, None)])
    assert read(_ctx()) is None
    # a port without the recorder
    monkeypatch.setitem(sys.modules, "mrisr_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert program_spans.recorded(_ctx()) == []
    assert read(_ctx()) is None
