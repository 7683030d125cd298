"""The port's own tracing (CPU): ``utils/profiling.py:span`` records
nothing without a profiler and its name, parent, ids and nesting under
one, on any thread; its clock lines up with the profiler's once the
profiler's events are placed by ``profiler_events``; the engine's phase
counters add up and its phases are spans of one batch; the int8 UNet, the
Fast-DDPM forward and the ancestral sampler record their spans."""

import collections
import json
import os
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm
from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.models.diffusion import (
    DiffusionSchedule,
    FastDDPMUNet,
    sample_ancestral,
)
from mrisr_tpu_torch.models.unet import UNet
from mrisr_tpu_torch.serve.engine import InferenceEngine
from mrisr_tpu_torch.serve.quant import (
    Int8FusedUNet,
    calibrate_unet,
    quantize_unet,
)
from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu_plain
from mrisr_tpu_torch.serve.quant_diffusion import (
    DEEP_SITES,
    FastDDPMForward,
    _PreQuant,
    calibrate_fastddpm,
    gn_silu_chain,
    int8_forward,
    quantize_fastddpm,
)
from mrisr_tpu_torch.utils.profiling import (
    RECORDER,
    profile_trace,
    profiler_events,
    span,
)

torch.set_num_threads(2)

FEAT, HW, TDIM = 4, 32, 16
# a Fast-DDPM forward: 7 blocks of two GroupNorm sites, and the final norm
GN_SITES = 15
# int8_deep's float sites: enc1's and dec1's norms and the final norm
FLOAT_GN_SITES = ("enc1/norm1", "enc1/norm2", "dec1/norm1", "dec1/norm2",
                  "final_norm")
PHASES = {"engine.wait_first", "engine.collect", "engine.pad",
          "engine.dispatch", "engine.copy_out", "engine.resolve"}
NEW_COUNTERS = ("queue_wait_s", "wait_first_s", "dispatch_s", "sync_wait_s",
                "copy_out_s", "resolve_s")


@pytest.fixture(autouse=True)
def empty_recorder():
    RECORDER.clear()
    yield
    RECORDER.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return collections.Counter(s.name for s in spans)


def _outer(spans, s, name):
    """The span named ``name`` around ``s``, at any depth, or None."""
    by_key = {x.key: x for x in spans}
    up = by_key.get(s.parent)
    while up is not None and up.name != name:
        up = by_key.get(up.parent)
    return up


@pytest.mark.parametrize("device_time", [False, True])
def test_span_records_nothing_without_a_profiler(device_time):
    with span("quiet", device_time=device_time, batch=1) as s:
        x = torch.ones(3).sum()
    assert s is None and float(x) == 3.0
    assert RECORDER.spans() == []


@pytest.mark.parametrize("where", ["main", "thread"])
def test_span_records_name_parent_ids_and_nesting(where):
    """Under a profiler the spans of the calling thread, or of a thread
    started before the profiler (the engine's dispatcher), are kept."""
    go, done = threading.Event(), threading.Event()

    def work():
        with span("outer", batch=7):
            with span("inner", device_time=True, step=2):
                torch.ones(4).sum()
            with span("inner2"):
                pass

    def on_thread():
        go.wait(30)
        if where == "thread":
            work()
        done.set()

    t = threading.Thread(target=on_thread, daemon=True)
    t.start()
    with _cpu_profile():
        if where == "main":
            work()
        go.set()
        assert done.wait(30)
    t.join(30)
    assert not t.is_alive()
    spans = RECORDER.spans()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["inner", "inner2", "outer"]
    assert by["outer"].parent is None
    assert by["inner"].parent == by["inner2"].parent == by["outer"].key
    assert by["outer"].ids == {"batch": 7} and by["inner"].ids == {"step": 2}
    assert (by["outer"].start_ns <= by["inner"].start_ns
            <= by["inner"].end_ns <= by["inner2"].start_ns
            <= by["inner2"].end_ns <= by["outer"].end_ns)
    # no card: host-only, whatever was asked
    assert all(s.device_ms is None for s in spans)


def test_span_clock_lines_up_with_the_profiler():
    """A span and the profiler's ``record_function`` event of its name
    start and end within 50 us of each other, once the profiler's events
    are placed on the spans' clock through the trace's own zero (the
    median over the spans: a thread switched out between the two stamps
    is no fault of the clock)."""
    with _cpu_profile() as prof:
        for k in range(8):
            with span(f"clock.{k}"):
                torch.ones(64).sum()
    placed = {name: (a, b) for name, a, b in profiler_events(prof)
              if name.startswith("clock.")}
    spans = RECORDER.spans()
    assert sorted(placed) == sorted(s.name for s in spans)
    assert len(spans) == 8
    for edge in (0, 1):
        off = [abs(placed[s.name][edge] - (s.start_ns, s.end_ns)[edge])
               for s in spans[1:]]  # the first call warms record_function
        assert statistics.median(off) < 50_000, (edge, off)


def test_recorder_keeps_at_most_its_cap(monkeypatch):
    monkeypatch.setattr(RECORDER, "cap", 3)
    with _cpu_profile():
        for _ in range(5):
            with span("capped"):
                pass
    assert len(RECORDER.spans()) == 3 and RECORDER.dropped == 2
    RECORDER.clear()
    assert RECORDER.spans() == [] and RECORDER.dropped == 0


def _plus_one(x):
    return x.mean(dim=-1, keepdim=True) + 1.0


@pytest.mark.parametrize("profiled", [False, True])
def test_engine_phase_counters_and_spans(profiled):
    """The phase counters of a CPU engine at batch 4 add up as documented;
    under a profiler its phases are spans that share the batch ordinal."""
    shape = (8, 8, 2)
    xs = [np.full(shape, k, np.float32) for k in range(10)]
    eng = InferenceEngine(_plus_one, batch_size=4, input_shape=shape,
                          max_delay_ms=5.0, device="cpu")
    try:
        if profiled:
            with _cpu_profile():
                ys = eng.predict_many(xs)
        else:
            ys = eng.predict_many(xs)
    finally:
        eng.close()
    assert [float(y[0, 0, 0]) for y in ys] == [k + 1.0 for k in range(10)]
    s = eng.stats
    assert s.requests == 10 and s.batches >= 3
    assert s.fetch_time_s == pytest.approx(s.sync_wait_s + s.copy_out_s,
                                           rel=1e-9, abs=1e-12)
    assert s.queue_wait_s > 0
    assert all(getattr(s, k) >= 0 for k in NEW_COUNTERS)
    spans = RECORDER.spans()
    if not profiled:
        assert spans == []
        return
    names = _names(spans)
    # no event to wait on without a card; a partial batch is padded
    assert set(names) == PHASES
    assert names["engine.dispatch"] == names["engine.resolve"] == s.batches
    by_batch = collections.defaultdict(set)
    for x in spans:
        by_batch[x.ids["batch"]].add(x.name)
    for k in range(s.batches):
        # the wait for batch 0's first request began before the profiler
        want = PHASES - {"engine.pad"} - (
            {"engine.wait_first"} if k == 0 else set())
        assert want <= by_batch[k], k


@pytest.fixture(scope="module")
def ddpm():
    torch.manual_seed(31)
    params = fastddpm_flax_params(FastDDPMUNet(base_features=FEAT,
                                               time_dim=TDIM))
    return FastDDPMForward(params, gn_impl="chain",
                           device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def int8_unet():
    torch.manual_seed(32)
    model = fold_unet_batchnorm(UNet(features=FEAT).eval())
    x = np.random.default_rng(33).random((2, HW, HW, 2), np.float32)
    return Int8FusedUNet(quantize_unet(model, calibrate_unet(model, [x])),
                         device="cpu"), torch.from_numpy(x)


def test_int8_unet_records_its_sites(int8_unet):
    fwd, x = int8_unet
    with _cpu_profile():
        y = fwd(x)
    assert y.shape == (2, HW, HW, 1)
    spans = RECORDER.spans()
    # 18 3x3 convs and the final 1x1; 4 upconvs; 4 pools
    assert _names(spans) == {"unet.forward": 1, "unet.conv": 19,
                             "unet.upconv": 4, "unet.pool": 4}
    top = spans[-1]
    assert top.name == "unet.forward"
    assert all(s.parent == top.key for s in spans[:-1])


@pytest.mark.parametrize("steps", [1, 3])
def test_sampler_records_one_step_span_a_step(ddpm, steps):
    """One ``sampler.step`` a step, with the Fast-DDPM forward's spans
    inside it: a ``ddpm.gn_chain`` at each GroupNorm site ('chain')."""
    sched = DiffusionSchedule.create(50, steps, "linear", "linspace")
    cond = torch.from_numpy(np.random.default_rng(34).random(
        (2, 16, 16, 2), np.float32))
    with _cpu_profile():
        y = sample_ancestral(ddpm, cond, None, sched)
    assert y.shape == (2, 16, 16, 1) and torch.isfinite(y).all()
    spans = RECORDER.spans()
    step_spans = [s for s in spans if s.name == "sampler.step"]
    assert [s.ids["step"] for s in step_spans] == list(range(steps))
    chains = [s for s in spans if s.name == "ddpm.gn_chain"]
    assert len(chains) == GN_SITES * steps
    assert all(_outer(spans, s, "sampler.step") is not None for s in chains)


def test_fastddpm_forward_records_each_float_site(ddpm):
    x = torch.from_numpy(np.random.default_rng(35).random(
        (2, 16, 16, 3), np.float32))
    with _cpu_profile():
        ddpm(x, torch.tensor([3, 9]))
    names = _names(RECORDER.spans())
    # the float forward: every site a chain and a float conv, no K3, no A
    assert names["ddpm.gn_chain"] == GN_SITES
    assert names["ddpm.upconv"] == 3
    assert names["ddpm.conv_float"] > 0
    assert "ddpm.k3" not in names and "ddpm.conv_int8" not in names


@pytest.fixture(scope="module")
def deep_tables():
    """int8_deep tables of a seeded width-4 Fast-DDPM, calibrated on its
    own 2-step trajectory (per-step scales)."""
    torch.manual_seed(36)
    params = fastddpm_flax_params(FastDDPMUNet(base_features=FEAT,
                                               time_dim=TDIM))
    sched = DiffusionSchedule.create(50, 2, "linear", "linspace")
    cond = torch.from_numpy(np.random.default_rng(37).random(
        (2, 16, 16, 2), np.float32))
    calib = calibrate_fastddpm({"params": params}, sched, [cond],
                               dtype=torch.float32)
    q = quantize_fastddpm({"params": params}, calib, only=DEEP_SITES)
    x = torch.from_numpy(np.random.default_rng(38).random(
        (2, 16, 16, 3), np.float32))
    t = torch.full((2,), int(sched.timesteps[-1]))
    return q, x, t


def _deep_call(q, x, t, gn_impl):
    """One bf16 int8_deep denoiser call under the profiler, each GroupNorm
    site's (gamma, beta, input, input shift, output) kept by norm:
    (output, spans, sites)."""
    fwd = int8_forward(q, gn_impl=gn_impl, device="cpu")
    sites = []

    def act(st, site, norm, h, **kw):
        out = FastDDPMForward._act(fwd, st, site, norm, h, **kw)
        sites.append((norm, *fwd.norms[norm], h, kw.get("shift"), out))
        return out

    fwd._act = act
    with _cpu_profile():
        y = fwd(x, t)
    return y, RECORDER.spans(), sites


def test_fused_int8_deep_runs_k3_at_every_site(deep_tables):
    """'fused': 15 K3 calls a denoiser call, 5 of them each alone inside
    the ``ddpm.gn_chain`` of a float site, which emits the forward's bf16
    (K3's plain version here); the 10 others emit int8 codes.  The 7
    norm2 sites take their block's time projection as K3's shift."""
    y, spans, sites = _deep_call(*deep_tables, "fused")
    assert y.shape == (2, 16, 16, 1) and bool(torch.isfinite(y).all())
    names = _names(spans)
    assert names["ddpm.k3"] == GN_SITES
    assert names["ddpm.gn_chain"] == len(FLOAT_GN_SITES)
    chains = {s.key for s in spans if s.name == "ddpm.gn_chain"}
    inside = collections.Counter(s.parent for s in spans
                                 if s.name == "ddpm.k3")
    assert all(inside[k] == 1 for k in chains)
    assert sum(inside[k] for k in chains) == len(FLOAT_GN_SITES)
    for norm, gamma, beta, h, shift, out in sites:
        assert (shift is not None) == norm.endswith("/norm2"), norm
        if norm in FLOAT_GN_SITES:
            assert out.dtype == torch.bfloat16, norm
            want = groupnorm_silu_plain(h, gamma, beta,
                                        num_groups=max(1, h.shape[-1] // 4),
                                        out_dtype=torch.bfloat16,
                                        shift=shift)
            assert torch.equal(out, want), norm
        else:
            assert isinstance(out, _PreQuant), norm
            assert out.q.dtype == torch.int8, norm
    assert sorted(s[0] for s in sites if not isinstance(s[-1], _PreQuant)) \
        == sorted(FLOAT_GN_SITES)


def test_chain_int8_deep_keeps_the_chain(deep_tables):
    """'chain': a ``ddpm.gn_chain`` at each of the 5 float sites, no K3,
    and every site's output the bits of ``gn_silu_chain``."""
    y, spans, sites = _deep_call(*deep_tables, "chain")
    assert y.shape == (2, 16, 16, 1) and bool(torch.isfinite(y).all())
    names = _names(spans)
    assert names["ddpm.gn_chain"] == len(FLOAT_GN_SITES)
    assert "ddpm.k3" not in names
    assert len(sites) == GN_SITES
    for norm, gamma, beta, h, shift, out in sites:
        assert shift is None, norm
        want = gn_silu_chain(h, gamma, beta, max(1, h.shape[-1] // 4),
                             torch.bfloat16)
        assert torch.equal(out, want), norm


@pytest.mark.parametrize("c", [4, 8, 12, 64, 192])
def test_k3_bf16_and_chain_differ_by_one_rounding(c):
    """At a float site K3 gives ``bf16(silu(y))``, the chain
    ``bf16(silu(bf16(y)))``: each element at most one bf16 step of the
    normalized value y apart, and K3 the nearer to the float32 answer."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn((2, 32, 32, c), generator=g) * 3 + 0.5).to(
        torch.bfloat16)
    gamma = torch.randn(c, generator=g) * 0.5 + 1.0
    beta = torch.randn(c, generator=g) * 0.2
    groups = c // 4
    k3 = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                              out_dtype=torch.bfloat16).float()
    chain = gn_silu_chain(x, gamma, beta, groups, torch.bfloat16).float()
    xd = x.double().reshape(2, -1, groups, 4)
    mean = xd.mean(dim=(1, 3), keepdim=True)
    var = xd.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = (((xd - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
         * gamma.double() + beta.double())
    ref = y * torch.sigmoid(y)
    step = torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(2.0 ** -126)))
                      - 7)
    diff = (k3 - chain).double().abs()
    assert bool((diff <= step).all()), float((diff / step).max())
    assert float((diff > 0).double().mean()) > 0.05  # two roundings, not one
    assert float((k3 - ref).abs().mean()) < float((chain - ref).abs().mean())


def test_profile_trace_holds_the_spans_of_every_thread(tmp_path):
    """The trace ``profile_trace`` writes shows a span of a thread started
    before it (the engine's dispatcher), by its ``record_function``."""
    eng = InferenceEngine(_plus_one, batch_size=2, input_shape=(4, 4, 2),
                          max_delay_ms=1.0, device="cpu")
    try:
        eng.predict(np.zeros((4, 4, 2), np.float32))
        with profile_trace(str(tmp_path)):
            eng.predict_many([np.ones((4, 4, 2), np.float32)] * 3)
    finally:
        eng.close()
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.dispatch", "engine.resolve"} <= names
    assert "engine.dispatch" in _names(RECORDER.spans())
