"""The benchmark's arithmetic on hand-made inputs, and its operation counts
against the figures they are held to."""

import statistics

import pytest

from portbench import core
from portbench.reference import counts, fastddpm, unet


def test_percentile_is_linear_between_order_statistics():
    assert core.percentile([1, 2, 3, 4, 5], 50) == 3
    assert core.percentile([10, 20], 95) == pytest.approx(19.5)
    assert core.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert core.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        core.percentile([], 50)


def test_spread_uses_statistics_quartiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert core.spread(v) == pytest.approx((q3 - q1) / med)


def test_batch_edges_count_whole_batches_inside_the_window():
    # batch 1 ends before the window, 2-4 inside, 5 after the deadline
    marks = [(0.5, 1)] * 4 + [(1.0, 2)] * 4 + [(1.002, 2)] * 4 \
        + [(2.0, 3)] * 8 + [(3.0, 4)] * 8 + [(4.5, 5)] * 8
    start, end, n = core.batch_edges(marks, 0.9, 4.0)
    assert (start, end) == (1.0, 3.0)
    assert n == 16  # batches 3 and 4; batch 2 opens the window
    with pytest.raises(ValueError):
        core.batch_edges(marks, 3.5, 4.0)


def test_zero_answers_read_one_and_fail_every_limit():
    # an answer of zeros is its reference's norm away: 1 by either
    # statistic, so a cell's limit on them has to stay under 1
    norms = [3.0, 1.0, 2.0, 0.5]
    r = core.gap_readings(norms, norms)
    assert r["worst_med"] == pytest.approx(1.0)
    assert r["pooled"] == pytest.approx(1.0)
    for name in ("unet_m2", "fastddpm"):
        lim = core.data_file("configs", name)["check"]["limit"]
        assert not core.passes(r["worst_med"], lim)


def test_passes_is_finite_and_at_most_the_limit():
    assert core.passes(0.7, 0.7) and core.passes(0.0, 0.7)
    assert not core.passes(0.71, 0.7)
    assert not core.passes(float("nan"), 0.7)
    assert not core.passes(float("inf"), 0.7)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.2, 3.4)]
    assert core.union_length(iv) == pytest.approx(3.0)
    assert core.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert core.union_length([]) == 0.0


def test_roofline_counts_whole_forwards():
    sites = counts.unet_kernel_sites(8)
    bound = sum(counts.bound_s(s) for s in sites["kernel_a"])
    prof = core.Profile(kernels={
        "void conv_int8_tc_kernel<1>(CUtensorMap)": [0.5, 17 * 10],
        "conv_int8_kernel": [0.1, 2 * 10],
        "upconv_int8_tc_kernel": [0.2, 40]}, busy_s=0.8, window_s=1.0)
    ctx = core.Context(cell="c", config={}, traffic={}, profile=prof,
                       sites=sites)
    pat_a = core.reader("kernel_a_roofline").PATTERN
    assert ctx.roofline("kernel_a", pat_a) == pytest.approx(
        100 * 10 * bound / 0.6)
    pat_b = core.reader("kernel_b_roofline").PATTERN
    assert prof.matching(pat_b) == (0.2, 40)  # A's pattern misses B
    assert ctx.roofline("k3", "gn_silu") is None
    # the sampler cell's readers count the same kernels
    for k, pat in (("a", pat_a), ("b", pat_b)):
        assert core.reader(f"kernel_{k}_sampler_roofline").PATTERN == pat


def test_mfu_is_rate_times_ideal_time():
    ctx = core.Context(cell="c", config={}, traffic={"loop": "closed"},
                       rate=1000.0, slice_ideal_s=2e-5)
    assert core.reader("mfu.serve").read(ctx) == pytest.approx(2.0)
    ctx.traffic["loop"] = "open"
    assert core.reader("mfu.serve").read(ctx) is None


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_card_time_counts_the_forwards_started_in_the_window():
    from portbench.cell import _card_ms_per_slice

    # (host start, requests, start event, end event); ms on the card
    card = [(0.5, 8, _Event(0.0), _Event(9.0)),     # warm-up: left out
            (1.0, 8, _Event(10.0), _Event(12.0)),
            (1.5, 6, _Event(20.0), _Event(23.5)),   # a part-full batch
            (2.0, 8, _Event(30.0), _Event(40.0))]   # at the deadline: out
    assert _card_ms_per_slice(card, 1.0, 2.0) == pytest.approx(5.5 / 14)
    assert _card_ms_per_slice(card, 3.0, 4.0) is None


def test_forward_mfu_is_ideal_time_over_card_time():
    ctx = core.Context(cell="c", config={}, traffic={"loop": "closed"},
                       slice_ideal_s=5e-5, card_ms_per_slice=0.25)
    assert core.reader("mfu.forward").read(ctx) == pytest.approx(20.0)
    ctx.card_ms_per_slice = None
    assert core.reader("mfu.forward").read(ctx) is None


def test_engine_rate_reads_the_closed_loop_alone():
    ctx = core.Context(cell="c", config={}, traffic={"loop": "closed"},
                       rate=3500.0)
    assert core.reader("engine.slices_per_s").read(ctx) == 3500.0
    ctx.traffic["loop"] = "open"
    assert core.reader("engine.slices_per_s").read(ctx) is None


@pytest.mark.parametrize("name", ["device.idle_pct.serve",
                                  "device.idle_pct.volume",
                                  "device.idle_pct.train"])
def test_idle_share_reads_the_profile(name):
    ctx = core.Context(cell="c", config={}, traffic={},
                       profile=core.Profile(busy_s=0.75, window_s=1.0))
    assert core.reader(name).read(ctx) == pytest.approx(25.0)
    ctx.profile = None
    assert core.reader(name).read(ctx) is None


def test_parameter_counts():
    assert unet.num_parameters(64) == 31_042_945
    assert fastddpm.num_parameters(64, 128) == 13_899_905


def test_unet_flops_against_xla():
    """bench.py's 94.47 GFLOP a 256^2 slice (XLA's cost analysis, 2 x MAC)
    within 1 % counts the taps inside the image; the kernels' count, which
    includes the SAME padding's taps, is 1.9 % above it."""
    assert counts.unet_flops_per_slice(valid_taps=True) == pytest.approx(
        94.47e9, rel=0.01)
    assert counts.unet_flops_per_slice() == pytest.approx(96.2592768e9)


def test_kernel_bounds_at_batch_8():
    """PERF.md's kernel table: A 0.393 ms (operations), B 0.067 (bytes),
    K3 0.165 (bytes)."""
    u = counts.unet_kernel_sites(8)
    a = sum(counts.bound_s(s) for s in u["kernel_a"])
    b = sum(counts.bound_s(s) for s in u["kernel_b"])
    k3 = sum(counts.bound_s(s) for s in counts.fastddpm_kernel_sites(8)["k3"])
    assert a * 1e3 == pytest.approx(0.393, abs=5e-4)
    assert b * 1e3 == pytest.approx(0.067, abs=5e-4)
    assert k3 * 1e3 == pytest.approx(0.165, abs=5e-4)
    ops = sum(s[1] / s[3] for s in u["kernel_a"])
    assert a > ops * 1.0 - 1e-12 and b == pytest.approx(
        sum(s[2] for s in u["kernel_b"]) / counts.PEAK_BYTES)
