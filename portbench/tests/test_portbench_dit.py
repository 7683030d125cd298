"""The ``fastddpm_dit.serve_saturate`` cell: its configuration, family,
traffic and readers resolve by name; its configuration states DiT-XL/8;
its counts reckon the published forward; its new readers on hand-made
spans; and a whole run on the CPU at a tiny size (hidden 64, depth 2, 4
heads of 16, patch 8 over 32^2, 2 sampler steps) is correct sound and not
correct with each fault of ``faults.py`` planted, under the cell's own
limit: at that size the int8 gap from the float reference reads 0.0048
and the faults 1.00-1.22."""

import time

import pytest
import torch

from mrisr_tpu_torch.models import dit
from portbench import core
from portbench.cell import run_cell
from portbench.faults import SERVING
from portbench.reference import counts, counts_dit
from portbench.reference import fastddpm_dit as ref

CELL = "fastddpm_dit.serve_saturate"
BENCH = core.benchmark()
TINY = {"widths": {"hidden_size": 64, "depth": 2, "num_heads": 4},
        "image_size": 32, "volume": {"slices": 12}, "sampler": {"steps": 2}}
TRAFFIC = {"engine": {"batch_size": 4}, "pool_volumes": 2, "clients": 2,
           "outstanding": 4, "settle_s": 0.1, "profile_s": 0.2}


def test_cell_resolves_by_name():
    """The three new readers and the seven accepted ones appended for the
    cell; none of the GroupNorm or level readers."""
    spec = core.cell(BENCH, CELL)
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        "fastddpm_dit", "closed_2x64", 1)
    cfg = core.data_file("configs", spec["config"])
    assert core.module("families", cfg["family"]).NUMBER == "rel_rmse"
    assert core.data_file("traffic", spec["traffic"])["loop"] == "closed"
    assert [m["name"] for m in core.cell_metrics(BENCH, CELL, False)] == \
        ["served_slices_per_s", "setup_s"]
    traced = {m["name"] for m in core.cell_metrics(BENCH, CELL, True)}
    assert traced == {"kernel_a_sampler_roofline", "kernel_l_roofline",
                      "mfu.serve", "device.idle_pct.serve",
                      "sampler.attn_pct", "sampler.modulate_pct",
                      "sampler.mlp_pct", "engine.fetch_wait_pct",
                      "sampler.enqueue_ms"}
    for name in traced:
        assert core.reader(name).MOVES == "served_slices_per_s"


def test_configuration_is_dit_xl_8():
    cfg = core.data_file("configs", "fastddpm_dit")
    wd = cfg["widths"]
    assert cfg["reduced"] == [] and cfg["image_size"] == 256
    assert cfg["architecture"] is None
    assert (wd["hidden_size"], wd["depth"], wd["num_heads"], wd["head_dim"],
            wd["patch_size"], wd["mlp_ratio"], wd["mlp_hidden"],
            wd["frequency_embedding_size"], wd["ln_eps"]) == (
        ref.HIDDEN, ref.DEPTH, ref.HEADS, ref.HIDDEN // ref.HEADS, ref.PATCH,
        ref.MLP_RATIO, ref.MLP_RATIO * ref.HIDDEN, ref.FREQ, ref.LN_EPS)
    assert (wd["hidden_size"], wd["depth"], wd["num_heads"],
            wd["patch_size"]) == (dit.HIDDEN, dit.DEPTH, dit.HEADS,
                                  dit.PATCH)
    assert cfg["parameters"] == ref.num_parameters() == 673_995_008
    assert cfg["tokens"] == (256 // 8) ** 2 == 1024
    assert cfg["pos_embed_entries"] == ref.pos_embed(1152, 32).numel()
    assert cfg["serve"]["quant"] == "int8_deep"
    assert cfg["sampler"]["beta_schedule"] == "linear"


def test_counts_reckon_the_published_forward():
    """1,049.7 GFLOP a forward at 256^2 (913.2 in the 112 block linears,
    135.3 in the 28 attention cores, 1.2 in the rest); 112 A sites (28 of
    them fc1's GELU codes) and 57 L sites (56 codes); a slice's ideal time
    under int8_deep 5.99 ms."""
    one = counts_dit.model_ops(steps=1)
    total = sum(ops for _, ops, _, _ in one) / 1e9
    assert total == pytest.approx(1049.7, abs=0.05)
    int8 = sum(ops for _, ops, _, p in one if p == counts.PEAK_INT8_OPS)
    assert int8 / 1e9 == pytest.approx(913.2, abs=0.05)
    cores = sum(ops for n, ops, _, _ in one if n.endswith(".core"))
    assert cores / 1e9 == pytest.approx(135.3, abs=0.05)
    sites = counts_dit.kernel_sites(32)
    assert (len(sites["kernel_a"]), len(sites["kernel_l"])) == (112, 57)
    assert sum(1 for s in sites["kernel_a"] if s[0].endswith("fc1")) == 28
    assert counts.ideal_s(counts_dit.model_ops()) * 1e3 == pytest.approx(
        5.99, abs=0.005)
    # L at batch 32: 113.5 MB a codes launch (x in, codes out, the rows)
    assert sites["kernel_l"][0][2] / 1e6 == pytest.approx(113.5, abs=0.1)


class _Span:
    def __init__(self, key, name, parent, start, device_ms, **ids):
        self.key, self.name, self.parent = key, name, parent
        self.start_ns = int(start * 1e9)
        self.device_ms, self.ids = device_ms, ids


def _read_step_share(monkeypatch, metric, inner):
    """``metric``'s reading of ``inner`` spans in two whole steps (15 % and
    10 % of them; one span outside any step), and None without them."""
    from mrisr_tpu_torch.utils import profiling

    spans = [
        _Span(1, inner, None, 1.05, 9.0),  # no step around it
        _Span(2, "sampler.step", None, 1.20, 20.0),
        _Span(3, "ddpm.attn", 2, 1.21, 8.0),
        _Span(4, inner, 3, 1.22, 2.0),
        _Span(5, inner, 2, 1.23, 1.0),
        _Span(6, "sampler.step", None, 1.30, 10.0),
        _Span(7, inner, 6, 1.31, 1.0),
    ]
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: list(spans))
    ctx = core.Context(cell=CELL, config={"image_size": 256}, traffic={},
                       window=(1.1, 2.0))
    # the steps' shares, 15 % and 10 %: the median
    assert core.reader(metric).read(ctx) == pytest.approx(12.5)
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: spans[1:3])
    assert core.reader(metric).read(ctx) is None


def test_modulate_reader_takes_its_spans_inside_whole_steps(monkeypatch):
    _read_step_share(monkeypatch, "sampler.modulate_pct", "dit.modulate")


def test_mlp_reader_takes_its_spans_inside_whole_steps(monkeypatch):
    _read_step_share(monkeypatch, "sampler.mlp_pct", "dit.mlp")


def test_kernel_l_reader_counts_whole_calls():
    prof = core.Profile(kernels={
        "void (anonymous namespace)::layernorm_modulate_kernel<true, true, "
        "8>(void const*, float const*, long long, float const*, void*, "
        "int, int, double)": [2e-3, 112],
        "void (anonymous namespace)::layernorm_modulate_kernel<true, false, "
        "8>(void const*, float const*, long long, float const*, void*, "
        "int, int, double)": [5e-5, 2]})
    sites = counts_dit.kernel_sites(32)
    ctx = core.Context(cell=CELL, config={}, traffic={}, profile=prof,
                       sites=sites)
    bound = 114 / 57 * sum(counts.bound_s(s) for s in sites["kernel_l"])
    assert core.reader("kernel_l_roofline").read(ctx) == pytest.approx(
        100.0 * bound / 2.05e-3)
    assert core.reader("kernel_l_roofline").read(core.Context(
        cell=CELL, config={}, traffic={}, profile=core.Profile(),
        sites=sites)) is None


@pytest.fixture
def tiny_dit(monkeypatch):
    """The port's DiT at the tiny run's depth, heads and input size."""
    monkeypatch.setattr(dit, "DEPTH", 2)
    monkeypatch.setattr(dit, "HEADS", 4)
    monkeypatch.setattr(dit, "INPUT_SIZE", 32)


def run(fault=None):
    torch.set_num_threads(2)
    return run_cell(BENCH, CELL, 2 ** 31 + 91, 1.5, False,
                    torch.device("cpu"), time.perf_counter(),
                    config_overrides=dict(TINY, check={"sample": 8}),
                    traffic_overrides=TRAFFIC, fault=fault,
                    log=lambda s: None)


def test_sound_run_is_correct(tiny_dit):
    r = run()
    assert r["correct"], r["checks"]
    limit = core.data_file("configs", "fastddpm_dit")["check"]["limit"]
    assert r["failed"] == 0 and r["readings"]["worst_med"] <= limit


@pytest.mark.parametrize("fault", sorted(SERVING))
def test_broken_run_reads_above_the_limit(tiny_dit, fault):
    r = run(SERVING[fault])
    limit = core.data_file("configs", "fastddpm_dit")["check"]["limit"]
    assert not r["correct"], r["checks"]
    assert r["readings"]["worst_med"] > limit
