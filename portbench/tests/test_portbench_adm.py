"""The ``fastddpm_adm.serve_saturate`` cell: its configuration, family,
traffic and readers resolve by name; its configuration states the
published network; its counts reckon the published forward; its new
reader on hand-made spans; and a whole run on the CPU at a tiny size (ch
32, 32^2, 2 sampler steps) is correct sound and not correct with each
fault of ``faults.py`` planted, under the cell's own limit: at that size
the int8 gap from the float reference reads 0.019, the int4 control 0.157
and the faults 1.00-1.43."""

import time

import pytest
import torch

from portbench import core
from portbench.cell import run_cell
from portbench.faults import SERVING
from portbench.reference import counts, counts_adm
from portbench.reference import fastddpm_adm as ref

CELL = "fastddpm_adm.serve_saturate"
BENCH = core.benchmark()
TINY = {"widths": {"base_features": 32, "time_dim": 128}, "image_size": 32,
        "volume": {"slices": 12}, "sampler": {"steps": 2}}
TRAFFIC = {"engine": {"batch_size": 4}, "pool_volumes": 2, "clients": 2,
           "outstanding": 4, "settle_s": 0.1, "profile_s": 0.2}


def test_cell_resolves_by_name():
    """The new reader and the ten accepted ones appended for the cell."""
    spec = core.cell(BENCH, CELL)
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        "fastddpm_adm", "closed_2x64", 1)
    cfg = core.data_file("configs", spec["config"])
    assert core.module("families", cfg["family"]).NUMBER == "rel_rmse"
    assert core.data_file("traffic", spec["traffic"])["loop"] == "closed"
    assert [m["name"] for m in core.cell_metrics(BENCH, CELL, False)] == \
        ["served_slices_per_s", "setup_s"]
    traced = {m["name"] for m in core.cell_metrics(BENCH, CELL, True)}
    assert traced == {"kernel_a_sampler_roofline", "k3_roofline", "mfu.serve",
                      "device.idle_pct.serve", "sampler.attn_pct",
                      "sampler.res256_pct", "sampler.updown_pct",
                      "engine.fetch_wait_pct", "sampler.enqueue_ms",
                      "sampler.gn_chain_pct"}
    for name in traced:
        assert core.reader(name).MOVES == "served_slices_per_s"


def test_configuration_is_the_published_network():
    cfg = core.data_file("configs", "fastddpm_adm")
    wd = cfg["widths"]
    assert cfg["reduced"] == [] and cfg["image_size"] == 256
    assert cfg["architecture"] is None
    assert (wd["base_features"], wd["time_dim"], tuple(wd["ch_mult"]),
            wd["num_res_blocks"], wd["num_head_channels"], wd["gn_groups"],
            wd["gn_eps"]) == (256, 1024, ref.CH_MULT, ref.NUM_RES_BLOCKS,
                              ref.HEAD_CHANNELS, ref.GROUPS, ref.GN_EPS)
    assert wd["attention_resolutions"] == [256 >> i for i in ref.ATTN_LEVELS]
    assert cfg["parameters"] == ref.num_parameters(
        wd["base_features"], wd["time_dim"], wd["in_channels"],
        wd["out_channels"]) == 552_804_866
    assert cfg["serve"]["quant"] == "int8_deep"
    assert cfg["serve"]["calibration"]["batches"] == 2
    assert cfg["sampler"]["beta_schedule"] == "linear"


def test_counts_reckon_the_published_forward():
    """2,238 GFLOP a forward at 256^2 (1,213 of them at the full-size
    level), 121 int8 convs and 101 GroupNorms, 42 of them scale-shift;
    a slice's ideal time under int8_deep about 17.5 ms."""
    one = counts_adm.model_ops(steps=1)
    assert sum(ops for _, ops, _, _ in one) / 1e9 == pytest.approx(
        2238.4576, abs=1e-3)
    full = sum(ops for name, ops, _, _ in one
               if ref.conv_levels().get(name.split("/", 1)[1]) == 0)
    assert full / 1e9 == pytest.approx(1212.69, abs=0.01)
    sites = counts_adm.kernel_sites(32)
    assert (len(sites["kernel_a"]), len(sites["k3"])) == (121, 101)
    assert sum(1 for *_, post in counts_adm._norms(256) if post) == 42
    assert counts.ideal_s(counts_adm.model_ops()) * 1e3 == pytest.approx(
        17.507, abs=1e-3)


class _Span:
    def __init__(self, key, name, parent, start, device_ms, **ids):
        self.key, self.name, self.parent = key, name, parent
        self.start_ns = int(start * 1e9)
        self.device_ms, self.ids = device_ms, ids


def test_updown_reader_takes_its_spans_inside_whole_steps(monkeypatch):
    from mrisr_tpu_torch.utils import profiling

    spans = [
        _Span(1, "ddpm.updown", None, 1.05, 9.0, dir="down"),  # no step
        _Span(2, "sampler.step", None, 1.20, 20.0),
        _Span(3, "ddpm.level", 2, 1.21, 8.0, res=128),
        _Span(4, "ddpm.updown", 3, 1.22, 2.0, dir="down"),
        _Span(5, "ddpm.updown", 2, 1.23, 1.0, dir="up"),
        _Span(6, "sampler.step", None, 1.30, 10.0),
        _Span(7, "ddpm.updown", 6, 1.31, 1.0, dir="up"),
    ]
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: list(spans))
    ctx = core.Context(cell=CELL, config={"image_size": 256}, traffic={},
                       window=(1.1, 2.0))
    # the steps' shares, 15 % and 10 %: the median
    assert core.reader("sampler.updown_pct").read(ctx) == pytest.approx(12.5)
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: [])
    assert core.reader("sampler.updown_pct").read(ctx) is None


def run(fault=None):
    torch.set_num_threads(2)
    return run_cell(BENCH, CELL, 2 ** 31 + 77, 1.5, False,
                    torch.device("cpu"), time.perf_counter(),
                    config_overrides=dict(TINY, check={"sample": 8}),
                    traffic_overrides=TRAFFIC, fault=fault,
                    log=lambda s: None)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    limit = core.data_file("configs", "fastddpm_adm")["check"]["limit"]
    assert r["failed"] == 0 and r["readings"]["worst_med"] <= limit


@pytest.mark.parametrize("fault", sorted(SERVING))
def test_broken_run_reads_above_the_limit(fault):
    r = run(SERVING[fault])
    limit = core.data_file("configs", "fastddpm_adm")["check"]["limit"]
    assert not r["correct"], r["checks"]
    assert r["readings"]["worst_med"] > limit
