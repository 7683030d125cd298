"""The ``fastddpm_pmub.serve_saturate`` cell: its configuration, family,
traffic and readers resolve by name; its configuration states the
published network; its two readers on hand-made spans; and a whole run on
the CPU at a tiny size (ch 32, 32^2, 2 sampler steps) is correct sound and
not correct with each fault of ``faults.py`` planted, under the cell's own
limit: at that size the int8 gap from the float reference reads 0.018, the
int4 control 0.142 and the faults 1.0-1.45."""

import time

import pytest
import torch

from portbench import core
from portbench.cell import run_cell
from portbench.faults import SERVING
from portbench.reference import fastddpm_pmub as ref

CELL = "fastddpm_pmub.serve_saturate"
BENCH = core.benchmark()
TINY = {"widths": {"base_features": 32, "time_dim": 128}, "image_size": 32,
        "volume": {"slices": 12}, "sampler": {"steps": 2}}
TRAFFIC = {"engine": {"batch_size": 4}, "pool_volumes": 2, "clients": 2,
           "outstanding": 4, "settle_s": 0.1, "profile_s": 0.2}


def test_cell_resolves_by_name():
    spec = core.cell(BENCH, CELL)
    cfg = core.data_file("configs", spec["config"])
    assert core.module("families", cfg["family"]).NUMBER == "rel_rmse"
    assert core.data_file("traffic", spec["traffic"])["loop"] == "closed"
    assert [m["name"] for m in core.cell_metrics(BENCH, CELL, False)] == \
        ["served_slices_per_s", "setup_s"]
    traced = {m["name"] for m in core.cell_metrics(BENCH, CELL, True)}
    assert traced == {"kernel_a_sampler_roofline", "k3_roofline", "mfu.serve",
                      "device.idle_pct.serve", "sampler.attn_pct",
                      "sampler.res256_pct"}
    for name in traced:
        assert core.reader(name).MOVES == "served_slices_per_s"


def test_configuration_is_the_published_network():
    cfg = core.data_file("configs", "fastddpm_pmub")
    wd = cfg["widths"]
    assert cfg["reduced"] == [] and cfg["image_size"] == 256
    assert (wd["base_features"], wd["time_dim"], tuple(wd["ch_mult"]),
            wd["num_res_blocks"], wd["attn_resolutions"], wd["gn_groups"],
            wd["gn_eps"]) == (128, 512, ref.CH_MULT, ref.NUM_RES_BLOCKS,
                              [256 >> ref.ATTN_LEVEL], ref.GROUPS,
                              ref.GN_EPS)
    assert cfg["parameters"] == ref.num_parameters(
        wd["base_features"], wd["time_dim"], wd["in_channels"],
        wd["out_channels"]) == 113_670_913
    assert cfg["serve"]["quant"] == "int8_deep"
    assert cfg["sampler"]["beta_schedule"] == "linear"


class _Span:
    def __init__(self, key, name, parent, start, device_ms, **ids):
        self.key, self.name, self.parent = key, name, parent
        self.start_ns = int(start * 1e9)
        self.device_ms, self.ids = device_ms, ids


def test_readers_take_their_spans_inside_whole_steps(monkeypatch):
    from mrisr_tpu_torch.utils import profiling

    spans = [
        _Span(1, "ddpm.level", None, 1.05, 9.0, res=256),  # before its step
        _Span(2, "sampler.step", None, 1.20, 20.0),
        _Span(3, "ddpm.level", 2, 1.21, 8.0, res=256),
        _Span(4, "ddpm.level", 2, 1.22, 6.0, res=128),
        _Span(5, "ddpm.attn", 4, 1.23, 0.5),
        _Span(6, "ddpm.level", 2, 1.24, 3.0, res=256),
        _Span(7, "sampler.step", None, 1.30, 10.0),
        _Span(8, "ddpm.level", 7, 1.31, 4.0, res=256),
        _Span(9, "ddpm.attn", 7, 1.32, 0.4),
    ]
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: list(spans))
    ctx = core.Context(cell=CELL, config={"image_size": 256}, traffic={},
                       window=(1.1, 2.0))
    # the steps' shares, 55 % and 40 %: the median
    assert core.reader("sampler.res256_pct").read(ctx) == pytest.approx(47.5)
    assert core.reader("sampler.attn_pct").read(ctx) == pytest.approx(3.25)
    monkeypatch.setattr(profiling.RECORDER, "spans", lambda: [])
    assert core.reader("sampler.res256_pct").read(ctx) is None
    assert core.reader("sampler.attn_pct").read(ctx) is None


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
    limit = core.data_file("configs", "fastddpm_pmub")["check"]["limit"]
    assert r["failed"] == 0 and r["readings"]["worst_med"] <= limit


@pytest.mark.parametrize("fault", sorted(SERVING))
def test_broken_run_is_not_correct(fault):
    r = run(SERVING[fault])
    assert not r["correct"], r["checks"]
