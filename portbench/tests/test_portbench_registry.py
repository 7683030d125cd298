"""Cells, configurations, traffic mixes and per-layer readers are found by
name: a configuration, a mix, a reader and a cell added as new files and
entries alone, in a copy of the benchmark, run there with no edit to a
file that was already there."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import core

REPO = core.ROOT


def test_every_named_thing_exists():
    bench = core.with_deferred(core.benchmark())
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        cfg = core.data_file("configs", c["name"])
        core.module("families", cfg["family"])
    for w in bench["workloads"]:
        tr = core.data_file("traffic", w["traffic"])
        core.module("loops", tr["loop"])
        assert core.cell_metrics(bench, w["name"], False)
        assert core.cell_metrics(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert core.reader(m["name"]).MOVES == m["moves"]


def test_cell_metrics_follow_workloads_and_moves():
    bench = {"end_to_end": [
        {"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "x", "moves": "rate"},
                      {"name": "y", "moves": "setup_s", "workloads": ["b"]}]}
    assert [m["name"] for m in core.cell_metrics(bench, "a", False)] == \
        ["rate", "setup_s"]
    assert [m["name"] for m in core.cell_metrics(bench, "a", True)] == ["x"]
    assert [m["name"] for m in core.cell_metrics(bench, "b", True)] == ["y"]


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(core.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), copy)
    before = {p: (copy / p).read_bytes() for p in
              [os.path.relpath(os.path.join(b, f), copy)
               for b, _, fs in os.walk(copy) for f in fs]}
    base = json.loads((copy / "portbench/configs/unet_m2.json").read_text())
    base.update(name="unet_tiny", widths=dict(base["widths"],
                                              base_features=4),
                image_size=32, volume={"slices": 12}, check={"sample": 4,
                                                            "limit": 0.5})
    (copy / "portbench/configs/unet_tiny.json").write_text(json.dumps(base))
    (copy / "portbench/traffic/closed_1x8.json").write_text(json.dumps({
        "loop": "closed", "clients": 1, "outstanding": 8, "pool_volumes": 2,
        "engine": {"batch_size": 4, "max_delay_ms": 2}, "settle_s": 0.1,
        "profile_s": 0.2}))
    (copy / "portbench/metrics/engine.batches.py").write_text(textwrap.dedent(
        '''
        """engine: batches dispatched in the window."""
        MOVES = "served_slices_per_s"


        def read(ctx):
            return ctx.engine.get("batches")
        '''))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "unet_tiny.closed", "config":
                               "unet_tiny", "traffic": "closed_1x8",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("unet_tiny.closed")
    bench["per_layer"].append({"name": "engine.batches", "unit": "batches",
                               "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "served_slices_per_s",
                               "workloads": ["unet_tiny.closed"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        if p != "BENCHMARK.json":
            assert (copy / p).read_bytes() == data, p
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(copy)!r}, {REPO!r}]
        import torch
        torch.set_num_threads(2)
        from portbench import core
        from portbench.cell import run_cell
        assert core.HERE.startswith({str(copy)!r})
        bench = core.benchmark()
        for trace in (False, True):
            r = run_cell(bench, "unet_tiny.closed", 21, 1.0, trace,
                         torch.device("cpu"), time.perf_counter(),
                         log=lambda s: None)
            print(json.dumps({{"correct": r["correct"],
                               "metrics": sorted(r["metrics"])}}))
        """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()[-2:]]
    assert lines[0] == {"correct": True,
                        "metrics": ["served_slices_per_s", "setup_s"]}
    assert lines[1]["correct"] and "engine.batches" in lines[1]["metrics"]
