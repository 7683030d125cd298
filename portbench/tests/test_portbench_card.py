"""The command itself: without a card it exits with another code than 0 and
prints no result; on the card (marker ``gpu``) one short traced run of a
cell ends correct, with the device's busy time read from the trace."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import core


def command(cwd, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    res = command(core.ROOT, "--workload", "unet_m2.serve_saturate",
                  "--seed", "1", "--seconds", "1", "--trace", "0")
    assert res.returncode == 2 and res.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    res = command(tmp_path, "--workload", "fastddpm.serve_saturate",
                  "--seed", "1", "--seconds", "1", "--trace", "0")
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.gpu
def test_traced_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = command(core.ROOT, "--workload", "unet_m2.serve_saturate",
                  "--seed", "2147483651", "--seconds", "4", "--trace", "1",
                  timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert list(line)[-1] == "check"
    for m in ("kernel_a_roofline", "kernel_b_roofline", "mfu.forward"):
        assert 0 < line["metrics"][m]["value"] <= 100
