"""A whole run of each cell, past the look for a card, on the CPU at a
tiny size: sound, it is correct; with the timed path broken underneath
the check against the reference says it is not.  Serving: half of each
batch left out, or each answer altered where it is produced.  Training:
half of each batch left out (the mean over the rest), or a step that
returns its state unchanged.

At FEAT = 4 and 32^2 the int8 forward's own error against the float
reference is larger than at the published widths, so these runs hold it
to a limit of their own (``TINY_LIMIT``) between the sound and the broken
readings; the cells' limits are set on the card (PERF.md)."""

import time

import pytest
import torch

from portbench import core
from portbench.cell import run_cell
from portbench.faults import SERVING, TRAINING

TINY = {"widths": {"base_features": 4}, "image_size": 32,
        "volume": {"slices": 12}}
TRAFFIC = {"engine": {"batch_size": 4}, "pool_volumes": 2, "clients": 2,
           "outstanding": 4, "settle_s": 0.1, "profile_s": 0.2,
           "volumes_per_s": 6}
TINY_LIMIT = {"unet_m2": 0.3, "fastddpm": 0.02}
# bf16 against float32 at FEAT = 4, 32^2 read a median first gradient
# gap of 0.03 and a median change of 0.018
TINY_TRAIN = {"limits": {"grad_median": 0.1, "change_median": 0.1},
              "loader_rows": 1e-3}
CELLS = ("unet_m2.serve_saturate", "fastddpm.serve_saturate",
         "unet_m2.serve_volumes")
BENCH = core.with_deferred(core.benchmark())


def run(name, fault=None):
    spec = core.cell(BENCH, name)
    cfg = dict(TINY, check={"sample": 8,
                            "limit": TINY_LIMIT[spec["config"]]},
               train_check=TINY_TRAIN)
    torch.set_num_threads(2)
    return run_cell(BENCH, name, 2 ** 31 + 77, 1.5, False,
                    torch.device("cpu"), time.perf_counter(),
                    config_overrides=cfg, traffic_overrides=TRAFFIC,
                    fault=fault, log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["readings"]["worst_med"] <= \
        TINY_LIMIT[core.cell(BENCH, name)["config"]]


@pytest.mark.parametrize("fault", sorted(SERVING))
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault):
    r = run(name, SERVING[fault])
    assert not r["correct"], r["checks"]


def test_sound_training_run_is_correct():
    r = run("unet_m2.train_bf16")
    assert r["correct"], r["checks"]
    assert r["metrics"]["train_slices_per_s"][0] > 0


@pytest.mark.parametrize("fault", sorted(TRAINING))
def test_broken_training_run_is_not_correct(fault):
    r = run("unet_m2.train_bf16", TRAINING[fault])
    assert not r["correct"], r["checks"]
