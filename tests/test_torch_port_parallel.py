"""Data-parallel training in the port against JAX's mesh and against the
port's own single process (CPU, gloo, FEAT 4, 16^2-32^2).

One pair of ranks (``tests/torch_port_dp_worker.py``) runs every case for
the whole module: the supervised, GAN, progressive, diffusion and distill
steps on their rows of the global batches, the collectives, the sharded
loader, the CLI's mesh rules at world size 2, and ``cli train --mesh-data
2`` as torchrun starts it (the process group from the environment).  The
same steps run unmeshed here on the same global batches.  JAX's numbers
come from its 8-device CPU mesh (``tests/test_distributed.py``)."""

import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu.parallel import mesh as jax_mesh
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.ckpt.fold_bn import fold_unet_batchnorm
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.data.volumes import VolumeStore
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.parallel import (
    MeshSpec,
    make_mesh,
    param_shardings,
    shard_batch,
)
from mrisr_tpu_torch.serve.quant import calibrate_unet, quantize_unet
from torch_port_dp_worker import CASES, run_case
from torch_port_util import jax_unet_variables, noise, port_unet

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FEAT, HW, GAN_HW, BATCH, WORLD = 4, 16, 32, 16, 2
CLI_RUNS = {"cli_host": [], "cli_scan": ["--backend", "device",
                                         "--scan-epochs"]}


def _free_ports(n):
    """``n`` distinct ports that bind now, drawn below the kernel's
    ephemeral range.  The ranks bind them up to minutes later (the CLI
    runs come last); a port of that range may meanwhile be handed to any
    connection or ``bind(0)`` on the host, gloo's among them, and the
    rank that then cannot bind it leaves the others waiting."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()  # the OS's entropy, not a test's seed
    ports = []
    while len(ports) < n:
        port = rng.randrange(10000, max(low, 20000))
        if port in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        ports.append(port)
    return ports


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results, the single-process results of the same steps
    and CLI runs, and the inputs."""
    work = tmp_path_factory.mktemp("dp")
    v = jax_unet_variables(FEAT, HW, seed=0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        diff_sd = FastDDPMUNet(base_features=FEAT, time_dim=8).state_dict()
    teacher = fold_unet_batchnorm(port_unet(
        jax_unet_variables(FEAT, HW, seed=3), FEAT))
    calib = [_t(noise((4, HW, HW, 2), seed=40))]
    store = str(work / "store")
    make_synthetic_store(store, num_patients=8, slices_per_volume=8,
                         height=HW, width=HW)
    inputs = {
        "supervised": {"state_dict": unet_state_dict_from_flax(v),
                       "batches": [_t(noise((BATCH, HW, HW, 3), seed=s))
                                   for s in (1, 2)]},
        "gan": {"batches": [_t(noise((BATCH, GAN_HW, GAN_HW, 3), seed=s))
                            for s in (3, 4)]},
        "progressive": {"batches": [_t(noise((BATCH, HW, HW, 5), seed=s))
                                    for s in (5, 6)]},
        "diffusion": {"state_dict": diff_sd,
                      "batches": [_t(noise((BATCH, HW, HW, 3), seed=s))
                                  for s in (7, 8)]},
        "distill": {"qparams": quantize_unet(teacher, calibrate_unet(
            teacher, calib)), "batches": [
                _t(noise((BATCH, HW, HW, 3), seed=s)) for s in (9, 10)]},
        "store": store,
        "cli_common": ["train", "--preset", "unet", "--data", store,
                       "--device", "cpu", "--features", str(FEAT),
                       "--image-size", str(HW), "--batch-size", "4",
                       "--epochs", "2"],
        "cli": CLI_RUNS,
    }
    in_path = str(work / "inputs.pt")
    torch.save(inputs, in_path)
    out_dir = work / "out"
    out_dir.mkdir()
    port, *cli_ports = _free_ports(1 + len(CLI_RUNS))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_port_dp_worker.py"),
         str(r), str(WORLD), str(port), ",".join(map(str, cli_ports)),
         in_path, str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    single = {name: run_case(name, inputs) for name in CASES}
    for key, extra in CLI_RUNS.items():
        tr = cli.main([*inputs["cli_common"], "--checkpoint-dir",
                       str(work / f"single_{key}_models"), "--results-dir",
                       str(work / f"single_{key}_results"), *extra])
        single[key] = {k: list(s) for k, s in tr.history.series.items()}
    return {"ranks": ranks, "single": single, "inputs": inputs,
            "out": out_dir, "logs": logs, "variables": v}


def test_dp_supervised_step_matches_jax_mesh(dp):
    """The 2-rank supervised step (batch 16, 8 rows a rank) against the
    JAX package's step on its 8-device mesh, the same weights and global
    batch (``tests/test_distributed.py:70-111``): the loss within rel 1e-5,
    every gradient within atol 2e-5, the JAX test's own bounds."""
    v = dp["variables"]
    model = JaxUNet(features=FEAT)
    batch_np = dp["inputs"]["supervised"]["batches"][0].numpy()

    def loss_and_grads(params, stats, batch):
        inputs, target = batch[..., :2], batch[..., 2:3]

        def loss_fn(p):
            pred, _ = model.apply({"params": p, "batch_stats": stats},
                                  inputs, train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.square(pred - target))

        return jax.value_and_grad(loss_fn)(params)

    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=8, model=1))
    params = jax.device_put(v["params"], jax_mesh.replicated(mesh))
    stats = jax.device_put(v["batch_stats"], jax_mesh.replicated(mesh))
    batch = jax.device_put(jnp.asarray(batch_np),
                           jax_mesh.batch_sharding(mesh))
    with mesh:
        loss, grads = jax.jit(loss_and_grads)(params, stats, batch)
    want = unet_state_dict_from_flax({
        "params": jax.tree.map(np.asarray, grads),
        "batch_stats": v["batch_stats"]})
    for r in dp["ranks"]:
        got = r["supervised"]
        assert got["train"][0]["loss"] == pytest.approx(float(loss),
                                                        rel=1e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       atol=2e-5, err_msg=name)


# (train-metric rel, abs), gradient atol: the JAX DP tests' bounds
# (tests/test_distributed.py: two-step GAN and progressive 1e-3/1e-6,
# diffusion 1e-5, supervised 1e-5 and 2e-5)
BOUNDS = {"supervised": (1e-5, 0.0, 2e-5), "gan": (1e-3, 1e-6, None),
          "progressive": (1e-3, 1e-6, None),
          "diffusion": (1e-5, 0.0, 2e-5), "distill": (1e-5, 0.0, 2e-5)}


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_single_process(dp, case):
    """Each family's DP steps (two, the second after both ranks' optimizer
    updates) against the same steps unmeshed on the global batch: the
    train and eval metrics, the first step's gradients and BatchNorm
    running statistics (cross-rank, biased update) within 1e-6; both ranks
    hold the same numbers (for distill, the parameter average too)."""
    rel, abs_, grad_atol = BOUNDS[case]
    want = dp["single"][case]
    r0, r1 = (r[case] for r in dp["ranks"])
    assert r0["train"] == r1["train"] and r0["eval"] == r1["eval"]
    for got_steps, want_steps in ((r0["train"], want["train"]),
                                  (r0["eval"], want["eval"])):
        assert len(got_steps) == len(want_steps)
        for g, w in zip(got_steps, want_steps):
            assert set(g) == set(w)
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=rel, abs=abs_), k
    if grad_atol is not None:
        for name, g in want["grads"].items():
            np.testing.assert_allclose(r0["grads"][name].numpy(), g.numpy(),
                                       atol=grad_atol, err_msg=name)
            assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    for name, s in want.get("stats", {}).items():
        np.testing.assert_allclose(r0["stats"][name].numpy(), s.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        assert torch.equal(r0["stats"][name], r1["stats"][name]), name
    if case == "distill":
        assert all(torch.equal(e, r1["ema"][k]) for k, e in r0["ema"].items())


def test_distributed_init_two_processes(dp):
    """``distributed_init`` for real (``tests/test_distributed.py:
    420-463``): each rank adds (rank + 1) over a (1, 4) block, both see
    12.0; ``host_shard_patients`` takes the rank and world size from the
    group, disjoint shards covering the split; ``psum_mean``; the gathered
    batch in rank order, whose backward sums the cotangents over ranks."""
    res = [r["collectives"] for r in dp["ranks"]]
    assert [c["sum"] for c in res] == [12.0, 12.0]
    assert [c["mean"] for c in res] == [0.5, 0.5]
    assert [c["rank"] for c in res] == [0, 1]
    assert all(c["mesh"] == {"data": 2, "model": 1} for c in res)
    flat = [p for c in res for p in c["shard"]]
    assert sorted(flat) == [f"p{i}" for i in range(5)]
    assert len(set(flat)) == len(flat)
    coef = np.arange(8, dtype=np.float32).reshape(4, 2)
    for r, c in enumerate(res):
        np.testing.assert_array_equal(c["gathered"], coef)
        np.testing.assert_array_equal(c["gather_grad"],
                                      2 * coef[2 * r:2 * r + 2])


def test_dp_loader_yields_rank_rows(dp):
    """Every rank builds the same shuffled, augmented train loader and
    yields its rows of each global batch: the ranks' rows together are the
    unsharded loader's batches, augmentation draws included."""
    from mrisr_tpu_torch.config import DataConfig

    store = dp["inputs"]["store"]
    cfg = DataConfig(root=store, batch_size=4, image_size=(HW, HW),
                     augment=True, prefetch=0)
    loader = build_loader(VolumeStore.open(store), "train", cfg,
                          device="cpu")
    want = [b.numpy() for b, _ in zip(loader, range(3))]
    r0, r1 = (r["loader"] for r in dp["ranks"])
    for w, a, b in zip(want, r0, r1):
        assert a.shape == (2, HW, HW, 3)
        np.testing.assert_array_equal(np.concatenate([a, b]), w)


@pytest.mark.parametrize("key", sorted(CLI_RUNS))
def test_dp_cli_train_matches_single_process(dp, key):
    """``cli train --mesh-data 2`` as torchrun starts it (the process
    group formed from MASTER_ADDR/PORT, WORLD_SIZE, RANK), with the host
    loader and with ``--scan-epochs``: two epochs' train and val losses
    within rel 2e-3 of the single-process run (the JAX DP fit test's
    bound, ``tests/test_distributed.py:217``), the same on both ranks;
    the first rank wrote the checkpoints and the history."""
    want = dp["single"][key]
    h0, h1 = (r[key] for r in dp["ranks"])
    for series in ("train_loss", "val_loss"):
        assert h0[series] == h1[series]
    for series in ("train_loss", "val_loss"):
        np.testing.assert_allclose(h0[series], want[series], rtol=2e-3,
                                   err_msg=series)
    models = dp["out"] / f"{key}_models"
    assert sorted(os.listdir(models)) == [
        f"unet_{s}.pt" for s in ("best", "epoch_1", "epoch_2", "latest")]
    hist = json.loads((dp["out"] / f"{key}_results" /
                       "unet_history.json").read_text())
    np.testing.assert_allclose(hist["train_loss"], h0["train_loss"])
    assert "training mesh: {'data': 2, 'model': 1}" in dp["logs"][0]
    assert "training mesh" not in dp["logs"][1]


def test_dp_training_mesh_rules(dp):
    """The CLI's ``_training_mesh`` at world size 2 (the JAX CLI's rules
    with ranks for devices, ``tests/test_distributed.py:234-340``): an
    explicit mesh is honored or refused with JAX's messages, the default
    shrinks to gcd(batch, world) with JAX's note."""
    rules = dp["ranks"][0]["rules"]
    assert rules["explicit 2"][:2] == ("mesh", {"data": 2, "model": 1})
    assert rules["too many"][0] == "exit"
    assert "requests 4 devices but only 2 are visible" in rules["too many"][1]
    assert rules["indivisible"][0] == "exit"
    assert "not divisible" in rules["indivisible"][1]
    assert rules["auto"][:2] == ("mesh", {"data": 2, "model": 1})
    assert rules["auto shrunk"][:2] == ("mesh", None)
    assert "data axis shrunk to 1 of 2 devices" in rules["auto shrunk"][2]
    assert rules["make_mesh 1x1 over 2"][1] == "mesh 1x1 != 2 devices"
    assert dp["ranks"][1]["rules"]["auto shrunk"][2] == ""  # rank 0 notes


@pytest.mark.parametrize("spec,n,exc", [
    (dict(data=-1, model=-1), 8, ValueError),
    (dict(data=-1, model=2), 3, AssertionError),
    (dict(data=2, model=1), 3, AssertionError),
])
def test_make_mesh_errors_match_jax(spec, n, exc):
    """``make_mesh``'s refusals with the JAX package's types and messages
    (its mesh over the first n of 8 CPU devices, the port's over n
    ranks)."""
    with pytest.raises(exc) as want:
        jax_mesh.make_mesh(jax_mesh.MeshSpec(**spec),
                           devices=jax.devices()[:n])
    with pytest.raises(exc) as got:
        make_mesh(MeshSpec(**spec), devices=list(range(n)), device="cpu")
    assert str(got.value) == str(want.value)


def test_mesh_single_rank_and_tensor_parallel_refusal():
    """One process: the default mesh is one rank (every collective a
    no-op), ranks beyond the group raise.  A 'model' axis > 1 is taken
    (``tests/test_torch_port_tp.py`` runs it on four ranks): a 2 x 2 mesh
    over ranks the group lacks raises as a 2 x 1 one does, and
    ``param_shardings`` shards by JAX's rule; the CLI refuses
    ``--mesh-model 2`` on one rank with the JAX CLI's message (training or
    not)."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.first and mesh.model_rank == 0
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(shard_batch(x, mesh), x)
    assert set(param_shardings(torch.nn.Linear(2, 2), mesh).values()) == {
        "replicated"}
    with pytest.raises(ValueError, match="not all among"):
        make_mesh(devices=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="not all among"):
        make_mesh(MeshSpec(data=2, model=2), devices=[0, 1, 2, 3],
                  device="cpu")
    mesh.model = 2
    assert param_shardings(torch.nn.Linear(2, 2), mesh, min_size=4) == {
        "weight": ("model", 0), "bias": "replicated"}
    assert set(param_shardings(torch.nn.Linear(2, 2), mesh).values()) == {
        "replicated"}
    for command in ("train", "eval"):
        with pytest.raises(SystemExit, match="requests 1x2 devices but "
                                             "only 1 is visible"):
            cli.main([command, "--data", "d", "--device", "cpu",
                      "--mesh-model", "2",
                      *(("--preset", "unet") if command == "train"
                        else ("--model", "unet"))])


def test_cli_explicit_mesh_needs_ranks(tmp_path):
    """An explicit ``--mesh-data 2`` with one rank refuses with the JAX
    CLI's message (``mrisr_tpu/cli.py:_training_mesh``), for train and
    distill, and for the commands that ignore the flag."""
    common = ["--data", str(tmp_path), "--device", "cpu", "--mesh-data", "2"]
    for argv in (["train", "--preset", "unet"], ["distill"],
                 ["eval", "--model", "unet"]):
        with pytest.raises(SystemExit,
                           match="requests 2x1 devices but only 1 is "
                                 "visible"):
            cli.main([*argv, *common])


def test_sharded_partial_batch_raises_as_jax(tmp_path):
    """A sharded loader's partial last batch that does not divide over
    the data axis: JAX's ``device_put`` onto the batch sharding raises,
    and so does the port (the CLI shards only the wrap-padded train
    loader, as the JAX CLI does)."""
    from mrisr_tpu.config import DataConfig as JaxDataConfig
    from mrisr_tpu.data.pipeline import build_loader as jax_build_loader
    from mrisr_tpu.data.volumes import VolumeStore as JaxVolumeStore
    from mrisr_tpu_torch.config import DataConfig
    from mrisr_tpu_torch.parallel.mesh import Mesh, batch_sharding

    store = str(tmp_path / "s")
    make_synthetic_store(store, num_patients=8, slices_per_volume=7,
                         height=HW, width=HW)
    jcfg = JaxDataConfig(batch_size=8, image_size=(HW, HW), distance_filter=2)
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=8, model=1))
    jl = jax_build_loader(JaxVolumeStore.open(store), "val", jcfg,
                          sharding=jax_mesh.batch_sharding(jmesh))
    n = jl.num_samples
    assert n % 8 and n % 2  # a partial last batch that divides by neither
    with pytest.raises(ValueError):
        list(jl)
    mesh = Mesh(ranks=[0, 1], rank=0, device=torch.device("cpu"))
    pl = build_loader(VolumeStore.open(store), "val",
                      DataConfig(batch_size=8, image_size=(HW, HW),
                                 distance_filter=2),
                      device="cpu", sharding=batch_sharding(mesh))
    with pytest.raises(ValueError, match="not divisible"):
        list(pl)
