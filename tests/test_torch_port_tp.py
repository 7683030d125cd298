"""The 'model' mesh axis in the port against JAX's (CPU, gloo, FEAT 4-8,
16^2-32^2).

- ``param_shardings`` picks the tensors JAX's rule picks, on their output
  dims, for the five families (no process group needed);
- four ranks (``tests/torch_port_tp_worker.py``, started once for the
  module) run each family's forward under ``shard_module`` on a 1 x 2 and a
  2 x 2 mesh, held against the port's unsharded forward and (the UNet and
  the Fast-DDPM) JAX's forward on its 4 x 2 virtual mesh
  (``tests/test_distributed.py:112-139``);
- the CLI's mesh rules at world size 4 against the JAX CLI's at 4 visible
  devices, and ``train``/``distill --mesh-data 2 --mesh-model 2`` as
  torchrun starts them against the same commands at ``--mesh-data 2`` and
  against the JAX CLI's 2 x 2 run;
- the one-rank refusals against the JAX CLI's with one visible device.
"""

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

from mrisr_tpu import cli as jax_cli
from mrisr_tpu.config import Config as JaxConfig
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu.parallel import mesh as jax_mesh
from mrisr_tpu_torch import cli
from mrisr_tpu_torch.ckpt import from_jax
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.models.registry import create_model, init_model
from mrisr_tpu_torch.parallel.mesh import Mesh, param_shardings
from torch_port_tp_worker import MIN_SIZE, build, forward
from torch_port_util import (
    flax_unet_variables,
    jax_seeded_variables,
    noise,
    rel_l2,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FEAT, HW, BATCH, WORLD = 8, 32, 8, 4
CLI_FEAT, CLI_HW = 4, 16
CONVERTERS = {"unet": from_jax.unet_state_dict_from_flax,
              "fastddpm": from_jax.fastddpm_state_dict_from_flax,
              "deepcnn": from_jax.deepcnn_state_dict_from_flax,
              "progressive_unet": from_jax.progressive_state_dict_from_flax,
              "patchgan": from_jax.patchgan_state_dict_from_flax}
FAMILIES = tuple(CONVERTERS)
# the families also run under JAX's 4 x 2 mesh (the others against the
# port's unsharded forward, which the family tests hold to JAX's)
JAX_SHARDED = ("unet", "fastddpm")
# (label, --mesh-data, --mesh-model, batch) at world size 4
RULES = (("explicit 2x2", 2, 2, 4), ("explicit 1x2", 1, 2, 4),
         ("model only", -1, 2, 4), ("model only 3", -1, 3, 4),
         ("too many", 2, 4, 4), ("indivisible", 2, 2, 3), ("auto", -1, 1, 4))
# sharded forward against unsharded (both the port's, float32 on the CPU):
# the same sums, blocked by another C_out; against JAX's sharded forward:
# the port's forward-parity bound (tests/test_torch_port_unet.py), and rel
# 1e-5 for DeepCNN's outputs in the hundreds (seeded BatchNorm statistics)
SHARDED_RTOL, SHARDED_ATOL = 1e-6, 1e-5
JAX_RTOL, JAX_ATOL = 1e-5, 1e-4


def _inputs(name, hw, batch, seed):
    """A family's forward inputs as numpy (x; and t for the Fast-DDPM)."""
    channels = {"progressive_unet": 5, "patchgan": 3, "fastddpm": 3}
    x = noise((batch, hw, hw, channels.get(name, 2)), seed=seed)
    if name == "fastddpm":
        return [x, (np.arange(batch, dtype=np.int32) * 111 + 7) % 1000]
    return [x]


def _jax_apply(model, name, variables, *inputs):
    if name == "fastddpm":
        return model.apply(variables, *inputs)
    return model.apply(variables, *inputs, train=False)


def _jax_model(name, feat):
    return jax_create_model(name, JaxModelConfig(name=name,
                                                 base_features=feat))[0]


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


# ------------------------------------------------- param_shardings parity


@pytest.mark.parametrize("min_size", [1024, None])
@pytest.mark.parametrize("name", FAMILIES)
def test_param_shardings_match_jax(name, min_size):
    """The tensors the port shards on a 'model' axis of 2 are the ones
    JAX's ``param_shardings`` shards on its 4 x 2 mesh, on their output
    dims, with ``min_size=1024`` at FEAT 8 and at the default size at full
    width (the Progressive UNet at half width).  The map between the trees
    is the weight carry itself: each flax leaf JAX shards is filled with
    1 + its index along the trailing (output) dim, every other leaf with
    0; after ``ckpt/from_jax.py`` a port tensor the port shards must hold
    exactly that ramp along the dim it names, and every other tensor 0."""
    feat = FEAT if min_size else (32 if name == "progressive_unet" else 64)
    kw = {"min_size": min_size} if min_size else {}
    model = _jax_model(name, feat)
    shapes = jax.eval_shape(
        lambda *a: (model.init(jax.random.PRNGKey(0), *a)
                    if name == "fastddpm" else
                    model.init(jax.random.PRNGKey(0), *a, train=False)),
        *(jnp.asarray(a) for a in _inputs(name, 32, 1, 0)))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=4, model=2))
    specs = jax_mesh.param_shardings(shapes["params"], jmesh, **kw)

    def fill(leaf, sharding):
        if sharding.spec and sharding.spec[-1] == "model":
            return np.broadcast_to(
                1 + np.arange(leaf.shape[-1], dtype=np.float32), leaf.shape)
        return np.zeros(leaf.shape, np.float32)

    params = jax.tree.map(fill, shapes["params"], specs)
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes.get("batch_stats", {}))
    carried = CONVERTERS[name]({"params": params, "batch_stats": stats})
    module = create_model(name, ModelConfig(name=name, base_features=feat))
    mine = param_shardings(module, Mesh(ranks=[0], rank=0, model=2), **kw)
    assert set(mine) == {n for n, _ in module.named_parameters()}
    n_jax = sum(1 for s in jax.tree_util.tree_leaves(specs)
                if s.spec and s.spec[-1] == "model")
    sharded = {n: p for n, p in mine.items() if p != "replicated"}
    assert len(sharded) == n_jax > 0
    for n, place in mine.items():
        t = carried[n]
        if place == "replicated":
            assert not t.any(), n
            continue
        axis, dim = place
        ramp = 1 + torch.arange(t.shape[dim], dtype=torch.float32)
        view = [1] * t.ndim
        view[dim] = -1
        assert axis == "model" and torch.equal(
            t, ramp.view(view).expand_as(t)), n
    if not min_size and name in ("unet", "fastddpm"):
        # the full-width counts: 18 of the M2 UNet's tensors, 19 of the
        # Fast-DDPM's
        held = {"unet": (18, 30_916_608), "fastddpm": (19, 13_537_280)}
        size = dict(module.named_parameters())
        assert (len(sharded), sum(size[n].numel() for n in sharded)
                ) == held[name]


# ------------------------------------------------------- four-rank fixture


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every rank's results, the same forwards unsharded and under JAX's
    4 x 2 mesh, and the JAX CLI's 2 x 2 training run (the JAX side runs
    while the ranks do)."""
    work = tmp_path_factory.mktemp("tp")
    families, variables = {}, {}
    for seed, name in enumerate(FAMILIES):
        ins = _inputs(name, HW, BATCH, seed=10 + seed)
        init_ins = [jnp.asarray(a[:1]) for a in ins]
        variables[name] = jax_seeded_variables(
            _jax_model(name, FEAT), *init_ins, seed=seed,
            **({} if name == "fastddpm" else {"train": False}))
        families[name] = {
            "feat": FEAT, "state_dict": CONVERTERS[name](variables[name]),
            "inputs": [torch.from_numpy(np.ascontiguousarray(a)) for a in ins]}
    store = str(work / "store")
    make_synthetic_store(store, num_patients=8, slices_per_volume=8,
                         height=CLI_HW, width=CLI_HW)
    # the unet preset without augmentation (the two packages draw their
    # augmentations from different generators), in the config JSON both
    # CLIs read
    config = work / "unet.json"
    config.write_text(jax_cli_preset_json())
    teachers = work / "teachers"
    teachers.mkdir()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        torch.save(reference_checkpoint(create_model("unet", ModelConfig(
            base_features=CLI_FEAT)), "unet"), teachers / "unet_best.pt")
    common = ["--data", store, "--device", "cpu", "--image-size",
              str(CLI_HW), "--batch-size", "4"]
    train = ["train", "--preset", "unet", "--config", str(config),
             "--features", str(CLI_FEAT), "--epochs", "2", *common]
    distill = ["distill", "--teacher", "unet", "--teacher-features",
               str(CLI_FEAT), "--teacher-dir", str(teachers),
               "--teacher-quant", "none", "--features", "2", "--epochs", "1",
               *common]
    cli_runs = {
        "train_2x2": [*train, "--mesh-data", "2", "--mesh-model", "2"],
        "train_model_only": [*train, "--mesh-model", "2"],
        "train_2": [*train, "--mesh-data", "2"],
        "distill_2x2": [*distill, "--mesh-data", "2", "--mesh-model", "2"],
        "distill_2": [*distill, "--mesh-data", "2"]}
    in_path = str(work / "inputs.pt")
    torch.save({"families": families, "rules": RULES, "cli": cli_runs},
               in_path)
    out_dir = work / "out"
    out_dir.mkdir()
    port, *cli_ports = _free_ports(1 + len(cli_runs))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_port_tp_worker.py"),
         str(r), str(WORLD), str(port), ",".join(map(str, cli_ports)),
         in_path, str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        jax_sharded = {name: jax_sharded_forward(name, variables[name],
                                                 families[name]["inputs"])
                       for name in JAX_SHARDED}
        jax_hist = jax_cli_run(work, store, config)
        unsharded = {name: forward(name, build(name, FEAT, spec[
            "state_dict"]), spec["inputs"]) for name, spec in families.items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "families": families, "unsharded": unsharded,
            "jax": jax_sharded, "out": out_dir, "jax_cli": jax_hist}


def jax_sharded_forward(name, variables, inputs):
    """JAX's eval forward with the kernels of at least ``MIN_SIZE``
    elements sharded on 'model' of its 4 x 2 mesh and the batch on 'data'
    (``tests/test_distributed.py:112-139``), as numpy."""
    model = _jax_model(name, FEAT)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(data=4, model=2))
    params = jax.device_put(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax_mesh.param_shardings(variables["params"], mesh,
                                 min_size=MIN_SIZE))
    rest = jax.device_put({k: jax.tree.map(jnp.asarray, t)
                           for k, t in variables.items() if k != "params"},
                          jax_mesh.replicated(mesh))
    xs = [jax.device_put(jnp.asarray(a.numpy()),
                         jax_mesh.batch_sharding(mesh)) for a in inputs]
    with mesh:
        y = jax.jit(lambda p, r, *x: _jax_apply(
            model, name, {"params": p, **r}, *x))(params, rest, *xs)
    return jax.tree.map(np.asarray, y)


def jax_cli_preset_json() -> str:
    """The JAX unet preset with augmentation off, as JSON."""
    import dataclasses

    from mrisr_tpu.config import PRESETS

    base = PRESETS["unet"]
    return base.replace(data=dataclasses.replace(
        base.data, augment=False)).to_json()


def jax_cli_run(work, store, config):
    """The JAX CLI's ``train --mesh-data 2 --mesh-model 2`` (4 of its 8
    CPU devices), starting from the port's ``init_model`` weights carried
    to flax (its own eager flax init takes half a minute on the CPU)."""
    import mrisr_tpu.train.trainer as jax_trainer_module

    init = flax_unet_variables(init_model("unet", ModelConfig(
        base_features=CLI_FEAT), seed=0)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "init_model", lambda name, mcfg, **kw: (
            jax_create_model(name, mcfg)[0], jax.tree.map(jnp.asarray, init),
            "pair"))
        jax_cli.main(["train", "--preset", "unet", "--config", str(config),
                      "--data", store, "--features", str(CLI_FEAT),
                      "--image-size", str(CLI_HW), "--batch-size", "4",
                      "--epochs", "2", "--mesh-data", "2", "--mesh-model",
                      "2", "--checkpoint-dir", str(work / "jax_models"),
                      "--results-dir", str(work / "jax_results")])
    return json.loads((work / "jax_results" /
                       "unet_history.json").read_text())


# ----------------------------------------------------------- the forwards


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_forward_matches_unsharded_and_jax(tp, name):
    """Each family's eval forward with its large kernels split on their
    output channels (``min_size=1024``), on 2 ranks (1 x 2) and on 4 (2 x
    2, each data coordinate on half the batch): every rank gathers the
    same output, within atol 1e-5 of the unsharded port forward and, for
    the UNet and the Fast-DDPM, 1e-4 of JAX's forward on its 4 x 2 mesh.
    Each rank holds the replicated parameters and half of each sharded
    one."""
    spec = tp["families"][name]
    want = tp["unsharded"][name]
    want = want if isinstance(want, tuple) else (want,)
    jax_y = tp["jax"].get(name)
    jax_y = (() if jax_y is None else
             jax_y if isinstance(jax_y, (tuple, list)) else (jax_y,))
    for w, j in zip(want, jax_y):
        np.testing.assert_allclose(w.numpy(), j, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
    module = create_model(name, ModelConfig(name=name, base_features=FEAT))
    places = param_shardings(module, Mesh(ranks=[0], rank=0, model=2),
                             MIN_SIZE)
    sizes = {n: p.numel() for n, p in module.named_parameters()}
    # a sharded layer's bias goes with its weight
    halved = {n for n, p in places.items() if p != "replicated"} | {
        n[:-len("weight")] + "bias" for n, p in places.items()
        if p != "replicated"}
    held = sum(s // 2 if n in halved else s for n, s in sizes.items())
    assert held < sum(sizes.values())
    for label, members in (("1x2", (0, 1)), ("2x2", (0, 1, 2, 3))):
        key = (name, label)
        outs = [tp["ranks"][r]["forward"][key] for r in members]
        assert all(key not in tp["ranks"][r]["forward"]
                   for r in range(WORLD) if r not in members)
        first = outs[0]["y"]
        first = first if isinstance(first, tuple) else (first,)
        for o in outs:
            got = o["y"] if isinstance(o["y"], tuple) else (o["y"],)
            assert o["held"] == held
            for g, f, w in zip(got, first, want):
                assert torch.equal(g, f), key
                np.testing.assert_allclose(
                    g.numpy(), w.numpy(), rtol=SHARDED_RTOL,
                    atol=SHARDED_ATOL, err_msg=str(key))
                assert rel_l2(g.numpy(), w.numpy()) < 1e-6, key
            for g, j in zip(got, jax_y):
                np.testing.assert_allclose(
                    g.numpy(), j, rtol=JAX_RTOL, atol=JAX_ATOL,
                    err_msg=str(key))


def test_mesh_layout(tp):
    """JAX's ``reshape(data, model)``: rank r at data coordinate r // 2 and
    model coordinate r % 2 of the 2 x 2 mesh, its data group the ranks of
    its model coordinate, its model group those of its data coordinate;
    rank 0 alone is first.  The 1 x 2 mesh over ranks 0 and 1 leaves
    ranks 2 and 3 out."""
    for r, res in enumerate(tp["ranks"]):
        m = res["mesh"]["2x2"]
        d, c = divmod(r, 2)
        assert m["shape"] == {"data": 2, "model": 2}
        assert (m["rank"], m["model_rank"]) == (d, c)
        assert m["ranks"] == [c, 2 + c] and m["model_ranks"] == [2 * d,
                                                                 2 * d + 1]
        assert m["first"] == (r == 0)
        one = res["mesh"]["1x2"]
        assert one["member"] == (r < 2)
        if r < 2:
            assert one["shape"] == {"data": 1, "model": 2}
            assert (one["rank"], one["model_rank"]) == (0, r)


# ------------------------------------------------------------------ CLI


def test_training_mesh_rules_match_jax(tp, monkeypatch):
    """``_training_mesh`` at world size 4 against the JAX CLI's at 4
    visible devices: the same meshes, and the same refusals word for word
    (an explicit mesh past the ranks, a model axis that does not divide
    them, a batch the data axis does not divide); an explicit 1 x 2 mesh
    leaves the other two ranks out."""
    from mrisr_tpu.config import DataConfig, MeshConfig

    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "device_count", lambda: 4)
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    for label, data, model, batch in RULES:
        cfg = JaxConfig(data=DataConfig(batch_size=batch),
                        mesh=MeshConfig(data=data, model=model))
        try:
            m = jax_cli._training_mesh(cfg)
            want = ("mesh", None if m is None else dict(m.shape))
        except (SystemExit, AssertionError) as e:
            want = (type(e).__name__, str(e))
        for r, res in enumerate(tp["ranks"]):
            got = res["rules"][label]
            assert got[:2] == want, (label, r)
            if label == "explicit 1x2":
                assert got[2] == (r < 2)


def _history(res, key):
    """A CLI run's history series but the host clock's."""
    hist = res["cli"][key]["history"]
    return None if hist is None else {
        k: v for k, v in hist.items() if k != "epoch_time_s"}


@pytest.mark.parametrize("command", ["train", "distill"])
def test_cli_2x2_matches_data_parallel(tp, command):
    """``--mesh-data 2 --mesh-model 2`` under four torchrun ranks: the two
    model coordinates' copies report the same history, equal to the same
    command at ``--mesh-data 2`` (ranks 2 and 3 sit that run out) and, for
    train, to the model-only ``--mesh-model 2`` (data = 4 // 2).  Only
    rank 0 writes, and it prints the mesh once."""
    ranks = tp["ranks"]
    want = _history(ranks[0], f"{command}_2")
    assert want is not None
    keys = [f"{command}_2x2"] + (["train_model_only"]
                                 if command == "train" else [])
    for key in keys:
        hists = [_history(r, key) for r in ranks]
        assert all(h == want for h in hists), key
        assert [r["cli"][key]["writes"] for r in ranks] == [True, False,
                                                            False, False]
        printed = [r["cli"][key]["stdout"] for r in ranks]
        assert printed[0].count("training mesh: {'data': 2, 'model': 2}") == 1
        assert not any(printed[1:]), key
    assert [_history(r, f"{command}_2") is None for r in ranks] == [
        False, False, True, True]
    preset = "unet" if command == "train" else "unet_distilled"
    hist = json.loads((tp["out"] / f"{command}_2x2_results" /
                       f"{preset}_history.json").read_text())
    np.testing.assert_allclose(hist["train_loss"], want["train_loss"])


def test_cli_train_2x2_matches_jax(tp):
    """The port's 2 x 2 training run against the JAX CLI's (4 of its 8
    CPU devices, the same initial weights and config): both epochs' train
    and val losses within rel 2e-3, the JAX data-parallel fit test's bound
    (``tests/test_distributed.py:217``); the checkpoint set rank 0
    wrote."""
    got = _history(tp["ranks"][0], "train_2x2")
    for series in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[series], tp["jax_cli"][series],
                                   rtol=2e-3, err_msg=series)
    assert sorted(os.listdir(tp["out"] / "train_2x2_models")) == [
        f"unet_{s}.pt" for s in ("best", "epoch_1", "epoch_2", "latest")]


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "unet", "--mesh-model", "2"],
    ["train", "--preset", "unet", "--mesh-data", "2", "--mesh-model", "2"],
    ["distill", "--mesh-model", "2"],
    ["eval", "--model", "unet", "--mesh-model", "2"],
])
def test_cli_mesh_refusals_one_rank_match_jax(tmp_path, monkeypatch, argv):
    """One rank: a mesh request past it refuses with the JAX CLI's text
    at one visible device, for the training commands and for a command
    that ignores the flags."""
    from mrisr_tpu.config import MeshConfig

    data = int(argv[argv.index("--mesh-data") + 1]) if (
        "--mesh-data" in argv) else -1
    model = int(argv[argv.index("--mesh-model") + 1])
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as want:
        jax_cli._training_mesh(JaxConfig(mesh=MeshConfig(data=data,
                                                         model=model)))
    with pytest.raises(SystemExit) as got:
        cli.main([*argv, "--data", str(tmp_path), "--device", "cpu"])
    assert str(got.value) == str(want.value)
