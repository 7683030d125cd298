"""Activation rematerialization (``ModelConfig.remat``) in the port's UNet
family against the plain UNet and against the JAX package's ``nn.remat``
UNet (CPU, FEAT 4, 32^2, batch 2).

- ``UNet(remat=True)`` has the plain UNet's state-dict keys and shapes;
- a training step with remat is bit-equal to the plain step in float32
  and in bf16 compute (loss, every gradient, BatchNorm's running
  statistics, committed once: ``num_batches_tracked`` is 1), runs the nine
  DoubleConvs under a non-reentrant ``torch.utils.checkpoint``, and a
  no-grad forward checkpoints nothing;
- the remat step on weights carried from flax matches JAX's remat step,
  computed as ``tests/test_models.py:test_unet_remat_matches_plain``
  computes it;
- ``create_model`` reads ``cfg.remat`` for exactly the registry names the
  JAX registry reads it for, and every trainer's UNet gets it;
- a ``SupervisedTrainer`` step from a JSON config with ``"remat": true``
  equals the plain one;
- two ranks (gloo, ``tests/torch_port_dp_worker.py``) take the supervised
  step with remat and equal the plain 2-rank step (cross-rank BatchNorm's
  all-reduces re-run in the backward); ``cli train`` with that config on
  a 2 x 1 and a 1 x 2 ('model') mesh equals the plain runs.
"""

import dataclasses
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

from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu.models.registry import MODEL_REGISTRY as JAX_MODELS
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.config import PRESETS, Config, ModelConfig
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.losses import make_perceptual_fn, mse
from mrisr_tpu_torch.models import UNet, blocks
from mrisr_tpu_torch.models.registry import TRAINABLE, create_model
from mrisr_tpu_torch.models.unet import BLOCKS_DOWN, BLOCKS_UP
from mrisr_tpu_torch.train import GANTrainer, SupervisedTrainer
from mrisr_tpu_torch.train.state import create_train_state
from mrisr_tpu_torch.train.steps import make_supervised_steps
from torch_port_dp_worker import run_case
from torch_port_util import flax_unet_variables, jax_unet_variables, noise

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FEAT, HW, BATCH = 4, 32, 2
BLOCK_NAMES = (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP)
REMAT_NAMES = ("unet", "unet_combined", "unet_distilled", "unet_gan")
# the 2-rank run: FEAT 4, 16^2, global batch 16 (8 rows a rank)
DP_HW, DP_BATCH, WORLD = 16, 16, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _step(remat, dtype, state_dict, batch):
    """One supervised MSE train step (Adam) of a FEAT-4 UNet from
    ``state_dict``; returns the module and the step's metrics."""
    module = UNet(features=FEAT, remat=remat, dtype=dtype)
    module.load_state_dict(state_dict)
    state = create_train_state(module, PRESETS["unet"].train)
    train_step, _ = make_supervised_steps(lambda p, t: (mse(p, t), {}))
    _, metrics = train_step(state, batch)
    return module, metrics


@pytest.fixture(scope="module")
def seeded():
    """Flax variables with seeded BatchNorm statistics, the port's state
    dict of them, and one batch [pre, post, target]."""
    v = jax_unet_variables(FEAT, HW, seed=0)
    return v, unet_state_dict_from_flax(v), _t(noise((BATCH, HW, HW, 3),
                                                      seed=1))


def test_remat_keeps_the_state_dict():
    plain = UNet(features=FEAT).state_dict()
    remat = UNet(features=FEAT, remat=True).state_dict()
    assert list(remat) == list(plain)
    assert all(remat[k].shape == plain[k].shape for k in plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_remat_step_is_bit_equal_to_plain(seeded, dtype):
    """Loss, every gradient, the updated weights and running statistics
    bit for bit; the statistics committed once (num_batches_tracked 1)."""
    _, sd, batch = seeded
    runs = [_step(remat, dtype, sd, batch) for remat in (False, True)]
    (plain, m0), (remat, m1) = runs
    assert float(m1["loss"]) == float(m0["loss"])
    grads = dict(plain.named_parameters())
    for name, p in remat.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name
        assert torch.equal(p, grads[name]), name
    want = plain.state_dict()
    for name, b in remat.named_buffers():
        assert torch.equal(b, want[name]), name
        if name.endswith("num_batches_tracked"):
            assert int(b) == 1, name


def test_remat_checkpoints_the_nine_blocks_when_recording(seeded,
                                                          monkeypatch):
    """A recorded forward runs each DoubleConv under a non-reentrant
    checkpoint and re-runs it once in the backward (marked as a
    recompute); a no-grad forward and a plain UNet checkpoint nothing."""
    _, sd, batch = seeded
    calls, runs = [], []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append((fn, kwargs.get("use_reentrant")))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    module = UNet(features=FEAT, remat=True)
    module.load_state_dict(sd)
    # a pre-hook: the re-run stops once the block's last saved tensor is
    # rebuilt, before a forward hook would fire
    for name in BLOCK_NAMES:
        getattr(module, name).register_forward_pre_hook(
            lambda m, i, name=name: runs.append(
                (name, m.conv[1].recomputing)))
    x = batch[..., :2]
    with torch.no_grad():
        module.train()(x)
        module.eval()(x)
    assert calls == [] and len(runs) == 2 * len(BLOCK_NAMES)
    runs.clear()
    module.train()(x).square().mean().backward()
    assert [(fn, r) for fn, r in calls] == [
        (getattr(module, n), False) for n in BLOCK_NAMES]
    assert sorted(runs) == sorted(
        [(n, False) for n in BLOCK_NAMES] + [(n, True) for n in BLOCK_NAMES])
    assert not any(m.recomputing for m in module.modules()
                   if isinstance(m, blocks.BatchNorm2d))
    calls.clear()
    UNet(features=FEAT).train()(x).square().mean().backward()
    assert calls == []



# dtype -> (loss rel, gradient atol): in float64 the JAX remat test's own
# bounds (tests/test_models.py); in float32 the port's UNet-gradient bounds
# against JAX (tests/test_torch_port_parallel.py), since XLA's and oneDNN's
# float32 convolutions round differently (one dec1 BatchNorm scale
# gradient of 1.477 lands 1.3e-6 apart, ten ulps)
JAX_BOUNDS = {"float64": (1e-6, 1e-6), "float32": (1e-5, 2e-5)}


@pytest.mark.parametrize("dtype", sorted(JAX_BOUNDS))
def test_remat_step_matches_jax_remat(seeded, dtype):
    """The port's remat step against flax's ``UNet(remat=True)`` on the
    same weights and input, as ``tests/test_models.py``'s remat test
    computes it (loss = mean(y^2), batch_stats mutable): the loss and
    gradients within ``JAX_BOUNDS``, the updated batch_stats within 1e-6."""
    loss_rel, grad_atol = JAX_BOUNDS[dtype]
    v, sd, batch = seeded
    x = batch[..., :2].numpy().astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        model = JaxUNet(features=FEAT, remat=True, dtype=jnp.dtype(dtype))
        v = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)

        def f(p):
            y, upd = model.apply(
                {"params": p, "batch_stats": v["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"])
            return jnp.mean(jnp.square(y)), upd

        (loss, upd), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            v["params"])
        grads = jax.tree.map(np.asarray, grads)
        stats = jax.tree.map(np.asarray, upd["batch_stats"])
    module = UNet(features=FEAT, remat=True).to(getattr(torch, dtype))
    module.load_state_dict(sd)
    got = module.train()(torch.from_numpy(x)).square().mean()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss), rel=loss_rel)
    # the gradients and statistics in flax's layout, by the inverse carry
    carry = UNet(features=FEAT).to(getattr(torch, dtype))
    with torch.no_grad():
        for p, q in zip(carry.parameters(), module.parameters()):
            p.copy_(q.grad)
        for b, q in zip(carry.buffers(), module.buffers()):
            b.copy_(q)
    mine = flax_unet_variables(carry)
    for want, got, atol in ((grads, mine["params"], grad_atol),
                            (stats, mine["batch_stats"], 1e-6)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(TRAINABLE))
def test_create_model_reads_remat_where_jax_does(name):
    """``cfg.remat`` reaches the model for exactly the names whose JAX
    factory passes it on (the four UNets), and no other family; a name
    the JAX registry lacks (the port's own ``fastddpm_pmub``, whose 32
    GroupNorm groups need 32 channels at the least) takes none."""
    want = (getattr(jax_create_model(name, JaxModelConfig(
        name=name, base_features=FEAT, remat=True))[0], "remat", False)
        if name in JAX_MODELS else False)
    assert want == (name in REMAT_NAMES)
    width = FEAT if name in JAX_MODELS else 32
    model = create_model(name, ModelConfig(name=name, base_features=width,
                                           remat=True))
    assert any(getattr(m, "remat", False) for m in model.modules()) == want
    plain = create_model(name, ModelConfig(name=name, base_features=width))
    assert not any(getattr(m, "remat", False) for m in plain.modules())


def _cfg(preset, remat):
    base = PRESETS[preset]
    return base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=BATCH, augment=False),
        model=dataclasses.replace(base.model, base_features=FEAT,
                                  remat=remat))


def test_trainers_build_their_unet_with_remat():
    """The GAN generator and the distillation student come from the
    config's model section too."""
    from mrisr_tpu_torch.serve.distill import DistillationTrainer

    gan = GANTrainer(_cfg("unet_gan", True), device="cpu")
    assert gan.g_state.module.remat
    assert not hasattr(gan.d_state.module, "remat")
    student = DistillationTrainer(_cfg("unet_distilled", True),
                                  teacher_fn=lambda x: x[..., :1],
                                  device="cpu")
    assert student.state.module.remat


def test_trainer_step_from_json_config_equals_plain(seeded, tmp_path):
    """unet_combined (MSE + SSIM + Gabor/LoG) from a JSON config whose
    model section says ``"remat": true``: its step equals the plain
    trainer's bit for bit (metrics, gradients, weights, statistics)."""
    _, _, batch = seeded
    path = tmp_path / "remat.json"
    path.write_text(_cfg("unet_combined", True).to_json())
    assert json.loads(path.read_text())["model"]["remat"] is True
    with open(path) as f:
        cfg = Config.from_dict(json.load(f))
    perceptual = make_perceptual_fn("gabor")
    remat = SupervisedTrainer(cfg, perceptual_fn=perceptual, device="cpu")
    plain = SupervisedTrainer(_cfg("unet_combined", False),
                              perceptual_fn=perceptual, device="cpu")
    assert remat.state.module.remat and not plain.state.module.remat
    m1 = remat.train_step(remat.state, batch)[1]
    m0 = plain.train_step(plain.state, batch)[1]
    assert {k: float(v) for k, v in m1.items()} == {
        k: float(v) for k, v in m0.items()}
    want = dict(plain.state.module.named_parameters())
    for name, p in remat.state.module.named_parameters():
        assert torch.equal(p.grad, want[name].grad), name
        assert torch.equal(p, want[name]), name
    want = plain.state.module.state_dict()
    for name, b in remat.state.module.named_buffers():
        assert torch.equal(b, want[name]), name


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


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both ranks' results of the plain and remat supervised steps and of
    the CLI runs, and the single-process remat step."""
    work = tmp_path_factory.mktemp("remat_dp")
    v = jax_unet_variables(FEAT, DP_HW, seed=0)
    store = str(work / "store")
    make_synthetic_store(store, num_patients=8, slices_per_volume=6,
                         height=DP_HW, width=DP_HW)
    cfg_path = str(work / "remat.json")
    with open(cfg_path, "w") as f:
        f.write(PRESETS["unet"].replace(model=dataclasses.replace(
            PRESETS["unet"].model, remat=True)).to_json())
    model_axis = ["--mesh-data", "1", "--mesh-model", "2"]
    cli_runs = {"data_plain": [], "data_remat": ["--config", cfg_path],
                "model_plain": model_axis,
                "model_remat": ["--config", cfg_path, *model_axis]}
    inputs = {
        "cases": ["supervised", "supervised_remat"],
        "supervised": {"state_dict": unet_state_dict_from_flax(v),
                       "batches": [_t(noise((DP_BATCH, DP_HW, DP_HW, 3),
                                            seed=s)) for s in (1, 2)]},
        "cli_common": ["train", "--preset", "unet", "--data", store,
                       "--device", "cpu", "--features", str(FEAT),
                       "--image-size", str(DP_HW), "--batch-size", "4",
                       "--epochs", "1"],
        "cli": cli_runs,
    }
    in_path = str(work / "inputs.pt")
    torch.save(inputs, in_path)
    out_dir = work / "out"
    out_dir.mkdir()
    port, *cli_ports = _free_ports(1 + len(cli_runs))
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
    return {"ranks": ranks, "logs": logs,
            "single": run_case("supervised_remat", inputs)}


def test_dp_remat_step_equals_plain_dp_step(dp):
    """Two ranks, cross-rank BatchNorm: the remat steps' metrics, first
    gradients and running statistics equal the plain 2-rank steps' bit for
    bit, on both ranks, and match the single-process remat step as the
    plain DP step matches its own (``test_torch_port_parallel.py``:
    metrics rel 1e-5, gradients atol 2e-5)."""
    for r in dp["ranks"]:
        plain, remat = r["supervised"], r["supervised_remat"]
        assert remat["train"] == plain["train"]
        for key in ("grads", "stats"):
            assert remat[key].keys() == plain[key].keys()
            for name, t in plain[key].items():
                assert torch.equal(remat[key][name], t), (key, name)
    single = dp["single"]
    r0 = dp["ranks"][0]["supervised_remat"]
    for g, w in zip(r0["train"], single["train"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
    for name, g in single["grads"].items():
        np.testing.assert_allclose(r0["grads"][name].numpy(), g.numpy(),
                                   atol=2e-5, err_msg=name)
    for name, s in single["stats"].items():
        np.testing.assert_allclose(r0["stats"][name].numpy(), s.numpy(),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_cli_train_with_remat_config_equals_plain_on_a_mesh(dp, axis):
    """``train --config`` with ``"remat": true`` on a 2 x 1 mesh and on a
    1 x 2 mesh (``--mesh-model 2``): the same loss history as the plain
    run on that mesh, on both ranks."""
    shape = {"data": {"data": 2, "model": 1}, "model": {"data": 1, "model": 2}}
    assert f"training mesh: {shape[axis]}" in dp["logs"][0]
    for r in dp["ranks"]:
        plain, remat = r[f"{axis}_plain"], r[f"{axis}_remat"]
        assert plain is not None and plain["train_loss"]
        # every series but the epoch's wall time
        assert {k: s for k, s in remat.items() if not k.endswith("_s")} == {
            k: s for k, s in plain.items() if not k.endswith("_s")}
