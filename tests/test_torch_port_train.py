"""Port training against mrisr_tpu's (CPU, FEAT = 4, 32^2, batch 4): the
optimizer on identical gradients against optax, one combined-loss train
step against the JAX ``train_step`` (loss, gradients, BatchNorm running
statistics, parameters), a 2-epoch ``SupervisedTrainer.fit`` against the
JAX trainer's from the same initial weights, resume, the checkpoint layout,
the card-side epoch runner and the flax-style initialization.

The JAX side compiles one train step and one eval step: the step test and
the fit share the trainer and its jitted functions."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.config import TrainConfig as JaxTrainConfig
from mrisr_tpu.data.pipeline import build_loader as jax_build_loader
from mrisr_tpu.data.volumes import VolumeStore as JaxVolumeStore
from mrisr_tpu.losses.perceptual import make_perceptual_fn as jax_perceptual
from mrisr_tpu.train import SupervisedTrainer as JaxTrainer
from mrisr_tpu.train.state import make_optimizer as jax_make_optimizer
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.ckpt.io import get_latest_checkpoint
from mrisr_tpu_torch.config import Config, TrainConfig
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.train import SupervisedTrainer, create_train_state
from mrisr_tpu_torch.train.device_epoch import epoch_seed
from torch_port_util import flax_unet_variables, rel_l2

torch.set_num_threads(2)

FEAT, HW, B = 4, 32, 4
LR = 1e-4


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainstore")
    return make_synthetic_store(str(d), num_patients=8, slices_per_volume=10,
                                height=HW, width=HW)


def jax_config(tmp, preset="unet_combined"):
    base = JAX_PRESETS[preset]
    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, image_size=(HW, HW), batch_size=B,
                                 augment=False),
        model=dataclasses.replace(base.model, base_features=FEAT),
        train=dataclasses.replace(
            base.train, epochs=2, save_every_epoch=False,
            checkpoint_dir=os.path.join(tmp, "jax_models"),
            results_dir=os.path.join(tmp, "jax_results")))


def port_config(jcfg, tmp) -> Config:
    """The same run in the port's Config (the two configs share a JSON
    form), writing its own files with per-epoch snapshots."""
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, save_every_epoch=True,
        checkpoint_dir=os.path.join(tmp, "models"),
        results_dir=os.path.join(tmp, "results")))


def port_trainer(cfg, init, steps_per_epoch=None) -> SupervisedTrainer:
    tr = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn("gabor"),
                           steps_per_epoch=steps_per_epoch, device="cpu")
    tr.state.module.load_state_dict(unet_state_dict_from_flax(init))
    return tr


@pytest.fixture(scope="module")
def run(store, tmp_path_factory):
    """Initial weights from the port's ``init_model``, carried to flax; the
    JAX trainer built on them takes one train step on the first train batch,
    then a 2-epoch fit from the same initial state."""
    import mrisr_tpu.train.trainer as jax_trainer_module
    from mrisr_tpu.models.registry import create_model

    tmp = str(tmp_path_factory.mktemp("train"))
    jcfg = jax_config(tmp)
    init = flax_unet_variables(init_model("unet", port_config(
        jcfg, tmp).model, seed=0)[0])
    with pytest.MonkeyPatch.context() as mp:
        # the JAX trainer starts from the carried weights (its own eager
        # flax init takes half a minute on the CPU)
        mp.setattr(jax_trainer_module, "init_model", lambda name, cfg, **kw: (
            create_model(name, cfg)[0], jax.tree.map(jnp.asarray, init),
            "pair"))
        jtr = JaxTrainer(jcfg, perceptual_fn=jax_perceptual("gabor"),
                         image_size=(HW, HW))
    jtr.save = lambda *args, **kw: None  # its Orbax files are not compared
    jstore = JaxVolumeStore.open(store.root)
    batch = np.asarray(next(iter(jax_build_loader(jstore, "train",
                                                  jcfg.data))))

    def fresh(state):
        params = jax.tree.map(jnp.array, init["params"])
        return state.replace(
            params=params,
            batch_stats=jax.tree.map(jnp.array, init["batch_stats"]),
            opt_state=state.tx.init(params), step=0)

    state1, metrics1 = jtr.train_step(fresh(jtr.state), jnp.asarray(batch))
    step = {"state": jax.tree.map(np.array, {
        "params": state1.params, "batch_stats": state1.batch_stats,
        "mu": state1.opt_state[0].mu}),
        "metrics": {k: float(v) for k, v in metrics1.items()}}
    jtr.state = fresh(state1)
    hist = jtr.fit(jax_build_loader(jstore, "train", jcfg.data),
                   jax_build_loader(jstore, "val", jcfg.data), verbose=False)
    return {"tmp": tmp, "jcfg": jcfg, "init": init, "batch": batch,
            "step": step, "hist": hist}


def test_one_train_step_matches_jax(run):
    cfg = port_config(run["jcfg"], run["tmp"])
    tr = port_trainer(cfg, run["init"])
    module = tr.state.module
    _, metrics = tr.train_step(tr.state, torch.tensor(run["batch"]))
    want = run["step"]
    for k, v in want["metrics"].items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-5), k
    # gradients: after one Adam step from zero moments, mu = 0.1 g
    wstate = want["state"]
    g_want = unet_state_dict_from_flax({
        "params": jax.tree.map(lambda m: m / 0.1, wstate["mu"]),
        "batch_stats": wstate["batch_stats"]})
    p_want = unet_state_dict_from_flax(wstate)
    for name, p in module.named_parameters():
        g = p.grad.numpy()
        before_bn = re.search(r"\.conv\.[03]\.bias$", name) is not None
        if before_bn:
            # a conv bias right before a training-mode BatchNorm: its
            # gradient is 0 in exact arithmetic (the batch mean removes
            # it), so both sides hold rounding noise far below the weight's
            wg = dict(module.named_parameters())[name[:-4] + "weight"].grad
            assert np.linalg.norm(g) <= 1e-4 * float(wg.norm()), name
            assert np.linalg.norm(g_want[name].numpy()) <= 1e-4 * float(
                wg.norm()), name
        else:
            assert rel_l2(g, g_want[name].numpy()) <= 1e-4, name
        # parameters: one Adam step moves each by about lr; an element whose
        # gradient is rounding noise may move either way
        d = np.abs(p.detach().numpy() - p_want[name].numpy())
        tiny = (np.abs(g_want[name].numpy()) < 1e-6) | before_bn
        assert d[~tiny].max(initial=0) <= 1e-6, name
        assert d[tiny].max(initial=0) <= 2 * LR, name
    for name, b in module.named_buffers():
        if "running" in name:  # flax updates var with the biased variance
            np.testing.assert_allclose(b.numpy(), p_want[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def test_fit_two_epochs_matches_jax_and_resumes(run, store):
    tmp = run["tmp"]
    cfg = port_config(run["jcfg"], tmp)
    train = build_loader(store, "train", cfg.data, device="cpu")
    val = build_loader(store, "val", cfg.data, device="cpu")
    tr = port_trainer(cfg, run["init"], steps_per_epoch=len(train))
    hist = tr.fit(train, val, verbose=False)
    want = run["hist"].series
    assert hist.series["epoch"] == want["epoch"] == [1.0, 2.0]
    for k in ("train_loss", "val_loss", "train_mse", "val_ssim",
              "val_perceptual"):
        np.testing.assert_allclose(hist.series[k], want[k], rtol=1e-3,
                                   err_msg=k)
    got_json = json.load(open(os.path.join(
        tmp, "results", "unet_combined_history.json")))
    want_json = json.load(open(os.path.join(
        tmp, "jax_results", "unet_combined_history.json")))
    assert set(got_json) == set(want_json)
    assert got_json["config"] == json.loads(cfg.to_json())

    names = sorted(os.listdir(os.path.join(tmp, "models")))
    assert names == [f"unet_combined_{s}.pt" for s in
                     ("best", "epoch_1", "epoch_2", "latest")]
    ckpt = torch.load(os.path.join(tmp, "models", "unet_combined_latest.pt"),
                      weights_only=True)
    assert set(ckpt) == {"epoch", "model_state_dict", "optimizer_state_dict",
                         "scheduler_state_dict", "step", "val_loss",
                         "best_loss"}
    assert "final_conv.weight" in ckpt["model_state_dict"]
    assert ckpt["epoch"] == 2 and ckpt["step"] == 2 * len(train)
    assert type(ckpt["val_loss"]) is float and type(ckpt["best_loss"]) is float
    # load_model finds <preset>_best.pt and predicts as the trainer does
    loaded = load_model("unet_combined", os.path.join(tmp, "models"),
                        checkpoint="required", cfg=cfg.model, device="cpu")
    x = torch.tensor(run["batch"][..., :2])
    best = torch.load(os.path.join(tmp, "models", "unet_combined_best.pt"),
                      weights_only=True)
    if best["epoch"] == 2:
        torch.testing.assert_close(loaded.predict_nhwc(x), tr.predict(x))

    # resume: a new trainer continues at epoch 3 with the history of 1-2
    tr2 = port_trainer(cfg, run["init"], steps_per_epoch=len(train))
    assert tr2.try_resume() and tr2.start_epoch == 3
    assert tr2.state.step == 2 * len(train)
    for (k, a), b in zip(tr.state.module.state_dict().items(),
                         tr2.state.module.state_dict().values()):
        assert torch.equal(a, b), k
    hist2 = tr2.fit(train, val, epochs=3, verbose=False)
    assert hist2.series["epoch"] == [1.0, 2.0, 3.0]
    assert hist2.series["train_loss"][:2] == hist.series["train_loss"]
    assert get_latest_checkpoint(cfg.train.checkpoint_dir,
                                 "unet_combined")[1] == 3


@pytest.mark.parametrize("optimizer,clip,schedule", [
    ("adam", 0.0, "constant"), ("adamw", 1.0, "constant"),
    ("adam", 0.0, "cosine"), ("adamw", 1.0, "cosine")])
def test_optimizer_matches_optax(optimizer, clip, schedule):
    """Five updates on the same gradient sequence; the gradients' global
    norm crosses the clip norm both ways."""
    kw = dict(optimizer=optimizer, grad_clip_norm=clip, lr_schedule=schedule,
              learning_rate=1e-2, epochs=1, weight_decay=0.05)
    tx = jax_make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=5)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(
        torch.from_numpy(v.copy())) for k, v in params.items()})
    state = create_train_state(module, TrainConfig(**kw), steps_per_epoch=5)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for i in range(5):
        scale = (0.2, 3.0, 0.5, 2.0, 0.9)[i]
        grads = {k: (scale * rng.standard_normal(s) / np.sqrt(17)).astype(
            np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k].copy())
        state.apply_gradients()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert state.step == 5


def test_init_model_is_flax_default_init():
    model, kind = init_model("unet", Config().model.__class__(
        base_features=16), seed=3)
    assert kind == "pair"
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            w = m.weight  # (C_in, C_out, kh, kw)
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        elif isinstance(m, torch.nn.Conv2d):
            w, fan_in = m.weight, m.weight[0].numel()
        elif isinstance(m, torch.nn.BatchNorm2d):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0),
                         (m.running_mean, 0.0), (m.running_var, 1.0)):
                assert torch.all(t == v), name
            continue
        else:
            continue
        assert torch.all(m.bias == 0), name
        assert float(w.detach().abs().max()) <= 2.0 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
        if w.numel() >= 4096:
            var = float(w.detach().double().var())
            assert var == pytest.approx(1.0 / fan_in, rel=0.10), name
            checked += 1
    assert checked >= 10
    again, _ = init_model("unet", Config().model.__class__(base_features=16),
                          seed=3)
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_device_epoch_runner_replays_train_steps(store, tmp_path):
    """The card-side epoch (here on the CPU, a device bank in bf16) takes
    the steps a loop over its own permutation takes."""
    cfg = port_config(jax_config(str(tmp_path), "unet"), str(tmp_path))
    loader = build_loader(store, "train", cfg.data, backend="device",
                          device="cpu")
    # two trainers, the same seeded init
    a = SupervisedTrainer(cfg, device="cpu")
    b = SupervisedTrainer(cfg, device="cpu")
    a.enable_device_epochs(loader.bank, loader.plan_flat)
    got = a.run_epoch(None, train=True, epoch=1)
    runner = a._device_runner
    g = torch.Generator().manual_seed(epoch_seed(cfg.train.seed, 1))
    perm = torch.randperm(loader.num_samples, generator=g)
    plan = torch.as_tensor(loader.plan_flat)
    losses = []
    for s in range(runner.steps_per_epoch):
        rows = plan[perm[s * B:(s + 1) * B]]
        batch = loader.bank.flat[rows].permute(0, 2, 3, 1).float()
        _, m = b.train_step(b.state, batch.contiguous())
        losses.append(float(m["loss"]))
    assert runner.steps_per_epoch == loader.num_samples // B
    assert got["loss"] == pytest.approx(np.mean(losses), rel=1e-12)
    assert a.timings[-1]["steps"] == runner.steps_per_epoch


def test_light_checkpoints_without_an_epoch(store, tmp_path):
    """light mode saves 'latest' after the loop even when no epoch ran
    (the epoch is bound before the loop)."""
    cfg = port_config(jax_config(str(tmp_path), "unet"), str(tmp_path))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, light_checkpoints=True, save_every_epoch=False))
    tr = SupervisedTrainer(cfg, device="cpu")
    tr.start_epoch = 3
    hist = tr.fit([], None, epochs=2, verbose=False)
    assert hist.series == {}
    ckpt = torch.load(os.path.join(cfg.train.checkpoint_dir,
                                   "unet_latest.pt"), weights_only=True)
    assert ckpt["epoch"] == 2
