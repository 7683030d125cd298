"""The port's UNet-GAN against mrisr_tpu's (CPU, FEAT = 4, 32^2, batch 4):
PatchGAN's forward and its empty-map error, the parameter counts at the
preset's width, one LSGAN train step (G and D: losses, gradients,
parameters, BatchNorm running statistics) and one eval step against the
JAX package's unjitted steps from the same weights, a 2-epoch fit resumed
after epoch 1 against an unbroken one, and the checkpoint read back by the
JAX package's converter and by ``load_model``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.losses.perceptual import make_perceptual_fn as jax_perceptual
from mrisr_tpu.models.discriminator import PatchGAN as JaxPatchGAN
from mrisr_tpu.models.unet import UNet as JaxUNet
from mrisr_tpu.train.state import create_train_state as jax_train_state
from mrisr_tpu.train.state import make_optimizer as jax_make_optimizer
from mrisr_tpu.train.steps import make_gan_steps as jax_gan_steps
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.ckpt.from_jax import patchgan_state_dict_from_flax
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
from mrisr_tpu_torch.models.discriminator import PatchGAN
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.models.unet import UNet
from mrisr_tpu_torch.train import GANTrainer
from torch_port_util import adam_mu, check_updated, jax_init, param_count, rel_l2

torch.set_num_threads(2)

FEAT, HW, B = 4, 32, 4


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("ganstore")
    return make_synthetic_store(str(d), num_patients=8, slices_per_volume=10,
                                height=HW, width=HW)


def jax_config():
    base = JAX_PRESETS["unet_gan"]
    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, image_size=(HW, HW), batch_size=B,
                                 augment=False),
        model=dataclasses.replace(base.model, base_features=FEAT))


def port_config(tmp, augment=False, epochs=2) -> Config:
    cfg = Config.from_dict(json.loads(jax_config().to_json()))
    return cfg.replace(
        data=dataclasses.replace(cfg.data, augment=augment),
        train=dataclasses.replace(
            cfg.train, epochs=epochs,
            checkpoint_dir=os.path.join(tmp, "models"),
            results_dir=os.path.join(tmp, "results")))


@pytest.fixture(scope="module")
def weights():
    """Seeded flax G and D variables with non-trivial BatchNorm scales,
    shifts and running statistics (G's eval-mode fake reads them)."""
    gen, disc = JaxUNet(features=FEAT, use_bias=False), JaxPatchGAN(
        base_features=FEAT)
    g = jax_init(gen, jnp.zeros((1, HW, HW, 2)), seed=4, train=False)
    d = jax_init(disc, jnp.zeros((1, HW, HW, 3)), seed=5, train=False)
    return {"gen": gen, "disc": disc, "g": g, "d": d}


def port_trainer(cfg, weights, steps_per_epoch=None) -> GANTrainer:
    tr = GANTrainer(cfg, perceptual_fn=make_perceptual_fn("gabor"),
                    steps_per_epoch=steps_per_epoch, device="cpu")
    tr.g_state.module.load_state_dict(unet_state_dict_from_flax(weights["g"]))
    tr.d_state.module.load_state_dict(patchgan_state_dict_from_flax(
        weights["d"]))
    return tr


def test_param_counts_at_preset_width():
    gen, kind = init_model("unet_gan")
    disc, _ = init_model("patchgan")
    assert kind == "pair"
    assert sum(p.numel() for p in gen.parameters()) == 31_037_057
    assert sum(p.numel() for p in disc.parameters()) == 2_765_633
    shapes = jax.eval_shape(lambda: JaxPatchGAN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert param_count(shapes["params"]) == 2_765_633
    assert sum(p.numel() for p in UNet(use_bias=False).parameters()) == (
        31_037_057)


@pytest.mark.parametrize("hw", [32, 48, 256])
def test_patchgan_forward_matches_jax(weights, hw):
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    port = PatchGAN(base_features=FEAT)
    port.load_state_dict(patchgan_state_dict_from_flax(weights["d"]))
    for train in (False, True):
        want = weights["disc"].apply(weights["d"], jnp.asarray(x),
                                     train=train, mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port.train(train)(torch.tensor(x))
        assert got.shape == want.shape == (2, hw // 8 - 2, hw // 8 - 2, 1)
        assert rel_l2(got.numpy(), want) <= 1e-5


def test_patchgan_empty_map_raises():
    with pytest.raises(ValueError, match="needs >= 32 pixels"):
        PatchGAN(base_features=FEAT).eval()(torch.zeros(1, 16, 16, 3))


@pytest.fixture(scope="module")
def jax_step(weights, store):
    """One train step and one eval step of the JAX package's unjitted GAN
    steps (jitted here whole) on the first train batch."""
    jcfg = jax_config()
    batch = next(iter(build_loader(store, "train", port_config("/x").data,
                                   device="cpu"))).numpy()
    lc = jcfg.loss
    raw_train, raw_eval = jax_gan_steps(
        perceptual_fn=jax_perceptual("gabor"), lambda_l1=lc.lambda_l1,
        lambda_perceptual=lc.lambda_perceptual,
        lambda_adversarial=lc.lambda_adversarial, jit_steps=False)

    def fresh(model, v, lr):
        return jax_train_state(model, jax.tree.map(jnp.asarray, v),
                               jax_make_optimizer(jcfg.train, learning_rate=lr))

    g0 = fresh(weights["gen"], weights["g"], jcfg.train.learning_rate)
    d0 = fresh(weights["disc"], weights["d"], jcfg.train.learning_rate_d)
    evals = jax.jit(raw_eval)(g0, d0, jnp.asarray(batch))
    g1, d1, metrics = jax.jit(raw_train)(g0, d0, jnp.asarray(batch))

    def out(state):
        new = jax.tree.map(np.asarray, {"params": state.params,
                                        "batch_stats": state.batch_stats})
        grads = {"params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                        adam_mu(state.opt_state)),
                 "batch_stats": new["batch_stats"]}
        return new, grads

    return {"batch": batch, "g": out(g1), "d": out(d1),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "eval": {k: float(v) for k, v in evals.items()}}


def test_one_train_step_matches_jax(weights, jax_step, tmp_path):
    """D's fake from G in eval mode, D's BatchNorm statistics through the
    real then the fake pass, G's update against the updated D in eval
    mode: G and D each against the JAX step."""
    tr = port_trainer(port_config(str(tmp_path)), weights)
    _, _, got = tr.train_step(tr.g_state, tr.d_state,
                              torch.tensor(jax_step["batch"]))
    assert set(got) == set(jax_step["metrics"]) == {"g", "d", "l1", "adv",
                                                    "perc"}
    for k, want in jax_step["metrics"].items():
        assert float(got[k]) == pytest.approx(want, rel=1e-5), k
    lr = tr.config.train.learning_rate
    new, grads = jax_step["g"]
    check_updated(tr.g_state.module, unet_state_dict_from_flax(grads),
                  unet_state_dict_from_flax(new), lr)
    new, grads = jax_step["d"]
    check_updated(tr.d_state.module, patchgan_state_dict_from_flax(grads),
                  patchgan_state_dict_from_flax(new),
                  tr.config.train.learning_rate_d)
    assert tr.g_state.step == tr.d_state.step == 1


def test_eval_step_matches_jax(weights, jax_step, tmp_path):
    tr = port_trainer(port_config(str(tmp_path)), weights)
    got = tr.eval_step(tr.g_state, tr.d_state,
                       torch.tensor(jax_step["batch"]))
    assert set(got) == set(jax_step["eval"]) == {
        "l1_loss", "adv_loss", "d_loss", "perc_loss", "g_loss"}
    for k, want in jax_step["eval"].items():
        assert float(got[k]) == pytest.approx(want, rel=1e-5), k


def test_fit_resumed_equals_unbroken(weights, store, tmp_path):
    """Two epochs in one fit, and one epoch then a resumed fit to two on
    the same loaders (whose shuffle and augmentation streams go on): the
    same weights, optimizer moments, histories and checkpoint files."""
    runs = {}
    for name in ("unbroken", "resumed"):
        cfg = port_config(str(tmp_path / name), augment=True)
        train = build_loader(store, "train", cfg.data, device="cpu")
        val = build_loader(store, "val", cfg.data, device="cpu")
        tr = port_trainer(cfg, weights, steps_per_epoch=len(train))
        if name == "resumed":
            tr.fit(train, val, epochs=1, verbose=False)
            tr = port_trainer(cfg, weights, steps_per_epoch=len(train))
            assert tr.try_resume() and tr.start_epoch == 2
        runs[name] = (tr, tr.fit(train, val, verbose=False))
    (a, ha), (b, hb) = runs["unbroken"], runs["resumed"]
    for k in set(ha.series) - {"epoch_time_s"}:
        assert hb.series[k] == ha.series[k], k
    assert {"train_g", "train_d", "train_l1", "train_perc", "train_adv",
            "val_g_loss", "val_d_loss"} <= set(ha.series)
    for sa, sb in ((a.g_state, b.g_state), (a.d_state, b.d_state)):
        assert sa.step == sb.step == 2 * len(train)
        for (k, x), y in zip(sa.module.state_dict().items(),
                             sb.module.state_dict().values()):
            assert torch.equal(x, y), k
        for x, y in zip(sa.optimizer.state.values(),
                        sb.optimizer.state.values()):
            assert torch.equal(x["exp_avg"], y["exp_avg"])
    ckpt = torch.load(os.path.join(str(tmp_path / "resumed"), "models",
                                   "unet_gan_latest.pt"), weights_only=True)
    assert {"generator_state_dict", "discriminator_state_dict",
            "g_optimizer_state_dict", "d_optimizer_state_dict", "g_step",
            "d_step", "epoch", "best_loss", "val_loss"} <= set(ckpt)
    assert ckpt["epoch"] == 2 and ckpt["d_step"] == 2 * len(train)


def test_checkpoint_converts_and_loads(weights, tmp_path):
    """``unet_gan_best.pt`` through the JAX package's torch converter (the
    generator) gives the JAX forward the port's, and ``load_model`` reads
    it back weights-only."""
    cfg = port_config(str(tmp_path))
    tr = port_trainer(cfg, weights)
    path = os.path.join(cfg.train.checkpoint_dir, "unet_gan_best.pt")
    tr.save(path, epoch=1, best_loss=0.3, val_loss=0.3)
    jv = convert_torch_checkpoint("unet_gan", torch.load(path,
                                                         weights_only=True))
    x = np.random.default_rng(7).standard_normal((2, HW, HW, 2)).astype(
        np.float32)
    want = weights["gen"].apply(jax.tree.map(jnp.asarray, jv),
                                jnp.asarray(x), train=False)
    got = tr.predict(torch.tensor(x))
    assert rel_l2(got.numpy(), want) <= 1e-5
    loaded = load_model("unet_gan", cfg.train.checkpoint_dir,
                        checkpoint="required", cfg=cfg.model, device="cpu")
    torch.testing.assert_close(loaded.predict_nhwc(torch.tensor(x)), got,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="discriminator"):
        load_model("patchgan", cfg.train.checkpoint_dir, device="cpu")


def test_device_epoch_runner_takes_both_states(weights, store, tmp_path):
    """The card-side epoch (here on the CPU, a device bank in bf16) steps
    G and D together, as a loop over its own permutation does."""
    from mrisr_tpu_torch.train.device_epoch import epoch_seed

    cfg = port_config(str(tmp_path))
    loader = build_loader(store, "train", cfg.data, backend="device",
                          device="cpu")
    a, b = port_trainer(cfg, weights), port_trainer(cfg, weights)
    a.enable_device_epochs(loader.bank, loader.plan_flat)
    got = a.run_epoch(None, train=True, epoch=1)
    g = torch.Generator().manual_seed(epoch_seed(cfg.train.seed, 1))
    perm = torch.randperm(loader.num_samples, generator=g)
    plan = torch.as_tensor(loader.plan_flat)
    losses = []
    for s in range(a._device_runner.steps_per_epoch):
        rows = plan[perm[s * B:(s + 1) * B]]
        batch = loader.bank.flat[rows].permute(0, 2, 3, 1).float()
        losses.append(float(b.train_step(b.g_state, b.d_state,
                                         batch.contiguous())[-1]["g"]))
    assert got["loss"] == got["g"] == pytest.approx(np.mean(losses),
                                                    rel=1e-12)
    assert a.d_state.step == b.d_state.step == len(losses)
