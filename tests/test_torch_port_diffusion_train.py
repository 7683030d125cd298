"""The port's Fast-DDPM training against mrisr_tpu's (CPU, base 4, 32^2,
batch 4), both lineages: the parameter counts at the presets' width, the
simple lineage's UNet forward, ``FastNoiseSchedule``'s tables and
``sample_ddim`` fed the JAX package's initial noise, one train step and
one eval step against the JAX package's unjitted steps with the JAX draws
(recomputed from the step's key) injected into the port's inner step, a
2-epoch fit resumed after epoch 1 against an unbroken one, and the
checkpoints read back by the JAX package's converter and by
``load_model``."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu.train.state import create_train_state as jax_train_state
from mrisr_tpu.train.state import make_optimizer as jax_make_optimizer
from mrisr_tpu.train.steps import make_diffusion_steps as jax_diff_steps
from mrisr_tpu.train.steps import make_simple_diffusion_steps as jax_simple_steps
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.from_jax import (
    fastddpm_state_dict_from_flax,
    simple_diffusion_state_dict_from_flax,
)
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.models import diffusion as pd
from mrisr_tpu_torch.models.registry import init_model
from mrisr_tpu_torch.train import DiffusionTrainer
from torch_port_util import (
    adam_mu,
    check_updated,
    jax_init,
    noise,
    rel_l2,
)

torch.set_num_threads(2)

BASE, TDIM, HW, B = 4, 16, 32, 4
CARRY = {"fastddpm": fastddpm_state_dict_from_flax,
         "fastddpm_simple": simple_diffusion_state_dict_from_flax}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("diffstore")
    return make_synthetic_store(str(d), num_patients=8, slices_per_volume=10,
                                height=HW, width=HW)


def jax_config(preset):
    base = JAX_PRESETS[preset]
    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, image_size=(HW, HW), batch_size=B,
                                 augment=False),
        model=dataclasses.replace(base.model, base_features=BASE,
                                  time_dim=TDIM))


def port_config(preset, tmp, augment=False, epochs=2) -> Config:
    cfg = Config.from_dict(json.loads(jax_config(preset).to_json()))
    return cfg.replace(
        data=dataclasses.replace(cfg.data, augment=augment),
        train=dataclasses.replace(
            cfg.train, epochs=epochs,
            checkpoint_dir=os.path.join(tmp, "models"),
            results_dir=os.path.join(tmp, "results")))


@functools.lru_cache(maxsize=None)
def make_lineage(preset):
    """The JAX model at base 4 with seeded, perturbed variables, its
    schedule's raw steps and the weight carry."""
    jcfg = jax_config(preset)
    model, _ = jax_create_model(preset, jcfg.model)
    v = jax_init(model, jnp.zeros((1, HW, HW, 3)),
                 jnp.zeros((1,), jnp.int32), seed=2)
    if preset == "fastddpm":
        sched = jd.DiffusionSchedule.create(
            jcfg.model.num_timesteps, jcfg.model.num_inference_steps,
            jcfg.model.beta_schedule, jcfg.model.timestep_selection)
        steps = jax_diff_steps(sched, jit_steps=False)
        n_sel = sched.num_inference_steps
    else:
        sched = jd.FastNoiseSchedule.create(jcfg.model.num_inference_steps)
        steps = jax_simple_steps(sched, jit_steps=False)
        n_sel = sched.T
    return {"preset": preset, "jcfg": jcfg, "model": model, "v": v,
            "steps": steps, "n_sel": n_sel, "carry": CARRY[preset]}


@pytest.fixture(scope="module", params=["fastddpm", "fastddpm_simple"])
def lineage(request):
    return make_lineage(request.param)


def port_trainer(lineage, cfg, steps_per_epoch=None) -> DiffusionTrainer:
    tr = DiffusionTrainer(cfg, steps_per_epoch=steps_per_epoch, device="cpu")
    tr.state.module.load_state_dict(lineage["carry"](lineage["v"]),
                                    strict=True)
    return tr


@pytest.mark.parametrize("name,want", [("fastddpm", 13_899_905),
                                       ("fastddpm_simple", 2_162_177)])
def test_param_count_at_preset_width(name, want):
    """The JAX package's counts (``tests/test_models.py`` pins them), from
    the module as built."""
    module, kind = init_model(name)
    assert kind == "diffusion"
    assert sum(p.numel() for p in module.parameters()) == want


def test_simple_unet_forward_matches_jax():
    lineage = make_lineage("fastddpm_simple")
    port = pd.SimpleDiffusionUNet(base_features=BASE)
    port.load_state_dict(lineage["carry"](lineage["v"]), strict=True)
    x = noise((3, HW, HW, 3), 11)
    t = np.array([0, 4, 9], np.int32)
    want = lineage["model"].apply(lineage["v"], jnp.asarray(x),
                                  jnp.asarray(t))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t))
    assert got.shape == want.shape == (3, HW, HW, 1)
    assert rel_l2(got.numpy(), want) <= 1e-5
    # the reference's files wrap the keys in 'unet.': stripped on load
    again = init_model("fastddpm_simple", port_config(
        "fastddpm_simple", "/x").model)[0]
    from mrisr_tpu_torch.ckpt.torch_ckpt import load_reference_state_dict
    load_reference_state_dict(again, {"model_state_dict": {
        f"unet.{k}": v for k, v in port.state_dict().items()}})
    for (k, a), b in zip(port.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("T", [10, 7, 1])
def test_fast_noise_schedule_tables_equal(T):
    want = jd.FastNoiseSchedule.create(T)
    got = pd.FastNoiseSchedule.create(T)
    assert got.T == want.T == T
    for k in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    x0, eps = noise((T, 4, 4, 1), 1), noise((T, 4, 4, 1), 2)
    t = np.arange(T, dtype=np.int32)
    np.testing.assert_allclose(
        got.q_sample(torch.tensor(x0), torch.tensor(t),
                     torch.tensor(eps)).numpy(),
        np.asarray(want.q_sample(jnp.asarray(x0), jnp.asarray(t),
                                 jnp.asarray(eps))), rtol=0, atol=1e-6)


def test_sample_ddim_matches_jax():
    """The DDIM chain over the compressed schedule, x first, clamped, from
    the JAX package's initial draw."""
    lineage = make_lineage("fastddpm_simple")
    sched = jd.FastNoiseSchedule.create(10)
    cond = noise((2, HW, HW, 2), 5) * 0.5
    key = jax.random.PRNGKey(9)
    model, v = lineage["model"], lineage["v"]
    want = jd.sample_ddim(lambda x, t: model.apply(v, x, t),
                          jnp.asarray(cond), key, sched)
    x_t = np.asarray(jax.random.normal(key, (2, HW, HW, 1), jnp.float32))
    port = pd.SimpleDiffusionUNet(base_features=BASE)
    port.load_state_dict(lineage["carry"](v))
    with torch.no_grad():
        got = pd.sample_ddim(port.eval(), torch.tensor(cond), None,
                             pd.FastNoiseSchedule.create(10),
                             noise=torch.tensor(x_t))
    assert got.shape == (2, HW, HW, 1)
    assert float(got.abs().max()) <= 1.0
    assert rel_l2(got.numpy(), want) <= 1e-5


def jax_draws(lineage, key, b, train):
    """The JAX step's timestep indices and noise under ``key``."""
    n_sel = lineage["n_sel"]
    if not train:
        t = np.floor(np.linspace(0.0, n_sel - 1, b)).astype(np.int64)
        return t, np.asarray(jax.random.normal(key, (b, HW, HW, 1),
                                               jnp.float32))
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (b // 2 + 1,), 0, n_sel)
    t = np.asarray(jnp.concatenate([t, n_sel - t - 1])[:b], np.int64)
    return t, np.asarray(jax.random.normal(k_n, (b, HW, HW, 1), jnp.float32))


def test_one_train_step_matches_jax(lineage, store, tmp_path):
    """AdamW with the clip at 1.0: the port's clipped gradients against
    the JAX step's first moment / 0.1."""
    jcfg = lineage["jcfg"]
    cfg = port_config(lineage["preset"], str(tmp_path))
    batch = next(iter(build_loader(store, "train", cfg.data,
                                   device="cpu"))).numpy()
    raw_train, raw_eval = lineage["steps"]
    key = jax.random.PRNGKey(21)
    state = jax_train_state(lineage["model"],
                            jax.tree.map(jnp.asarray, lineage["v"]),
                            jax_make_optimizer(jcfg.train))
    state1, metrics = jax.jit(raw_train)(state, jnp.asarray(batch), key)
    want_eval = jax.jit(raw_eval)(state, jnp.asarray(batch), key)

    tr = port_trainer(lineage, cfg)
    t, eps = jax_draws(lineage, key, B, train=False)
    got_eval = tr.eval_step.eval_on(tr.state, torch.tensor(batch),
                                    torch.tensor(t), torch.tensor(eps))
    assert float(got_eval["loss"]) == pytest.approx(
        float(want_eval["loss"]), rel=1e-5)
    t, eps = jax_draws(lineage, key, B, train=True)
    assert len(t) == B and (t < lineage["n_sel"]).all()
    _, got = tr.train_step.train_on(tr.state, torch.tensor(batch),
                                    torch.tensor(t), torch.tensor(eps))
    assert float(got["loss"]) == pytest.approx(float(metrics["loss"]),
                                               rel=1e-5)
    new = {"params": jax.tree.map(np.asarray, state1.params)}
    grads = {"params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                    adam_mu(state1.opt_state))}
    check_updated(tr.state.module, lineage["carry"](grads),
                  lineage["carry"](new), jcfg.train.learning_rate)


def test_draws_are_the_references_shapes():
    """Antithetic indices: b // 2 + 1 draws, their mirrors, truncated to
    b; validation floor(linspace)."""
    from mrisr_tpu_torch.train.steps import antithetic_draw, linspace_draw

    g = torch.Generator().manual_seed(0)
    for b in (1, 2, 3, 4, 8):
        t = antithetic_draw(10, b, g, torch.device("cpu"))
        half = b // 2 + 1
        assert t.shape == (b,) and ((0 <= t) & (t < 10)).all()
        mirrored = torch.cat([t[:half], 9 - t[:half]])[:b]
        assert torch.equal(t, mirrored)
        np.testing.assert_array_equal(
            linspace_draw(10, b, torch.device("cpu")).numpy(),
            np.asarray(jnp.floor(jnp.linspace(0.0, 9, b)).astype(jnp.int32)))


def test_fit_resumed_equals_unbroken(store, tmp_path):
    """Two epochs in one fit, and one epoch then a resumed fit to two on
    the same loaders: the draws come from (seed, epoch, batch), so the
    weights, AdamW moments and histories are equal."""
    lineage = make_lineage("fastddpm")
    runs = {}
    for name in ("unbroken", "resumed"):
        cfg = port_config("fastddpm", str(tmp_path / name), augment=True)
        train = build_loader(store, "train", cfg.data, device="cpu")
        val = build_loader(store, "val", cfg.data, device="cpu")
        tr = port_trainer(lineage, cfg, steps_per_epoch=len(train))
        if name == "resumed":
            tr.fit(train, val, epochs=1, verbose=False)
            tr = port_trainer(lineage, cfg, steps_per_epoch=len(train))
            assert tr.try_resume() and tr.start_epoch == 2
        runs[name] = (tr, tr.fit(train, val, verbose=False))
    (a, ha), (b, hb) = runs["unbroken"], runs["resumed"]
    for k in set(ha.series) - {"epoch_time_s"}:
        assert hb.series[k] == ha.series[k], k
    assert a.state.step == b.state.step == 2 * len(train)
    for (k, x), y in zip(a.state.module.state_dict().items(),
                         b.state.module.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(a.state.optimizer.state.values(),
                    b.state.optimizer.state.values()):
        assert torch.equal(x["exp_avg_sq"], y["exp_avg_sq"])


def test_checkpoint_converts_and_loads(lineage, tmp_path):
    """``<preset>_best.pt`` through the JAX package's torch converter gives
    the JAX forward the port's; ``load_model`` reads it back weights-only
    and samples with the lineage's sampler."""
    preset = lineage["preset"]
    cfg = port_config(preset, str(tmp_path))
    tr = port_trainer(lineage, cfg)
    path = os.path.join(cfg.train.checkpoint_dir, f"{preset}_best.pt")
    tr.save(path, epoch=1, best_loss=0.9, val_loss=0.9)
    jv = convert_torch_checkpoint(preset, torch.load(path, weights_only=True))
    x = noise((2, HW, HW, 3), 13)
    t = np.array([3, 0], np.int32)
    want = lineage["model"].apply(jax.tree.map(jnp.asarray, jv),
                                  jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tr.state.module.eval()(torch.tensor(x), torch.tensor(t))
    assert rel_l2(got.numpy(), want) <= 1e-5
    loaded = load_model(preset, cfg.train.checkpoint_dir,
                        checkpoint="required", cfg=cfg.model, device="cpu")
    cond = torch.tensor(noise((2, HW, HW, 2), 14))
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(
        loaded.predict_nhwc(cond), tr.sample(cond, generator=g),
        rtol=0, atol=0)


def test_device_epoch_runner_passes_the_generator(store, tmp_path):
    """The card-side epoch (here on the CPU) hands its epoch generator to
    the diffusion step, after the permutation: a loop over the same
    permutation with the same generator takes the same steps."""
    from mrisr_tpu_torch.train.device_epoch import epoch_seed

    lineage = make_lineage("fastddpm")
    cfg = port_config("fastddpm", str(tmp_path))
    loader = build_loader(store, "train", cfg.data, backend="device",
                          device="cpu")
    a, b = port_trainer(lineage, cfg), port_trainer(lineage, cfg)
    a.enable_device_epochs(loader.bank, loader.plan_flat)
    got = a.run_epoch(None, train=True, epoch=3)
    g = torch.Generator().manual_seed(epoch_seed(cfg.train.seed, 3))
    perm = torch.randperm(loader.num_samples, generator=g)
    plan = torch.as_tensor(loader.plan_flat)
    losses = []
    for s in range(a._device_runner.steps_per_epoch):
        rows = plan[perm[s * B:(s + 1) * B]]
        batch = loader.bank.flat[rows].permute(0, 2, 3, 1).float()
        losses.append(float(b.train_step(b.state, batch.contiguous(),
                                         g)[1]["loss"]))
    assert got["loss"] == pytest.approx(np.mean(losses), rel=1e-12)
