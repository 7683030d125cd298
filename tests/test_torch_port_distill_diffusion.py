"""Step-distillation of the Fast-DDPM sampler in the port against
mrisr_tpu/serve/distill_diffusion.py (CPU, base 4, time_dim 8, 16^2): the
grids, the per-step tables and the x0 target equal to the JAX package's,
``sample_ddim_grid`` from the JAX package's x_T, one train step and one
eval step in both loss spaces with the JAX draws injected, the rounds,
the ``<base>_steps<N>`` loading and its refusals, and ``ddim_grid``
bundles exported by the JAX package and served by the port."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu import api as japi
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu.serve import bundle as jb
from mrisr_tpu.serve import distill_diffusion as jdd
from mrisr_tpu.train.state import TrainState as JaxTrainState
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt.from_jax import fastddpm_state_dict_from_flax
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import ModelConfig, TrainConfig
from mrisr_tpu_torch.models import diffusion as pd
from mrisr_tpu_torch.serve import bundle as pb
from mrisr_tpu_torch.serve import distill_diffusion as pdd
from mrisr_tpu_torch.serve.quant_diffusion import FastDDPMForward
from mrisr_tpu_torch.train import create_train_state
from torch_port_util import (
    adam_mu,
    check_updated,
    jax_fastddpm_variables,
    noise,
    rel_l2,
)

torch.set_num_threads(2)

BASE, TDIM, HW, B = 4, 8, 16, 4
LR = 2e-4
# a 6-step grid over 100 cosine steps, as tests/test_distill_diffusion.py
SCHED = (100, 6, "cosine", "linspace")


@pytest.fixture(scope="module")
def setup():
    v = jax_fastddpm_variables(BASE, TDIM, HW, seed=61)
    module = pd.FastDDPMUNet(base_features=BASE, time_dim=TDIM)
    module.load_state_dict(fastddpm_state_dict_from_flax(v))
    return {"v": v, "jm": jd.FastDDPMUNet(base_features=BASE, time_dim=TDIM),
            "module": module.eval(), "js": jd.DiffusionSchedule.create(*SCHED),
            "ps": pd.DiffusionSchedule.create(*SCHED)}


def test_grids_tables_and_target_equal_jax(setup):
    for n in range(1, 12):
        for f in (1, 2, 3, 4):
            np.testing.assert_array_equal(pdd.grid_positions(n, f),
                                          jdd.grid_positions(n, f))
    with pytest.raises(ValueError, match="factor"):
        pdd.grid_positions(5, 0)
    js, ps = setup["js"], setup["ps"]
    for f in (1, 2, 3, 4):
        pos = jdd.grid_positions(6, f)
        want = jdd.subgrid_schedule(js, pos)
        got = pdd.subgrid_schedule(ps, pos)
        for k in ("betas", "alphas", "alphas_cumprod", "timesteps"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)), k)
        for g, w in zip(pdd._per_step_tables(ps, f),
                        jdd._per_step_tables(js, f)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x_t, x_pp = noise((2, 8, 8, 1), 62), noise((2, 8, 8, 1), 63)
    a_t = np.array([0.3, 0.7], np.float32).reshape(-1, 1, 1, 1)
    a_pp = np.array([0.9, 1.0], np.float32).reshape(-1, 1, 1, 1)
    want = jdd.solve_x0_target(*map(jnp.asarray, (x_t, x_pp, a_t, a_pp)))
    got = pdd.solve_x0_target(*map(torch.from_numpy, (x_t, x_pp, a_t, a_pp)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # at abar'' = 1 the target is x'' itself
    np.testing.assert_allclose(got[1].numpy(), x_pp[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("positions", [None, (1, 3, 5)])
def test_sample_ddim_grid_matches_jax(setup, positions):
    """The DDIM chain over the full grid and over a student's sub-grid,
    from the JAX package's x_T: rel 1e-5."""
    js, ps = setup["js"], setup["ps"]
    if positions is not None:
        js, ps = (jdd.subgrid_schedule(js, positions),
                  pdd.subgrid_schedule(ps, positions))
    cond = noise((2, HW, HW, 2), 64) * 0.5
    key = jax.random.PRNGKey(65)
    jm, v = setup["jm"], setup["v"]
    want = jax.jit(lambda c: jdd.sample_ddim_grid(
        lambda x, t: jm.apply(v, x, t), c, key, js))(jnp.asarray(cond))
    x_t = np.array(jax.random.normal(key, (2, HW, HW, 1), jnp.float32))
    with torch.no_grad():
        got = pdd.sample_ddim_grid(setup["module"], torch.from_numpy(cond),
                                   None, ps, noise=torch.from_numpy(x_t))
    assert got.shape == (2, HW, HW, 1)
    assert rel_l2(got.numpy(), want) <= 1e-5


def _jax_draws(key, n_student, b, train):
    if not train:
        m = np.floor(np.linspace(0.0, n_student - 1, b)).astype(np.int64)
        return m, np.array(jax.random.normal(key, (b, HW, HW, 1),
                                               jnp.float32))
    k_m, k_n = jax.random.split(key)
    return (np.array(jax.random.randint(k_m, (b,), 0, n_student),
                       np.int64),
            np.array(jax.random.normal(k_n, (b, HW, HW, 1), jnp.float32)))


@pytest.mark.parametrize("loss_space", ["eps", "x_snr_trunc"])
def test_stepdistill_steps_match_jax(setup, loss_space):
    """One train step (AdamW after the clip at 1.0) and one eval step from
    the same state, the JAX draws injected: losses rel 1e-5, the clipped
    gradients rel-L2 1e-4 (the JAX step's first moment / 0.1), parameters
    1e-6.  The student starts from other weights than the teacher's: from
    the teacher's own, the loss is the bf16 rounding of the teacher's
    weights, a difference of nearly equal float32 terms."""
    v, jm, factor = setup["v"], setup["jm"], 2
    sv = jax_fastddpm_variables(BASE, TDIM, HW, seed=72)
    batch = np.concatenate([noise((B, HW, HW, 2), 66) * 0.5,
                            noise((B, HW, HW, 1), 67) * 0.5], axis=-1)
    t_bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v["params"])
    j_train, j_eval = jdd.make_stepdistill_steps(
        setup["js"], factor,
        lambda x, t: jm.apply({"params": t_bf16}, x, t).astype(jnp.float32),
        loss_space=loss_space, jit_steps=False)
    jstate = JaxTrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, sv["params"]),
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR)))
    key = jax.random.PRNGKey(68)
    want_eval = jax.jit(j_eval)(jstate, jnp.asarray(batch), key)
    jstate1, want = jax.jit(j_train)(jstate, jnp.asarray(batch), key)

    student = pd.FastDDPMUNet(base_features=BASE, time_dim=TDIM)
    student.load_state_dict(fastddpm_state_dict_from_flax(sv))
    state = create_train_state(student, TrainConfig(
        optimizer="adamw", learning_rate=LR, weight_decay=1e-4,
        grad_clip_norm=1.0))
    p_train, p_eval = pdd.make_stepdistill_steps(
        setup["ps"], factor, pdd.frozen_bf16_teacher(setup["module"]),
        loss_space=loss_space)
    n_student = len(jdd.grid_positions(6, factor))
    m, eps = _jax_draws(key, n_student, B, train=False)
    got_eval = p_eval.eval_on(state, torch.from_numpy(batch),
                              torch.from_numpy(m), torch.from_numpy(eps))
    assert float(got_eval["loss"]) == pytest.approx(
        float(want_eval["loss"]), rel=1e-5)
    m, eps = _jax_draws(key, n_student, B, train=True)
    _, got = p_train.train_on(state, torch.from_numpy(batch),
                              torch.from_numpy(m), torch.from_numpy(eps))
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    grads = {"params": jax.tree.map(lambda a: np.asarray(a) / 0.1,
                                    adam_mu(jstate1.opt_state))}
    new = {"params": jax.tree.map(np.asarray, jstate1.params)}
    check_updated(student, fastddpm_state_dict_from_flax(grads),
                  fastddpm_state_dict_from_flax(new), LR)
    with pytest.raises(ValueError):
        pdd.make_stepdistill_steps(setup["ps"], 2, None, loss_space="v")


def test_distill_rounds(setup):
    """Two rounds of one epoch: each student is a copy trained from its
    teacher (the teacher untouched), keeps the best-val weights and
    samples on the halved grid 6 -> 3 -> 2."""
    rng = np.random.default_rng(69)
    loader = [torch.from_numpy(rng.normal(size=(B, HW, HW, 3)).astype(
        np.float32) * 0.5) for _ in range(2)]
    before = {k: t.clone() for k, t in setup["module"].state_dict().items()}
    rounds = pdd.progressive_distill(setup["module"], setup["ps"], loader,
                                     loader[:1], rounds=2, factor=2,
                                     epochs=1, verbose=False)
    for k, t in setup["module"].state_dict().items():
        assert torch.equal(t, before[k]), k
    assert [s.num_inference_steps for _, s, _ in rounds] == [3, 2]
    np.testing.assert_array_equal(rounds[0][1].timesteps.numpy(),
                                  setup["ps"].timesteps.numpy()[[1, 3, 5]])
    student, sched, hist = rounds[0]
    assert len(hist["train_loss"]) == len(hist["val_loss"]) == 1
    assert not student.training
    assert any(not torch.equal(p, before[k]) for k, p in
               student.state_dict().items())
    out = pdd.sample_ddim_grid(student, torch.zeros(2, HW, HW, 2), None,
                               sched)
    assert out.shape == (2, HW, HW, 1) and torch.isfinite(out).all()


def _write_student(d, name, timesteps, module):
    torch.save(reference_checkpoint(module, "fastddpm"),
               d / f"{name}_best.pt")
    (d / f"{name}_grid.json").write_text(json.dumps(
        {"base": "fastddpm", "factor": 2, "timesteps": timesteps}))


MCFG = ModelConfig(name="fastddpm", base_features=BASE, time_dim=TDIM)


def test_load_model_steps_roundtrip_and_refusals(setup, tmp_path):
    """``<base>_steps<N>`` resolves to the base architecture, the weights
    of ``<name>_best.pt`` and the sidecar's grid, sampled by DDIM over it
    (``tests/test_distill_diffusion.py:164-247``)."""
    grid = [175, 799, 999]
    _write_student(tmp_path, "fastddpm_steps3", grid, setup["module"])
    loaded = load_model("fastddpm_steps3", str(tmp_path), cfg=MCFG,
                        device="cpu")
    assert loaded.kind == "diffusion" and loaded.sampler == "ddim_grid"
    np.testing.assert_array_equal(loaded.schedule.timesteps.numpy(), grid)
    # the rest of the schedule is the config's
    full = pd.DiffusionSchedule.create(
        MCFG.num_timesteps, MCFG.num_inference_steps, MCFG.beta_schedule,
        MCFG.timestep_selection)
    assert torch.equal(loaded.schedule.alphas_cumprod, full.alphas_cumprod)
    for k, t in setup["module"].state_dict().items():
        assert torch.equal(loaded.module.state_dict()[k], t), k
    cond = torch.from_numpy(noise((2, HW, HW, 2), 70))
    out = loaded.predict_nhwc(cond)
    with torch.no_grad():
        want = pdd.sample_ddim_grid(setup["module"], cond, torch.Generator(
        ).manual_seed(0), loaded.schedule)
    assert torch.equal(out, want)

    with pytest.raises(ValueError, match="models_dir"):
        load_model("fastddpm_steps3", str(tmp_path), cfg=MCFG, device="cpu",
                   checkpoint=str(tmp_path / "fastddpm_steps3_best.pt"))
    _write_student(tmp_path, "fastddpm_steps5", grid, setup["module"])
    with pytest.raises(ValueError, match="timesteps"):
        load_model("fastddpm_steps5", str(tmp_path), cfg=MCFG, device="cpu")
    for bad, match in (([175, 799, 1000], "lie in"),
                       ([799, 175, 999], "ascending")):
        _write_student(tmp_path, "fastddpm_steps3", bad, setup["module"])
        with pytest.raises(ValueError, match=match):
            load_model("fastddpm_steps3", str(tmp_path), cfg=MCFG,
                       device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        load_model("unet_steps5", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        load_model("fastddpm_simple_steps5", str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="distill-steps"):
        load_model("fastddpm_steps2", str(tmp_path), device="cpu")
    (tmp_path / "fastddpm_steps2_best").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_model("fastddpm_steps2", str(tmp_path), device="cpu")


@pytest.mark.parametrize("quant", ["none", "int8_deep"])
def test_jax_ddim_grid_bundle_serves_in_port(setup, tmp_path, quant):
    """A step-distilled student's bundle as the JAX package exports it
    (sampler 'ddim_grid', calibrated on that trajectory): the port's
    sampler over its tables, fed the JAX package's x_T, lands within
    rel-L2 0.02 of the JAX package's served sample (the bound of the
    ancestral bundles, tests/test_torch_port_quant_diffusion.py), and the
    port's engine serves it deterministically."""
    sub = jdd.subgrid_schedule(setup["js"], (1, 3, 5))
    loaded = japi.LoadedModel(name="fastddpm_steps3", module=setup["jm"],
                              variables=setup["v"], kind="diffusion",
                              schedule=sub, sampler="ddim_grid")
    cond = noise((2, HW, HW, 2), 71) * 0.5
    path = jb._export_diffusion_bundle(
        str(tmp_path / "b"), loaded, quant=quant,
        calibration_batches=[jnp.asarray(cond)], image_size=(HW, HW))
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(cond)))
    params, meta = pb.load_bundle(path)
    assert meta["sampler"] == "ddim_grid"
    sched = params["schedule"]
    ps = pd.DiffusionSchedule(sched["betas"], sched["alphas"],
                              sched["alphas_cumprod"], sched["timesteps"])
    fwd = (FastDDPMForward(params["params"], device="cpu")
           if quant == "none" else FastDDPMForward(
               params["params"], pb._reflatten_int8_sites(params["int8"]),
               params["timesteps"], device="cpu"))
    x_t = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                       (2, HW, HW, 1), jnp.float32))
    got = pdd.sample_ddim_grid(fwd, torch.from_numpy(cond), None, ps,
                               noise=torch.from_numpy(x_t)).numpy()
    assert rel_l2(got, want) < 0.02
    apply = pb.make_bundle_apply(params, meta, device="cpu")
    y = apply(torch.from_numpy(cond))
    assert torch.equal(y, apply(torch.from_numpy(cond)))
    assert torch.equal(y, pdd.sample_ddim_grid(
        fwd, torch.from_numpy(cond), torch.Generator().manual_seed(0), ps))
