"""Serving distillation in the port against mrisr_tpu/serve/distill.py (CPU,
FEAT 4, 32^2, float32): one distill train step and the eval step after it
against the JAX package's raw steps (alpha, the SSIM term, the EMA), the
three teacher forwards against ``make_teacher_fn``, and the trainer's EMA
checkpoints (the averaged weights served, the live ones resumed)."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu.serve import distill as jdistill
from mrisr_tpu.serve import quant as jq
from mrisr_tpu.train.state import create_train_state as jax_train_state
from mrisr_tpu_torch.api import load_model
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.ckpt.torch_ckpt import reference_checkpoint
from mrisr_tpu_torch.config import PRESETS, ModelConfig, TrainConfig
from mrisr_tpu_torch.data.pipeline import build_loader
from mrisr_tpu_torch.data.synthetic import make_synthetic_store
from mrisr_tpu_torch.serve import calibrate_unet, quantize_unet
from mrisr_tpu_torch.serve.distill import (
    DistillationTrainer,
    make_distill_steps,
    make_teacher_fn,
)
from mrisr_tpu_torch.train import create_train_state
from torch_port_util import (
    adam_mu,
    check_updated,
    jax_init_model_jitted,
    jax_unet_variables,
    noise,
    port_unet,
    rel_l2,
)

torch.set_num_threads(2)

FEAT, HW, B = 4, 32, 4
LR = 1e-4
# the int8 error budget against the folded float forward
# (tests/test_quant.py:68,114)
INT8_VS_FLOAT = 0.15


def mean_teacher(x):
    """An analytic teacher, the same function in both packages: the mean
    of the two input slices."""
    return (x[..., 0:1] + x[..., 1:2]) / 2.0


@pytest.mark.parametrize("alpha,lambda_ssim,ema", [(0.3, 0.1, 0.9),
                                                   (1.0, 0.0, 0.0)])
def test_distill_steps_match_jax(alpha, lambda_ssim, ema):
    """One train step (loss and components rel 1e-5, gradients rel-L2
    1e-4, parameters, EMA and BatchNorm statistics 1e-6), then the eval
    step on the state it left, which scores the EMA weights when the EMA
    is on (rel 1e-5)."""
    v = jax_unet_variables(FEAT, HW, seed=41)
    rng = np.random.default_rng(42)
    batch = rng.random((B, HW, HW, 3), np.float32)

    jstate = jax_train_state(JaxUNet(features=FEAT), jax.tree.map(
        jnp.asarray, v), optax.adam(LR))
    if ema:
        jstate = jstate.replace(ema_params=jax.tree.map(jnp.copy,
                                                        jstate.params))
    j_train, j_eval = jdistill.make_distill_steps(
        mean_teacher, alpha=alpha, lambda_ssim=lambda_ssim, ema_decay=ema,
        jit_steps=False)
    jstate1, jm = jax.jit(j_train)(jstate, jnp.asarray(batch))
    j_eval_m = jax.jit(j_eval)(jstate1, jnp.asarray(batch))

    module = port_unet(v, FEAT).train()
    state = create_train_state(module, TrainConfig(learning_rate=LR))
    if ema:
        state.seed_ema()
    p_train, p_eval = make_distill_steps(mean_teacher, alpha=alpha,
                                         lambda_ssim=lambda_ssim,
                                         ema_decay=ema)
    _, pm = p_train(state, torch.from_numpy(batch))
    keys = {"loss", "teacher_mse", "gt_mse"} | (
        {"ssim_loss"} if lambda_ssim else set())
    assert set(pm) == set(jm) == keys
    for k in keys:
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k

    stats = jax.tree.map(np.asarray, jstate1.batch_stats)
    grads = unet_state_dict_from_flax({
        "params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                               adam_mu(jstate1.opt_state)),
        "batch_stats": stats})
    params = unet_state_dict_from_flax({
        "params": jax.tree.map(np.asarray, jstate1.params),
        "batch_stats": stats})
    check_updated(module, grads, params, LR)
    if ema:
        want = unet_state_dict_from_flax({
            "params": jax.tree.map(np.asarray, jstate1.ema_params),
            "batch_stats": stats})
        assert set(state.ema_params) == {n for n, _ in
                                         module.named_parameters()}
        for n, e in state.ema_params.items():
            # the average moves (1 - d) as far as the parameter: within
            # 1e-6, and an element whose step check_updated lets go either
            # way (a gradient of rounding noise) within (1 - d) 2 lr
            d = np.abs(e.numpy() - want[n].numpy())
            free = (np.abs(grads[n].numpy()) < 1e-6) | bool(
                re.search(r"\.conv\.[03]\.bias$", n))
            assert d[~free].max(initial=0) <= 1e-6, n
            assert d[free].max(initial=0) <= (1 - ema) * 2 * LR, n
    else:
        assert state.ema_params is None

    # the eval step from the JAX step's state: a gradient of rounding
    # noise moves a few elements either way (above), and in eval mode a
    # conv bias before BatchNorm no longer cancels
    module.load_state_dict(params)
    if ema:
        state.ema_params = {n: want[n] for n in state.ema_params}
    pe = p_eval(state, torch.from_numpy(batch))
    assert set(pe) == keys
    for k in keys:
        assert float(pe[k]) == pytest.approx(float(j_eval_m[k]),
                                             rel=1e-5), k


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_init():
    """The JAX package's ``load_model`` inits with its registry's
    ``init_model`` before it loads the checkpoint: jitted here."""
    import mrisr_tpu.api as japi

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "init_model", jax_init_model_jitted)
        yield


@pytest.fixture(scope="module")
def teacher_dir(tmp_path_factory):
    """A reference-layout ``unet_best.pt`` with non-trivial BatchNorm
    statistics, which both packages load."""
    w = tmp_path_factory.mktemp("teacher")
    v = jax_unet_variables(FEAT, HW, seed=43)
    torch.save(reference_checkpoint(port_unet(v, FEAT), "unet"),
               w / "unet_best.pt")
    return w


@pytest.mark.parametrize("quant", ["none", "int8", "int8_fused"])
def test_teacher_fn_matches_jax(teacher_dir, quant):
    """``make_teacher_fn`` on the same checkpoint.  'none' is float32 over
    bf16-rounded folded weights in both: rel-L2 1e-5.  The int8 teachers
    calibrate on the same batches; each package's bf16 calibration forward
    rounds in its own places, so the ranges agree to rtol 2^-7, and the
    port's teacher equals the JAX forward of the port's own tables (run op
    by op): the same codes out of kernel A's plain version (int8), within
    1e-5 through int8_fused's float32 final epilogue."""
    x = noise((3, HW, HW, 2), seed=44)
    calib = [noise((4, HW, HW, 2), seed=45)]
    kw = dict(models_dir=str(teacher_dir), quant=quant,
              calibration_batches=calib if quant != "none" else None)
    want = np.asarray(jax.jit(jdistill.make_teacher_fn(
        "unet", image_size=(HW, HW), cfg=JaxModelConfig(base_features=FEAT),
        **kw))(jnp.asarray(x)))
    got = make_teacher_fn("unet", cfg=ModelConfig(base_features=FEAT),
                          device="cpu", **kw)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, HW, HW, 1)
    got = got.numpy()
    if quant == "none":
        assert rel_l2(got, want) <= 1e-5
        return
    folded = load_model("unet", str(teacher_dir), checkpoint="required",
                        cfg=ModelConfig(base_features=FEAT), fold_bn=True,
                        device="cpu")
    with torch.no_grad():
        y_float = folded.module(torch.from_numpy(x)).numpy()
    assert rel_l2(got, y_float) < INT8_VS_FLOAT
    assert rel_l2(want, y_float) < INT8_VS_FLOAT
    ranges = calibrate_unet(folded.module, calib)
    tables = jax.tree.map(lambda t: np.asarray(t.float()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy(),
        quantize_unet(folded.module, ranges))
    if quant == "int8":
        ref = np.asarray(jq.unet_int8_apply(tables, jnp.asarray(x)))
        assert rel_l2(got, ref) == 0.0
    else:
        ref = np.asarray(jq.unet_int8_fused_apply(tables, jnp.asarray(x),
                                                  dtype=jnp.float32))
        assert rel_l2(got, ref) <= 1e-5
    with pytest.raises(ValueError, match="calibration_batches"):
        make_teacher_fn("unet", str(teacher_dir), quant=quant,
                        cfg=ModelConfig(base_features=FEAT), device="cpu")


def test_teacher_fn_refusals(teacher_dir, tmp_path):
    with pytest.raises(ValueError, match="unknown teacher quant"):
        make_teacher_fn("unet", str(teacher_dir), quant="int4",
                        cfg=ModelConfig(base_features=FEAT),
                        calibration_batches=[noise((1, HW, HW, 2), 0)],
                        device="cpu")
    with pytest.raises(FileNotFoundError):
        make_teacher_fn("unet", str(tmp_path), device="cpu")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("distillstore")
    return make_synthetic_store(str(d), num_patients=8, slices_per_volume=8,
                                height=HW, width=HW)


def _config(tmp, ema):
    base = PRESETS["unet_distilled"]
    return base.replace(
        data=dataclasses.replace(base.data, image_size=(HW, HW),
                                 batch_size=B, augment=False),
        model=dataclasses.replace(base.model, base_features=FEAT),
        loss=dataclasses.replace(base.loss, distill_ema=ema,
                                 distill_alpha=0.5),
        train=dataclasses.replace(
            base.train, epochs=2, compute_dtype="float32",
            checkpoint_dir=os.path.join(tmp, "models"),
            results_dir=os.path.join(tmp, "results")))


def test_trainer_ema_checkpoints_and_resume(store, tmp_path):
    """With the EMA on, every checkpoint serves the averaged weights
    (``model_state_dict``: what ``load_model`` and the JAX converter read)
    and carries the live ones (``live_params``); a resumed trainer has the
    live weights in its module and the average in ``ema_params``."""
    cfg = _config(str(tmp_path), ema=0.9)
    train = build_loader(store, "train", cfg.data, device="cpu")
    val = build_loader(store, "val", cfg.data, device="cpu")
    tr = DistillationTrainer(cfg, teacher_fn=mean_teacher,
                             steps_per_epoch=len(train), device="cpu")
    hist = tr.fit(train, val, epochs=1, verbose=False)
    for k in ("train_teacher_mse", "train_gt_mse", "val_teacher_mse"):
        assert len(hist.series[k]) == 1, k
    live = {n: p.detach().clone() for n, p in
            tr.state.module.named_parameters()}
    ema = {n: e.clone() for n, e in tr.state.ema_params.items()}
    assert any(not torch.equal(live[n], ema[n]) for n in live)

    ckpt = torch.load(os.path.join(cfg.train.checkpoint_dir,
                                   "unet_distilled_latest.pt"),
                      weights_only=True)
    assert "final_conv.weight" in ckpt["model_state_dict"]
    assert torch.equal(ckpt["model_state_dict"]["final_conv.weight"],
                       ema["final.weight"])
    assert torch.equal(ckpt["live_params"]["final_conv.weight"],
                       live["final.weight"])
    assert torch.equal(ckpt["model_state_dict"]["enc1.conv.1.running_mean"],
                       tr.state.module.enc1.conv[1].running_mean)
    jv = convert_torch_checkpoint("unet", ckpt)
    np.testing.assert_array_equal(
        np.asarray(jv["params"]["final"]["bias"]), ema["final.bias"].numpy())
    served = load_model("unet_distilled", cfg.train.checkpoint_dir,
                        checkpoint="required", cfg=cfg.model, device="cpu")
    for n, p in served.module.named_parameters():
        assert torch.equal(p, ema[n]), n

    tr2 = DistillationTrainer(cfg, teacher_fn=mean_teacher,
                              steps_per_epoch=len(train), device="cpu")
    assert tr2.try_resume() and tr2.start_epoch == 2
    for n, p in tr2.state.module.named_parameters():
        assert torch.equal(p, live[n]), n
        assert torch.equal(tr2.state.ema_params[n], ema[n]), n
    hist2 = tr2.fit(train, val, epochs=2, verbose=False)
    assert hist2.series["epoch"] == [1.0, 2.0]


def test_trainer_refuses_non_pair(tmp_path):
    cfg = _config(str(tmp_path), ema=0.0)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                name="progressive_unet"))
    with pytest.raises(ValueError, match="pair models only"):
        DistillationTrainer(cfg, teacher_fn=mean_teacher, device="cpu")
