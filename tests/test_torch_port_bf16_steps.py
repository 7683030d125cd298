"""One bf16 train step of each of the six families in the port against
the JAX package's bf16 step (CPU, FEAT = 4, 32^2, batch 4), from the same
weights and batch: losses, gradients and BatchNorm statistics, each side
held to the port's float32 step (which ``tests/test_torch_port_{train,gan,
progressive,diffusion_train}.py`` hold to the JAX float32 step).  The JAX
step runs compiled with XLA's excess precision off
(``torch_port_util.jit_exact``), so its ops round as the flax modules write
them."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu import losses as jax_losses
from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.losses.perceptual import make_perceptual_fn as jax_perceptual
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu.models.registry import create_model as jax_create_model
from mrisr_tpu.train import steps as jax_steps
from mrisr_tpu.train.state import create_train_state as jax_train_state
from mrisr_tpu.train.state import make_optimizer as jax_make_optimizer
from mrisr_tpu_torch.ckpt.from_jax import (
    deepcnn_state_dict_from_flax,
    fastddpm_state_dict_from_flax,
    patchgan_state_dict_from_flax,
    progressive_state_dict_from_flax,
    simple_diffusion_state_dict_from_flax,
    unet_state_dict_from_flax,
)
from mrisr_tpu_torch.config import Config
from mrisr_tpu_torch.losses.perceptual import make_perceptual_fn
from mrisr_tpu_torch.train import (
    DiffusionTrainer,
    GANTrainer,
    SupervisedTrainer,
)
from torch_port_util import adam_mu, jax_init, jit_exact, rel_l2

torch.set_num_threads(2)

FEAT, HW, B, TDIM = 4, 32, 4, 16
CARRY = {"unet_combined": unet_state_dict_from_flax,
         "unet_gan": unet_state_dict_from_flax,
         "patchgan": patchgan_state_dict_from_flax,
         "deepcnn": deepcnn_state_dict_from_flax,
         "progressive_unet": progressive_state_dict_from_flax,
         "fastddpm": fastddpm_state_dict_from_flax,
         "fastddpm_simple": simple_diffusion_state_dict_from_flax}
CHANNELS = {"progressive_unet": 5}


def jax_model_cfg(name):
    base = JAX_PRESETS[name].model if name in JAX_PRESETS else (
        JAX_PRESETS["unet_gan"].model)
    return dataclasses.replace(base, base_features=FEAT,
                               **({"time_dim": TDIM} if name == "fastddpm"
                                  else {}))


# The bf16 step's losses within rel 1e-2 of the JAX bf16 step's (bf16's
# unit roundoff is 3.9e-3).  Gradients, as one vector over each group of
# tensors, rel-L2 against the port's float32 step:
# - weights and norm parameters: the port's bf16 distance P and JAX's J
#   are both bf16 rounding of the same step, J / 4 <= P <= 2 J (a step
#   that skipped bf16 would sit at P ~ 0), and port vs JAX within
#   max(P, J).  Measured P / J 0.56-1.07 over the families, port vs JAX
#   0.13-0.83 of max(P, J): the GroupNorm and BatchNorm statistics' float32
#   sums flip single roundings that the backward spreads, as in the
#   forward.
# - conv, transposed-conv and dense biases that no training-mode BatchNorm
#   follows: JAX's CPU backend sums their bf16 cotangent in bf16 (4096
#   values near 1 sum to 512 there), so JAX's are up to 0.75 off float32
#   (the UNet's final bias); the port sums in float32 and is held within
#   5e-2 of the float32 step (measured at most 2.5e-2).
# - a conv bias right before a training-mode BatchNorm: zero in exact
#   arithmetic (the batch mean removes it), noise on every side: skipped.
# BatchNorm running statistics within 1e-2 of JAX's (measured 3e-3).
LOSS_RTOL, BAND, PORT_VS_JAX, BIAS_RTOL, STATS_ATOL = 1e-2, (0.25, 2.0), \
    1.0, 5e-2, 1e-2
PRE_BN_BIAS = re.compile(r"(^|\.)conv\.[03]\.bias$")


def train_cfg(preset, dtype):
    base = JAX_PRESETS[preset]
    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, image_size=(HW, HW), batch_size=B,
                                 augment=False),
        model=jax_model_cfg(preset),
        train=dataclasses.replace(base.train, compute_dtype=dtype))


def port_cfg(jcfg, tmp) -> Config:
    cfg = Config.from_dict(json.loads(jcfg.to_json()))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(tmp, "models"),
        results_dir=os.path.join(tmp, "results")))


def _summed_biases(modules: dict) -> set:
    """Names of the biases of convs, transposed convs and dense layers
    that no training-mode BatchNorm follows."""
    out = set()
    for prefix, module in modules.items():
        for name, m in module.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)) and m.bias is not None:
                key = f"{name}.bias"
                if not PRE_BN_BIAS.search(key):
                    out.add(prefix + key)
    return out


def _jax_step(preset, batch, weights):
    """The JAX package's unjitted bf16 step (jitted here whole): metrics,
    gradients (Adam's first moment / 0.1) and BN statistics in the port's
    names, and the diffusion draws."""
    jcfg = train_cfg(preset, "bfloat16")
    lc, tc = jcfg.loss, jcfg.train

    def tree(state):
        stats = jax.tree.map(np.asarray, state.batch_stats or {})
        return ({"params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                        adam_mu(state.opt_state)),
                 "batch_stats": stats},
                {"params": jax.tree.map(np.asarray, state.params),
                 "batch_stats": stats})

    if preset == "unet_gan":
        gen = jax_create_model("unet_gan", jcfg.model, jnp.bfloat16)[0]
        disc = jax_create_model("patchgan", jcfg.model, jnp.bfloat16)[0]
        raw, _ = jax_steps.make_gan_steps(
            perceptual_fn=jax_perceptual("gabor"), lambda_l1=lc.lambda_l1,
            lambda_perceptual=lc.lambda_perceptual,
            lambda_adversarial=lc.lambda_adversarial, jit_steps=False)
        g0 = jax_train_state(gen, jax.tree.map(jnp.asarray, weights["G."]),
                             jax_make_optimizer(tc))
        d0 = jax_train_state(disc, jax.tree.map(jnp.asarray, weights["D."]),
                             jax_make_optimizer(
                                 tc, learning_rate=tc.learning_rate_d))
        g1, d1, metrics = jit_exact(raw)(g0, d0, jnp.asarray(batch))
        states = {"G.": (g1, "unet_gan"), "D.": (d1, "patchgan")}
        draws = None
    else:
        model = jax_create_model(preset, jcfg.model, jnp.bfloat16)[0]
        draws = None
        if preset == "unet_combined":
            raw, _ = jax_steps.make_supervised_steps(
                lambda p, t: jax_losses.combined_loss(
                    p, t, perceptual_fn=jax_perceptual("gabor"),
                    lambda_perceptual=lc.lambda_perceptual,
                    lambda_ssim=lc.lambda_ssim), jit_steps=False)
        elif preset == "deepcnn":
            raw, _ = jax_steps.make_supervised_steps(
                lambda p, t: (jax_losses.mse(p, t), {}), jit_steps=False)
        elif preset == "progressive_unet":
            raw, _ = jax_steps.make_progressive_steps(
                lambda p, w: jax_losses.progressive_loss(
                    p, w, lc.w_i1, lc.w_i2, lc.w_i3), jit_steps=False)
        elif preset == "fastddpm":
            sched = jd.DiffusionSchedule.create(
                jcfg.model.num_timesteps, jcfg.model.num_inference_steps,
                jcfg.model.beta_schedule, jcfg.model.timestep_selection)
            raw, _ = jax_steps.make_diffusion_steps(sched, jit_steps=False)
            n_sel = sched.num_inference_steps
        else:
            sched = jd.FastNoiseSchedule.create(
                jcfg.model.num_inference_steps)
            raw, _ = jax_steps.make_simple_diffusion_steps(
                sched, jit_steps=False)
            n_sel = sched.T
        s0 = jax_train_state(model, jax.tree.map(jnp.asarray, weights[""]),
                             jax_make_optimizer(tc))
        if preset.startswith("fastddpm"):
            key = jax.random.PRNGKey(21)
            s1, metrics = jit_exact(raw)(s0, jnp.asarray(batch), key)
            k_t, k_n = jax.random.split(key)
            t = jax.random.randint(k_t, (B // 2 + 1,), 0, n_sel)
            draws = (np.asarray(jnp.concatenate([t, n_sel - t - 1])[:B],
                                np.int64),
                     np.asarray(jax.random.normal(k_n, (B, HW, HW, 1),
                                                  jnp.float32)))
        else:
            s1, metrics = jit_exact(raw)(s0, jnp.asarray(batch))
        states = {"": (s1, preset)}
    grads, stats = {}, {}
    for prefix, (state, name) in states.items():
        g, new = tree(state)
        grads.update({prefix + k: v.numpy() for k, v in
                      CARRY[name](g).items() if "running" not in k
                      and "num_batches" not in k})
        stats.update({prefix + k: v.numpy() for k, v in
                      CARRY[name](new).items() if "running" in k})
    return {k: float(v) for k, v in metrics.items()}, grads, stats, draws


def _port_step(preset, dtype, batch, weights, draws, tmp):
    """One port train step in ``dtype`` compute from ``weights``: metrics,
    gradients, BN statistics and the trained modules by prefix."""
    cfg = port_cfg(train_cfg(preset, dtype), tmp)
    if preset == "unet_gan":
        tr = GANTrainer(cfg, perceptual_fn=make_perceptual_fn("gabor"),
                        device="cpu")
        modules = {"G.": tr.g_state.module, "D.": tr.d_state.module}
        carry = {"G.": unet_state_dict_from_flax,
                 "D.": patchgan_state_dict_from_flax}
    elif preset.startswith("fastddpm"):
        tr = DiffusionTrainer(cfg, device="cpu")
        modules, carry = {"": tr.state.module}, {"": CARRY[preset]}
    else:
        tr = SupervisedTrainer(cfg, perceptual_fn=make_perceptual_fn("gabor")
                               if preset == "unet_combined" else None,
                               device="cpu")
        modules, carry = {"": tr.state.module}, {"": CARRY[preset]}
    for prefix, module in modules.items():
        module.load_state_dict(carry[prefix](weights[prefix]), strict=True)
    x = torch.tensor(batch)
    if preset == "unet_gan":
        metrics = tr.train_step(tr.g_state, tr.d_state, x)[-1]
    elif draws is not None:
        metrics = tr.train_step.train_on(tr.state, x, torch.tensor(draws[0]),
                                         torch.tensor(draws[1]))[1]
    else:
        metrics = tr.train_step(tr.state, x)[1]
    grads, stats = {}, {}
    for prefix, module in modules.items():
        grads.update({prefix + n: p.grad.numpy()
                      for n, p in module.named_parameters()})
        stats.update({prefix + n: b.numpy() for n, b in
                      module.named_buffers() if "running" in n})
    return {k: float(v) for k, v in metrics.items()}, grads, stats, modules


def _weights(preset):
    """Seeded, perturbed float32 flax variables by the port's prefixes."""
    if preset == "unet_gan":
        jcfg = jax_model_cfg("unet_gan")
        return {"G.": jax_init(jax_create_model("unet_gan", jcfg)[0],
                               jnp.zeros((1, HW, HW, 2)), seed=4,
                               train=False),
                "D.": jax_init(jax_create_model("patchgan", jcfg)[0],
                               jnp.zeros((1, HW, HW, 3)), seed=5,
                               train=False)}
    model = jax_create_model(preset, jax_model_cfg(preset))[0]
    if preset.startswith("fastddpm"):
        return {"": jax_init(model, jnp.zeros((1, HW, HW, 3)),
                             jnp.zeros((1,), jnp.int32), seed=2)}
    return {"": jax_init(model, jnp.zeros(
        (1, HW, HW, CHANNELS.get(preset, 2))), seed=1, train=False)}


def _group_rel(keys, a, b):
    return rel_l2(np.concatenate([a[k].ravel() for k in keys]),
                  np.concatenate([b[k].ravel() for k in keys]))


@pytest.mark.parametrize("preset", ["unet_combined", "unet_gan", "deepcnn",
                                    "progressive_unet", "fastddpm",
                                    "fastddpm_simple"])
def test_bf16_train_step_matches_jax(preset, tmp_path):
    batch = (0.4 + 0.3 * np.random.default_rng(0).standard_normal(
        (B, HW, HW, 5 if preset == "progressive_unet" else 3))).astype(
            np.float32)
    weights = _weights(preset)
    jax_m, jax_g, jax_s, draws = _jax_step(preset, batch, weights)
    m16, g16, s16, modules = _port_step(preset, "bfloat16", batch, weights,
                                        draws, str(tmp_path / "bf16"))
    m32, g32, s32, _ = _port_step(preset, "float32", batch, weights, draws,
                                  str(tmp_path / "f32"))
    assert all(p.dtype == torch.float32 for m in modules.values()
               for p in m.parameters())
    assert set(m16) == set(jax_m)
    for k, want in jax_m.items():
        assert m16[k] == pytest.approx(want, rel=LOSS_RTOL), k
        assert m32[k] == pytest.approx(want, rel=LOSS_RTOL), k

    summed = _summed_biases(modules)
    weights_and_norms = [k for k in g16 if k not in summed
                         and not PRE_BN_BIAS.search(k)]
    p = _group_rel(weights_and_norms, g16, g32)
    j = _group_rel(weights_and_norms, jax_g, g32)
    assert BAND[0] * j <= p <= BAND[1] * j, (p, j)
    assert _group_rel(weights_and_norms, g16, jax_g) <= PORT_VS_JAX * max(p, j)
    if summed:
        assert _group_rel(sorted(summed), g16, g32) <= BIAS_RTOL
    for k, want in jax_s.items():
        np.testing.assert_allclose(s16[k], want, rtol=0, atol=STATS_ATOL,
                                   err_msg=k)
