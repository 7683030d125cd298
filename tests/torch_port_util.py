"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py):
seeded flax UNet variables with non-trivial BatchNorm statistics, and the
numpy/bf16 bridge from jax trees to torch tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mrisr_tpu.models import UNet as JaxUNet
from mrisr_tpu_torch.ckpt import unet_state_dict_from_flax
from mrisr_tpu_torch.models import UNet


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jax_unet_variables(features: int, hw: int, seed: int = 0,
                       use_bias: bool = True) -> dict:
    """flax UNet variables with seeded, non-trivial BN scale/bias/stats
    (flax's init leaves them at 1/0/0/1, which would hide a BN mix-up)."""
    model = JaxUNet(features=features, use_bias=use_bias)
    # jitted: the same variables as the eager init, in a quarter of the time
    v = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 2)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for name, sub in params.items():
        for bn in ("BatchNorm_0", "BatchNorm_1"):
            if bn not in sub:
                continue
            c = sub[bn]["scale"].shape[0]
            sub[bn]["scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(
                np.float32)
            sub[bn]["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            stats[name][bn]["mean"] = (0.1 * rng.standard_normal(c)).astype(
                np.float32)
            stats[name][bn]["var"] = (0.5 + rng.random(c)).astype(np.float32)
        for cn in ("Conv_0", "Conv_1"):
            if cn in sub and "bias" in sub[cn]:
                sub[cn]["bias"] = (0.05 * rng.standard_normal(
                    sub[cn]["bias"].shape)).astype(np.float32)
    return {"params": params, "batch_stats": stats}


def port_unet(variables: dict, features: int, use_bias: bool = True):
    """The port UNet carrying ``variables`` (unfolded or folded), eval."""
    folded = "BatchNorm_0" not in variables["params"]["enc1"]
    model = UNet(features=features, use_bias=use_bias, use_bn=not folded)
    model.load_state_dict(unet_state_dict_from_flax(variables))
    return model.eval()


def flax_unet_variables(model) -> dict:
    """A port ``UNet`` (with BatchNorm) -> flax ``{'params',
    'batch_stats'}`` as numpy: the inverse of
    ``unet_state_dict_from_flax``."""
    from mrisr_tpu_torch.ckpt.from_jax import (conv_kernel_hwio,
                                               convt_kernel_hwio)
    from mrisr_tpu_torch.models.unet import BLOCKS_DOWN, BLOCKS_UP

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params, stats = {}, {}

    def a(t):
        return np.ascontiguousarray(t.numpy(), np.float32)

    for name in (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP):
        params[name], stats[name] = {}, {}
        for i, idx in enumerate((0, 3)):
            conv = {"kernel": a(conv_kernel_hwio(sd[f"{name}.conv.{idx}.weight"]))}
            if f"{name}.conv.{idx}.bias" in sd:
                conv["bias"] = a(sd[f"{name}.conv.{idx}.bias"])
            params[name][f"Conv_{i}"] = conv
            p = f"{name}.conv.{idx + 1}"
            params[name][f"BatchNorm_{i}"] = {"scale": a(sd[f"{p}.weight"]),
                                              "bias": a(sd[f"{p}.bias"])}
            stats[name][f"BatchNorm_{i}"] = {"mean": a(sd[f"{p}.running_mean"]),
                                             "var": a(sd[f"{p}.running_var"])}
    for lvl in (4, 3, 2, 1):
        params[f"upconv{lvl}"] = {
            "kernel": a(convt_kernel_hwio(sd[f"upconv{lvl}.weight"])),
            "bias": a(sd[f"upconv{lvl}.bias"])}
    params["final"] = {"kernel": a(conv_kernel_hwio(sd["final.weight"])),
                       "bias": a(sd["final.bias"])}
    return {"params": params, "batch_stats": stats}


def jit_exact(f):
    """``jax.jit(f)`` compiled with XLA's excess precision off, so that
    every op of a bf16 program rounds to bf16 as the flax modules write it
    (by default jit keeps a fusion's bf16 intermediates in float32 on the
    CPU, rounding fewer times than the module's ops do)."""
    def call(*args):
        return jax.jit(f).lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})(*args)
    return call


def to_torch_tree(tree):
    """jax/numpy tree -> torch tensors, bf16 kept as bf16."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def noise(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_fastddpm_variables(base: int, time_dim: int, hw: int,
                           seed: int = 0) -> dict:
    """flax FastDDPMUNet variables with seeded, non-trivial GroupNorm
    scale/bias and conv/dense biases (flax's init leaves them at 1/0)."""
    from mrisr_tpu.models.diffusion import FastDDPMUNet as JaxFastDDPM

    model = JaxFastDDPM(base_features=base, time_dim=time_dim)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed),
                            jnp.zeros((1, hw, hw, 3)), jnp.zeros((1,),
                                                                 jnp.int32))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return {"params": jax.tree_util.tree_map_with_path(perturb, v["params"])}


def jax_chain_noise(key, shape, schedule):
    """The draws of one chain of ``mrisr_tpu``'s ``sample_ancestral`` under
    ``key`` (its ``one_chain``): x_T and z for every step but the last, in
    iteration order, as numpy."""
    k_init, k_loop = jax.random.split(key)
    x_t = np.array(jax.random.normal(k_init, shape, jnp.float32))
    ts = np.asarray(schedule.timesteps)[::-1][:-1]
    zs = [np.array(jax.random.normal(jax.random.fold_in(k_loop, int(t)),
                                       shape, jnp.float32)) for t in ts]
    return x_t, zs


def perturbed(variables: dict, seed: int) -> dict:
    """flax variables as numpy with seeded, non-trivial norm scales and
    biases, BatchNorm statistics and conv/dense biases (flax's init leaves
    them at 1/0/0/1, which would hide a mix-up)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, dict(variables))


def jax_seeded_variables(model, *inputs, seed: int = 0, **kw) -> dict:
    """A flax module's variables as numpy without compiling its init: the
    shapes from ``jax.eval_shape``, each leaf N(0, 1 / fan_in) (fan_in:
    all dims but the last) from a seeded numpy generator, then norm
    scales, biases and statistics as :func:`perturbed` makes them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *x: model.init(
        jax.random.PRNGKey(0), *x, **kw), *inputs)

    def leaf(s):
        fan_in = max(1, int(np.prod(s.shape[:-1])))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return perturbed(jax.tree.map(leaf, shapes), seed)


def jax_init(model, *inputs, seed: int = 0, **kw) -> dict:
    """A flax module's variables (jitted init) as perturbed numpy."""
    v = jax.jit(lambda key, *x: model.init(key, *x, **kw))(
        jax.random.PRNGKey(seed), *inputs)
    return perturbed(jax.tree.map(np.asarray, v), seed)


def adam_mu(opt_state):
    """``mu`` of the Adam state inside an optax state (plain, chained
    after a clip, or AdamW's chain)."""
    import optax

    def is_adam(s):
        return isinstance(s, optax.ScaleByAdamState)

    return next(s for s in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=is_adam)
                if is_adam(s)).mu


def param_count(tree) -> int:
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))


def check_updated(module, grads: dict, params: dict, lr: float) -> None:
    """A port module after one Adam step against the JAX step's: each
    gradient (``.grad``, clipped where the optimizer clips) within rel-L2
    1e-4 of ``grads`` (the JAX ``mu / 0.1``, torch names), each parameter
    within 1e-6 of ``params`` (an element whose gradient is rounding noise,
    under 1e-6, may move by about lr either way), BatchNorm running
    statistics within 1e-6.  A conv bias right before a training-mode
    BatchNorm has a zero gradient in exact arithmetic (the batch mean
    removes it): both sides must hold only noise far below the weight's."""
    import re

    named = dict(module.named_parameters())
    for name, p in named.items():
        g = p.grad.numpy()
        before_bn = re.search(r"\.conv\.[03]\.bias$", name) is not None
        if before_bn:
            wg = named[name[:-4] + "weight"].grad
            assert np.linalg.norm(g) <= 1e-4 * float(wg.norm()), name
            assert np.linalg.norm(grads[name].numpy()) <= 1e-4 * float(
                wg.norm()), name
        else:
            assert rel_l2(g, grads[name].numpy()) <= 1e-4, name
        d = np.abs(p.detach().numpy() - params[name].numpy())
        tiny = (np.abs(grads[name].numpy()) < 1e-6) | before_bn
        assert d[~tiny].max(initial=0) <= 1e-6, name
        assert d[tiny].max(initial=0) <= 2 * lr, name
    for name, b in module.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), params[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def jax_init_model_jitted(name, cfg=None, dtype=jnp.float32,
                          image_size=(256, 256), seed: int = 0):
    """``mrisr_tpu.models.registry.init_model`` with the flax init jitted:
    the same variables, without the ~30 s eager init on the CPU (the JAX
    package's ``load_model`` inits before it loads a checkpoint)."""
    from mrisr_tpu.models.registry import create_model

    model, kind = create_model(name, cfg, dtype)
    h, w = image_size
    key = jax.random.PRNGKey(seed)
    if kind == "diffusion":
        v = jax.jit(model.init)(key, jnp.zeros((1, h, w, 3), jnp.float32),
                                jnp.zeros((1,), jnp.int32))
    else:
        c = 5 if kind == "window" else 3 if name == "patchgan" else 2
        v = jax.jit(lambda k, x: model.init(k, x, train=False))(
            key, jnp.zeros((1, h, w, c), jnp.float32))
    return model, v, kind
