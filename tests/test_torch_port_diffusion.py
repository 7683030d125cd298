"""The port's Fast-DDPM model, schedules and sampler against
mrisr_tpu/models/diffusion.py (CPU, fp32): the weight carry both ways, the
parameter count, every schedule table, and the ancestral chain fed the JAX
package's own draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrisr_tpu.ckpt import convert_torch_checkpoint
from mrisr_tpu.models import diffusion as jd
from mrisr_tpu_torch.ckpt.from_jax import (
    fastddpm_flax_params,
    fastddpm_state_dict_from_flax,
)
from mrisr_tpu_torch.models import diffusion as pd
from torch_port_util import (
    jax_chain_noise,
    jax_fastddpm_variables,
    noise,
    rel_l2,
)

BASE, TDIM, HW = 8, 16, 32

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    v = jax_fastddpm_variables(BASE, TDIM, HW, seed=3)
    port = pd.FastDDPMUNet(base_features=BASE, time_dim=TDIM)
    port.load_state_dict(fastddpm_state_dict_from_flax(v), strict=True)
    jax_model = jd.FastDDPMUNet(base_features=BASE, time_dim=TDIM)
    apply = jax.jit(lambda x, t: jax_model.apply(v, x, t))
    return {"v": v, "port": port.eval(), "jax_apply": apply}


@pytest.mark.parametrize("beta", ["linear", "cosine"])
@pytest.mark.parametrize("selection",
                         ["uniform", "nonuniform-4060", "linspace", "paper10"])
def test_schedules_equal(beta, selection):
    want = jd.DiffusionSchedule.create(1000, 10, beta, selection)
    got = pd.DiffusionSchedule.create(1000, 10, beta, selection)
    for k in ("betas", "alphas", "alphas_cumprod", "timesteps"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert got.timesteps.dtype == torch.int32
    assert got.num_inference_steps == want.num_inference_steps


@pytest.mark.parametrize("variant", ["ddpm", "simple"])
@pytest.mark.parametrize("dim", [128, 17])
def test_timestep_embedding(variant, dim):
    """atol 1e-6 where one ulp of the float32 argument t * freq is below
    it (t <= 7).  XLA's and torch's float32 exp differ by one ulp at a few
    frequencies, and at t = 999 one ulp of the argument is 6.1e-5, so the
    bound over all t is two such ulps."""
    t = np.array([0, 1, 7, 36, 500, 949, 999], np.int32)
    want = np.asarray(jd.timestep_embedding(jnp.asarray(t), dim, variant))
    got = pd.timestep_embedding(torch.from_numpy(t), dim, variant).numpy()
    assert got.shape == (7, dim)
    np.testing.assert_allclose(got[:3], want[:3], atol=1e-6)
    np.testing.assert_allclose(got, want, atol=2 * 999 * 2.0 ** -23)


def test_forward_matches_jax(models):
    x = noise((2, HW, HW, 3), seed=4)
    t = np.array([7, 900], np.int32)
    want = np.asarray(models["jax_apply"](jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = models["port"](torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, HW, HW, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_reverse_trip_through_torch_converter():
    """port state_dict -> the JAX package's reference-checkpoint converter
    -> FastDDPMUNet.apply equals the port's forward."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        port = pd.FastDDPMUNet(base_features=BASE, time_dim=TDIM).eval()
        with torch.no_grad():
            for m in port.modules():
                if isinstance(m, torch.nn.GroupNorm):
                    m.weight.copy_(1 + 0.2 * torch.randn_like(m.weight))
                    m.bias.copy_(0.1 * torch.randn_like(m.bias))
    v = convert_torch_checkpoint("fastddpm", {"model_state_dict":
                                              port.state_dict()})
    x = noise((2, HW, HW, 3), seed=6)
    t = np.array([0, 949], np.int32)
    want = np.asarray(jd.FastDDPMUNet(base_features=BASE, time_dim=TDIM)
                      .apply(v, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and the flax tree the serving code reads is the converter's layout
    tree = fastddpm_flax_params(port)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: a.numpy(), tree))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_array_equal(a, np.asarray(flat_want[path]),
                                      err_msg=str(path))


def test_parameter_count():
    port = pd.FastDDPMUNet(base_features=64, time_dim=128)
    n_port = sum(p.numel() for p in port.parameters())
    shapes = jax.eval_shape(
        jd.FastDDPMUNet(base_features=64, time_dim=128).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1,), jnp.int32))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n_port == n_jax == 13_899_905


@pytest.mark.parametrize("beta,timesteps,selection", [
    ("cosine", 1000, "nonuniform-4060"),  # the fastddpm preset's schedule
    ("linear", 50, "linspace"),
])
@pytest.mark.parametrize("combine", ["first", "mean"])
def test_sample_ancestral_with_jax_draws(models, beta, timesteps, selection,
                                         combine):
    steps = 10 if timesteps == 1000 else 4
    js = jd.DiffusionSchedule.create(timesteps, steps, beta, selection)
    ps = pd.DiffusionSchedule.create(timesteps, steps, beta, selection)
    cond = noise((2, HW, HW, 2), seed=8)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda c, k: jd.sample_ancestral(
        models["jax_apply"], c, k, js, num_samples=2, combine=combine))(
            jnp.asarray(cond), key))
    shape = (2, HW, HW, 1)
    if combine == "first":
        draws = jax_chain_noise(jax.random.fold_in(key, 0), shape, js)
    else:
        draws = [jax_chain_noise(k, shape, js)
                 for k in jax.random.split(key, 2)]
    with torch.no_grad():
        got = pd.sample_ancestral(models["port"], torch.from_numpy(cond),
                                  None, ps, num_samples=2, combine=combine,
                                  noise=draws).numpy()
    assert got.shape == shape
    assert rel_l2(got, want) < 1e-4


def test_sampler_generator_is_seeded(models):
    """Without noise, the chain draws from the generator: the same seed
    gives the same sample, another seed another one."""
    ps = pd.DiffusionSchedule.create(50, 3, "linear", "linspace")
    cond = torch.from_numpy(noise((1, HW, HW, 2), seed=10))
    with torch.no_grad():
        a, b, c = (pd.sample_ancestral(
            models["port"], cond, torch.Generator().manual_seed(s), ps)
            for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        pd.sample_ancestral(models["port"], cond, None, ps, combine="median")


def test_loaded_model_sample_is_its_call(models):
    """``LoadedModel.sample`` (``mrisr_tpu/api.py:LoadedModel.sample``): a
    diffusion model's NCHW sample, the same as calling it with the same
    generator; a pair model refuses it."""
    from mrisr_tpu_torch.api import LoadedModel
    from mrisr_tpu_torch.models import UNet

    cpu = torch.device("cpu")
    loaded = LoadedModel("fastddpm", models["port"], "diffusion", cpu,
                         schedule=pd.DiffusionSchedule.create(
                             50, 3, "linear", "linspace"))
    cond = noise((2, 2, HW, HW), seed=11)
    a = loaded.sample(cond, torch.Generator().manual_seed(4))
    b = loaded(cond, torch.Generator().manual_seed(4))
    assert a.shape == (2, 1, HW, HW) and torch.equal(a, b)
    assert torch.equal(loaded.sample(cond), loaded(cond))
    pair = LoadedModel("unet", UNet(features=4).eval(), "pair", cpu)
    with pytest.raises(AssertionError):
        pair.sample(cond)
