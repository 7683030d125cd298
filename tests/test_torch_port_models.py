"""The port's ``UpConv2x2(impl='pixel_shuffle')`` / ``PixelShuffleUpConv``,
``max_pool_3x3_s1`` and ``param_count`` against mrisr_tpu's (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.config import PRESETS as JAX_PRESETS
from mrisr_tpu.config import ModelConfig as JaxModelConfig
from mrisr_tpu.models import blocks as jblocks
from mrisr_tpu.models import registry as jreg
from mrisr_tpu_torch.ckpt.from_jax import convt_weight
from mrisr_tpu_torch.config import PRESETS, ModelConfig
from mrisr_tpu_torch.models import blocks as pblocks
from mrisr_tpu_torch.models.registry import init_model, param_count
from torch_port_util import noise

torch.set_num_threads(2)

RTOL = ATOL = 1e-5  # float32
# bf16 compute: the product rounded to bf16 (one ulp is 2^-8 of a value in
# [1, 2)), then the bias added and rounded again, on both sides
BF16_TOL = 2 ** -7

CI, CO = 6, 4


def _upconv_params(seed=5):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, 2, CI, CO)).astype(np.float32)  # flax HWIO
    b = rng.standard_normal(CO).astype(np.float32)
    return w, b


def _port_upconv(impl, w, b, dtype=None):
    m = pblocks.UpConv2x2(CI, CO, impl=impl)
    with torch.no_grad():
        m.weight.copy_(convt_weight(w))
        m.bias.copy_(torch.from_numpy(b))
    return pblocks.set_compute_dtype(m, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_shuffle_upconv_matches_jax(dtype):
    """The flax kernel carried by ``convt_weight`` gives the JAX module's
    output, and the module keeps ``ConvTranspose2d``'s parameters."""
    w, b = _upconv_params()
    x = noise((2, 7, 9, CI), 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jblocks.PixelShuffleUpConv(CO, dtype=jdt).apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x)), np.float32)
    m = _port_upconv("pixel_shuffle", w, b,
                     None if dtype == "float32" else torch.bfloat16)
    assert isinstance(m, pblocks.PixelShuffleUpConv)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        "weight": (CI, CO, 2, 2), "bias": (CO,)}
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    tol = RTOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=tol, atol=tol)


def test_pixel_shuffle_equals_convt_and_takes_its_state_dict():
    """Both impls on one state dict, forward and input gradient; an unknown
    impl raises."""
    w, b = _upconv_params(seed=7)
    convt = _port_upconv("convt", w, b)
    shuffle = pblocks.UpConv2x2(CI, CO, impl="pixel_shuffle")
    shuffle.load_state_dict(convt.state_dict())
    assert type(convt) is pblocks.ConvTranspose2d
    outs = []
    for m in (convt, shuffle):
        x = torch.from_numpy(noise((3, CI, 5, 8), 1)).requires_grad_(True)
        y = m(x)
        (y * torch.from_numpy(noise(tuple(y.shape), 2))).sum().backward()
        outs.append((y.detach(), x.grad, m.weight.grad))
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="impl"):
        pblocks.UpConv2x2(CI, CO, impl="einsum")


def test_max_pool_3x3_s1_matches_jax_exactly():
    """Negative inputs: a zero padding would show at every border."""
    x = -np.abs(noise((2, 9, 11, 3), 4)) - 1.0
    want = np.asarray(jblocks.max_pool_3x3_s1(jnp.asarray(x)))
    got = pblocks.max_pool_3x3_s1(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


FAMILIES = ["unet", "unet_gan", "deepcnn", "progressive_unet", "fastddpm",
            "fastddpm_simple", "patchgan"]


@pytest.mark.parametrize("name", FAMILIES)
def test_param_count_matches_jax(name):
    """Width 4: the module's and its state dict's count (BatchNorm's
    buffers left out) equal JAX's count of ``variables['params']``."""
    jcfg = (JAX_PRESETS[name].model if name in JAX_PRESETS
            else JaxModelConfig(name=name))
    jcfg = dataclasses.replace(jcfg, base_features=4)
    shapes = jax.eval_shape(
        lambda: jreg.init_model(name, jcfg, image_size=(32, 32))[1])
    cfg = PRESETS[name].model if name in PRESETS else ModelConfig(name=name)
    model, _ = init_model(name, dataclasses.replace(cfg, base_features=4))
    want = jreg.param_count(shapes["params"])
    assert param_count(model) == want
    assert param_count(model.state_dict()) == want
    if "batch_stats" in shapes:
        assert len(model.state_dict()) > len(list(model.parameters()))

