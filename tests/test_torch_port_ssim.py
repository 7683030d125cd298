"""Port SSIM/PSNR against mrisr_tpu's (CPU): the plain path against the XLA
path (2e-5) and the Pallas kernel in interpret mode (3e-5,
tests/test_ssim.py's contract), the K1 wrapper's CPU route, PSNR, and the
SSIM loss's gradient against jax.grad."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrisr_tpu.ops.ssim import psnr as jax_psnr
from mrisr_tpu.ops.ssim import ssim as jax_ssim
from mrisr_tpu.ops.ssim import ssim_loss as jax_ssim_loss
from mrisr_tpu.ops.ssim_pallas import ssim_pallas
from mrisr_tpu_torch.ops.ssim import psnr, ssim, ssim_loss, ssim_map
from mrisr_tpu_torch.ops.ssim_fused import ssim_fused, ssim_fused_plain

torch.set_num_threads(2)

SHAPES = [(5, 32, 32), (3, 37, 53), (2, 7, 7)]


def pair(shape, seed):
    """A correlated pair in [0, 1]: y = x plus noise, clipped."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssim_matches_xla_and_pallas(shape):
    x, y = pair(shape, seed=sum(shape))
    got = ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == shape[:1]
    np.testing.assert_allclose(got, np.asarray(jax_ssim(x, y)), atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(ssim_pallas(x, y, interpret=True)), atol=3e-5)


@pytest.mark.parametrize("win,data_range", [(3, 1.0), (11, 2.0)])
def test_ssim_window_and_range_match_pallas(win, data_range):
    x, y = pair((2, 24, 20), seed=win)
    x, y = x * data_range, y * data_range
    got = ssim_fused_plain(torch.from_numpy(x), torch.from_numpy(y),
                           data_range=data_range, win_size=win).numpy()
    want = np.asarray(ssim_pallas(x, y, data_range=data_range, win_size=win,
                                  interpret=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_ssim_of_identical_images_is_one():
    x, _ = pair((2, 16, 16), seed=1)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ssim(t, t).numpy(), 1.0, atol=1e-6)


def test_ssim_keeps_leading_dims():
    x, y = pair((2, 3, 16, 16), seed=2)
    assert ssim(torch.from_numpy(x), torch.from_numpy(y)).shape == (2, 3)
    assert ssim_map(torch.from_numpy(x), torch.from_numpy(y)).shape == (
        2, 3, 10, 10)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    x, y = pair((3, 37, 53), seed=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = ssim_fused.launches
    got = ssim_fused(xt, yt)
    assert ssim_fused.launches == before  # no kernel on a CPU tensor
    torch.testing.assert_close(got, ssim_fused_plain(xt, yt), rtol=0, atol=0)


def test_ssim_use_kernel_routes_on_cpu():
    x, y = pair((2, 16, 16), seed=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    torch.testing.assert_close(ssim(xt, yt), ssim(xt, yt, use_kernel=False),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ssim(xt, yt, use_kernel=True)
    with pytest.raises(ValueError, match="shapes differ"):
        ssim(xt, yt[:, :8])


def test_psnr_matches_jax_including_inf():
    x, y = pair((4, 20, 24), seed=5)
    y[1] = x[1]  # identical image: inf, kept unclamped
    got = psnr(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jax_psnr(x, y))
    assert np.isinf(got[1]) and np.isinf(want[1])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ssim_loss_and_grad_match_jax():
    x, y = pair((3, 24, 24), seed=6)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ssim_loss(xt, torch.from_numpy(y))
    loss.backward()
    want_loss, want_grad = jax.value_and_grad(jax_ssim_loss)(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5)
