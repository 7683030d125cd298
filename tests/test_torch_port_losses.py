"""Port losses against mrisr_tpu's (CPU): values and gradients of the MSE,
L1, LSGAN, combined (with and without the Gabor/LoG term) and progressive
losses, the Gabor bank itself, VGG16 features from a temporary random npz
that both packages read, and the perceptual factory's selection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu import losses as jl
from mrisr_tpu.losses import perceptual as jperc
from mrisr_tpu.losses import vgg as jvgg
from mrisr_tpu_torch import losses as pl
from mrisr_tpu_torch.losses import perceptual as pperc
from mrisr_tpu_torch.losses import vgg as pvgg
from torch_port_util import noise

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _pair(shape, seed=0):
    p = noise(shape, seed)
    t = 0.7 * p + 0.5 * noise(shape, seed + 1)  # correlated, so SSIM is not 0
    return p, t


def _port_value_grad(fn, p, t):
    x = torch.from_numpy(p).requires_grad_(True)
    out = fn(x, torch.from_numpy(t))
    total = out[0] if isinstance(out, tuple) else out
    total.backward()
    return out, x.grad.numpy()


def _jax_value_grad(fn, p, t):
    def scalar(x):
        out = fn(x, jnp.asarray(t))
        return (out[0] if isinstance(out, tuple) else out), out

    (_, out), g = jax.value_and_grad(scalar, has_aux=True)(jnp.asarray(p))
    return out, np.asarray(g)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["mse", "l1", "lsgan_d", "lsgan_g"])
def test_elementary_losses_match_jax(name):
    p, t = _pair((4, 32, 32, 1), seed=3)
    fns = {"mse": (pl.mse, jl.mse), "l1": (pl.l1, jl.l1),
           "lsgan_d": (pl.lsgan_d_loss, jl.lsgan_d_loss),
           "lsgan_g": (lambda a, b: pl.lsgan_g_loss(a),
                       lambda a, b: jl.lsgan_g_loss(a))}
    port_fn, jax_fn = fns[name]
    got, g_got = _port_value_grad(port_fn, p, t)
    want, g_want = _jax_value_grad(jax_fn, p, t)
    _close(got.detach(), want)
    _close(g_got, g_want)


def test_filter_bank_is_the_jax_bank():
    np.testing.assert_array_equal(pperc._filter_bank(), jperc._filter_bank())
    np.testing.assert_array_equal(pperc._gaussian_blur_kernel(),
                                  jperc._gaussian_blur_kernel())


@pytest.mark.parametrize("shape", [(4, 32, 32, 1), (2, 12, 20, 1),
                                   (3, 16, 16, 1)])
def test_gabor_perceptual_matches_jax(shape):
    """Three pyramid levels; the small levels hit the crop cap."""
    p, t = _pair(shape, seed=5)
    got, g_got = _port_value_grad(pperc.make_gabor_perceptual_fn(), p, t)
    want, g_want = _jax_value_grad(jperc.make_gabor_perceptual_fn(), p, t)
    _close(got.detach(), want)
    _close(g_got, g_want)


@pytest.mark.parametrize("with_gabor", [False, True])
def test_combined_loss_matches_jax(with_gabor):
    p, t = _pair((4, 32, 32, 1), seed=7)
    pf = pperc.make_gabor_perceptual_fn() if with_gabor else None
    jf = jperc.make_gabor_perceptual_fn() if with_gabor else None
    (got, got_c), g_got = _port_value_grad(
        lambda a, b: pl.combined_loss(a, b, perceptual_fn=pf), p, t)
    (want, want_c), g_want = _jax_value_grad(
        lambda a, b: jl.combined_loss(a, b, perceptual_fn=jf), p, t)
    assert set(got_c) == set(want_c) == (
        {"mse", "ssim", "perceptual"} if with_gabor else {"mse", "ssim"})
    _close(got.detach(), want)
    for k in want_c:
        _close(got_c[k].detach(), want_c[k])
    _close(g_got, g_want)


def test_progressive_loss_matches_jax():
    window = noise((2, 16, 16, 5), 11)
    preds = [noise((2, 16, 16, 1), 12 + i) for i in range(3)]
    tp = [torch.from_numpy(a).requires_grad_(True) for a in preds]
    got, got_c = pl.progressive_loss(tp, torch.from_numpy(window))
    got.backward()

    def f(ps):
        return jl.progressive_loss(ps, jnp.asarray(window))

    (want, want_c), grads = jax.value_and_grad(
        lambda ps: (f(ps)[0], f(ps)[1]), has_aux=True)(
        tuple(jnp.asarray(a) for a in preds))
    assert set(got_c) == set(want_c)
    _close(got.detach(), want)
    for k in want_c:
        _close(got_c[k].detach(), want_c[k])
    for a, g in zip(tp, grads):
        _close(a.grad, g)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """Random VGG16 conv weights in the JAX package's npz layout (HWIO)."""
    rng = np.random.default_rng(0)
    plan = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
            (256, 256), (256, 256)]
    arrs = {}
    for i, (ci, co) in enumerate(plan):
        arrs[f"conv{i}_kernel"] = (rng.standard_normal((3, 3, ci, co))
                                   * (1.0 / (9 * ci)) ** 0.5).astype(np.float32)
        arrs[f"conv{i}_bias"] = (0.05 * rng.standard_normal(co)).astype(
            np.float32)
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    np.savez(path, **arrs)
    return path


def test_vgg_perceptual_matches_jax(vgg_npz):
    p, t = _pair((2, 16, 16, 1), seed=9)
    got, g_got = _port_value_grad(pvgg.make_perceptual_fn(vgg_npz), p, t)
    want, g_want = _jax_value_grad(jvgg.make_perceptual_fn(vgg_npz), p, t)
    _close(got.detach(), want)
    _close(g_got, g_want)


def test_perceptual_factory_selection(vgg_npz, monkeypatch):
    monkeypatch.delenv("MRISR_VGG16_NPZ", raising=False)
    p, t = (torch.from_numpy(a) for a in _pair((2, 16, 16, 1), seed=2))
    gabor = pperc.make_gabor_perceptual_fn()(p, t)
    assert torch.equal(pperc.make_perceptual_fn("auto")(p, t), gabor)
    with pytest.raises(FileNotFoundError, match="MRISR_VGG16_NPZ"):
        pperc.make_perceptual_fn("vgg")
    with pytest.raises(ValueError, match="unknown perceptual kind"):
        pperc.make_perceptual_fn("nope")
    vgg = pvgg.make_perceptual_fn(vgg_npz)(p, t)
    monkeypatch.setenv("MRISR_VGG16_NPZ", vgg_npz)
    assert torch.equal(pperc.make_perceptual_fn("auto")(p, t), vgg)
    assert torch.equal(pperc.make_perceptual_fn("vgg")(p, t), vgg)
    # 'vgg-random' ignores the variable, and is the same each time
    r1 = pperc.make_perceptual_fn("vgg-random")(p, t)
    r2 = pperc.make_perceptual_fn("vgg-random")(p, t)
    assert torch.equal(r1, r2) and not torch.equal(r1, vgg)
    assert torch.isfinite(r1) and float(r1) > 0


# torchvision's vgg16().features convs: (index, C_in, C_out)
TORCHVISION_VGG16 = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
                     (10, 128, 256), (12, 256, 256), (14, 256, 256),
                     (17, 256, 512), (19, 512, 512), (21, 512, 512),
                     (24, 512, 512), (26, 512, 512), (28, 512, 512)]


def test_convert_torch_vgg16_matches_jax(tmp_path):
    """A state dict with torchvision's keys and shapes (every features conv;
    the converter takes the first seven): the port's npz equals the JAX
    package's array for array, bit for bit, and the perceptual loss read
    from it matches JAX's at 32^2."""
    rng = np.random.default_rng(4)
    sd = {}
    for ti, ci, co in TORCHVISION_VGG16:
        sd[f"features.{ti}.weight"] = torch.from_numpy(
            (rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci)).astype(
                np.float32))
        sd[f"features.{ti}.bias"] = torch.from_numpy(
            (0.05 * rng.standard_normal(co)).astype(np.float32))
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jvgg.convert_torch_vgg16(sd, jax_npz)
    pvgg.convert_torch_vgg16(sd, port_npz)
    want, got = np.load(jax_npz), np.load(port_npz)
    assert sorted(got.files) == sorted(want.files) == sorted(
        f"conv{i}_{k}" for i in range(7) for k in ("kernel", "bias"))
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      want[k].view(np.uint32))
    p, t = _pair((2, 32, 32, 1), seed=11)
    loss = pvgg.make_perceptual_fn(port_npz)(torch.from_numpy(p),
                                             torch.from_numpy(t))
    np.testing.assert_allclose(
        float(loss), float(jvgg.make_perceptual_fn(jax_npz)(p, t)), rtol=RTOL)
