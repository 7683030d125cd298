"""Plain versions of the port's two kernels against mrisr_tpu (CPU).

Kernel A (ops/conv_int8.py) against ``serve/quant.py:_conv3x3`` +
``_requant_epilogue`` / the final float epilogue; kernel B (ops/upconv.py)
against ``_upconv_int8(impl='convt')`` and the Pallas kernel in interpret
mode.  int8 contract (tests/test_upconv_pallas.py): no code off by more
than 1, under 1 % off by exactly 1 (fp32 rounding order at .5 boundaries).
float contract: rtol 1e-5.  On a CPU tensor the wrappers must run exactly
the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrisr_tpu.ops.upconv_pallas import pack_upconv as jax_pack_upconv
from mrisr_tpu.ops.upconv_pallas import upconv2x2_int8 as jax_upconv_pallas
from mrisr_tpu.serve.quant import (
    _conv3x3,
    _float_epilogue,
    _requant_epilogue,
    _upconv_int8,
)
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv2d_int8_plain,
    pack_conv,
)
from mrisr_tpu_torch.ops.upconv import (
    pack_upconv,
    upconv2x2_int8,
    upconv2x2_int8_plain,
)
from mrisr_tpu_torch.serve.quant import _requant_site

torch.set_num_threads(2)


def assert_codes_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff > 1).sum() == 0, diff.max()
    assert (diff == 1).mean() < 0.01


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _conv_case(seed, ci, co, k, hw=16, n=2):
    """int8 input/weights and scales that put y on both sides of the clip:
    acc ~ 127^2/3 * sqrt(K), scaled to a spread of tens to hundreds."""
    rng = np.random.default_rng(seed)
    x = _codes(rng, (n, hw, hw, ci))
    w = _codes(rng, (k, k, ci, co))
    acc_std = 127 * 127 / 3 * np.sqrt(k * k * ci)
    a_next = np.float32(0.037)
    scale = (rng.uniform(0.3, 3.0, co) * 60 / acc_std * a_next).astype(
        np.float32)
    bias = rng.uniform(-2, 2, co).astype(np.float32)
    return x, w, scale, bias, a_next


# (Ci, Co, relu, in_ratio): enc1's Ci=2, a wide level, no ReLU, shared-emit
CASES = [(2, 8, True, None), (32, 16, True, None), (16, 24, False, None),
         (16, 16, True, 1.37)]


@pytest.mark.parametrize("ci,co,relu,in_ratio", CASES)
def test_conv_int8_requant_matches_jax(ci, co, relu, in_ratio):
    x, w, scale, bias, a_next = _conv_case(ci * 7 + co, ci, co, 3)
    lq = {"scale": scale, "bias": bias}
    y = _conv3x3(jnp.asarray(x), jnp.asarray(w), preferred=jnp.int32)
    want = _requant_epilogue(
        y, {k: jnp.asarray(v) for k, v in lq.items()}, jnp.float32(a_next),
        relu=relu,
        in_ratio=None if in_ratio is None else jnp.float32(in_ratio))
    site = _requant_site(
        {"w_int8": torch.from_numpy(w), "scale": torch.from_numpy(scale),
         "bias": torch.from_numpy(bias)},
        torch.tensor(a_next), "cpu",
        None if in_ratio is None else torch.tensor(in_ratio,
                                                   dtype=torch.float32))
    xt = torch.from_numpy(x)
    got = conv2d_int8_plain(xt, site.w, site.s, site.b, relu=relu)
    assert_codes_close(got, want)
    # the CPU wrapper is the plain version, bit for bit
    np.testing.assert_array_equal(
        conv2d_int8(xt, site.w, site.s, site.b, relu=relu), got)


def test_conv_int8_final_float_matches_jax():
    """The final 1x1 layer: float32 out, acc * scale + qbias, no ReLU."""
    x, w, scale, bias, _ = _conv_case(5, 16, 1, 1)
    y = _conv3x3(jnp.asarray(x), jnp.asarray(w), preferred=jnp.int32)
    want = _float_epilogue(y, {"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)},
                           jnp.float32, relu=False)
    wp = pack_conv(torch.from_numpy(w))
    got = conv2d_int8(torch.from_numpy(x), wp, torch.from_numpy(scale),
                      torch.from_numpy(bias), relu=False, out_float=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_conv_int8_plain_is_exact_past_fp32():
    """|acc| past 2^24 (all-127 codes over K = 9 * 1024) stays exact."""
    x = np.full((1, 3, 3, 1024), 127, np.int8)
    w = np.full((3, 3, 1024, 1), 127, np.int8)
    got = conv2d_int8_plain(torch.from_numpy(x), pack_conv(torch.from_numpy(w)),
                            torch.ones(1), torch.zeros(1), out_float=True)
    # centre pixel sees all 9 taps: 127 * 127 * 9 * 1024 = 148,644,864
    assert float(got[0, 1, 1, 0]) == float(np.float32(148_644_864))


# (H, W, C, Co): tests/test_upconv_pallas.py LEVELS
LEVELS = [(4, 4, 64, 32), (8, 8, 32, 16), (16, 16, 16, 8)]


def _upconv_case(h, w, c, co):
    rng = np.random.default_rng(h * 100 + c)
    wt = _codes(rng, (2, 2, c, co))
    scale = rng.uniform(0.001, 0.01, co).astype(np.float32)
    qbias = rng.uniform(-0.5, 0.5, co).astype(np.float32)
    x = _codes(rng, (2, h, w, c))
    return x, wt, scale, qbias


@pytest.mark.parametrize("h,w,c,co", LEVELS)
def test_upconv_matches_convt_and_pallas(h, w, c, co):
    x, wt, scale, qbias = _upconv_case(h, w, c, co)
    a_next = np.float32(0.037)
    ent = {"w_int8": jnp.asarray(wt), "scale": jnp.asarray(scale),
           "qbias": jnp.asarray(qbias)}
    want = np.asarray(_upconv_int8(jnp.asarray(x), ent, a_next, impl="convt"))
    jw2, js4, jb4 = jax_pack_upconv(ent["w_int8"], ent["scale"] / a_next,
                                    ent["qbias"] / a_next)
    pallas = np.asarray(jax_upconv_pallas(jnp.asarray(x), jw2, js4, jb4,
                                          interpret=True))

    w2, s4, b4 = pack_upconv(torch.from_numpy(wt),
                             torch.from_numpy(scale) / torch.tensor(a_next),
                             torch.from_numpy(qbias) / torch.tensor(a_next))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jw2))
    assert w2.t().is_contiguous()
    xt = torch.from_numpy(x)
    got = upconv2x2_int8_plain(xt, w2, s4, b4)
    assert_codes_close(got, want)
    assert_codes_close(got, pallas)
    np.testing.assert_array_equal(upconv2x2_int8(xt, w2, s4, b4), got)


def test_upconv_fused_skip_concat():
    x, wt, scale, qbias = _upconv_case(8, 8, 32, 16)
    rng = np.random.default_rng(2)
    skip = torch.from_numpy(_codes(rng, (2, 16, 16, 16)))
    w2, s4, b4 = pack_upconv(torch.from_numpy(wt),
                             torch.from_numpy(scale) / 0.02,
                             torch.from_numpy(qbias) / 0.02)
    xt = torch.from_numpy(x)
    alone = upconv2x2_int8(xt, w2, s4, b4)
    fused = upconv2x2_int8(xt, w2, s4, b4, skip=skip)
    assert fused.shape == (2, 16, 16, 32)
    np.testing.assert_array_equal(fused[..., :16], alone)
    np.testing.assert_array_equal(fused[..., 16:], skip)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv2d_int8(x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        upconv2x2_int8(x, x, x, x)
