"""K3's plain version (ops/groupnorm.py) against the JAX package's fused
GroupNorm+SiLU(+int8) Pallas kernel, interpreted on the CPU, with the
contracts of tests/test_groupnorm_pallas.py; and the chain path against
flax's GroupNorm + SiLU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import linen as nn

from mrisr_tpu.ops.groupnorm_pallas import groupnorm_silu_pallas
from mrisr_tpu_torch.ops.groupnorm import (
    groupnorm_silu,
    groupnorm_silu_plain,
)
from mrisr_tpu_torch.serve.quant_diffusion import gn_silu_chain

torch.set_num_threads(2)


def _case(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) * 3.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.2).astype(np.float32)
    return x, gamma, beta


def _flax_ref(x, gamma, beta, groups):
    y = nn.GroupNorm(num_groups=groups, epsilon=1e-5).apply(
        {"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x))
    return np.asarray(nn.silu(y))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_codes(got, want, max_off1=1e-3):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < max_off1


@pytest.mark.parametrize("b,h,w,c", [
    (2, 16, 32, 128), (1, 8, 32, 256), (2, 32, 32, 128), (1, 24, 64, 384)])
def test_bf16_emission_matches_pallas(b, h, w, c):
    """atol 0.03: one bf16 output rounding, the Pallas test's contract."""
    groups = c // 4
    x, gamma, beta = _case(b * h + c, b, h, w, c)
    want = np.asarray(groupnorm_silu_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        num_groups=groups, interpret=True), np.float32)
    got = groupnorm_silu_plain(*_t(x, gamma, beta), num_groups=groups)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03)
    np.testing.assert_allclose(got.float().numpy(),
                               _flax_ref(x, gamma, beta, groups), atol=0.03)
    # float32 emission is the unrounded chain
    f32 = groupnorm_silu_plain(*_t(x, gamma, beta), num_groups=groups,
                               out_dtype=torch.float32)
    np.testing.assert_allclose(f32.numpy(), _flax_ref(x, gamma, beta, groups),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("traced", [False, True])
def test_int8_emission_matches_pallas(traced):
    """At most one code apart, under 0.1 % of them; the scale may be a
    one-element tensor (the per-step lookup) or a float."""
    b, h, w, c = 2, 16, 32, 256
    groups = c // 4
    x, gamma, beta = _case(7, b, h, w, c)
    ref = _flax_ref(x, gamma, beta, groups)
    scale = float(np.abs(ref).max()) / 127.0
    want = np.asarray(groupnorm_silu_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        num_groups=groups, quant_scale=jnp.float32(scale), interpret=True))
    s = torch.tensor([scale], dtype=torch.float32) if traced else scale
    got = groupnorm_silu_plain(*_t(x, gamma, beta), num_groups=groups,
                               quant_scale=s)
    assert got.dtype == torch.int8
    _assert_codes(got.numpy(), want)
    _assert_codes(got.numpy(), np.clip(np.round(ref / scale), -127, 127))


@pytest.mark.parametrize("shape,dtype", [
    ((2, 7, 9, 16), torch.float32), ((1, 5, 3, 768), torch.bfloat16)])
def test_wrapper_on_cpu_is_the_plain_version(shape, dtype):
    """Odd H*W, narrow and wide C, bf16 input: on a CPU tensor the wrapper
    returns exactly the plain version, in each emission mode."""
    x, gamma, beta = _case(11, *shape)
    xt = torch.from_numpy(x).to(dtype)
    groups = shape[-1] // 4
    before = groupnorm_silu.launches
    for kw in ({}, {"out_dtype": torch.float32}, {"quant_scale": 0.02}):
        got = groupnorm_silu(xt, *_t(gamma, beta), num_groups=groups, **kw)
        want = groupnorm_silu_plain(xt, *_t(gamma, beta), num_groups=groups,
                                    **kw)
        assert torch.equal(got, want)
    assert groupnorm_silu.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="groups"):
        groupnorm_silu(xt, *_t(gamma, beta), num_groups=groups + 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.03)])
def test_chain_matches_flax(dtype, tol):
    """The 'chain' path: flax GroupNorm semantics, SiLU in ``dtype``."""
    x, gamma, beta = _case(13, 2, 8, 8, 48)
    got = gn_silu_chain(torch.from_numpy(x).to(dtype), *_t(gamma, beta), 12,
                        dtype)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               _flax_ref(x, gamma, beta, 12), atol=tol,
                               rtol=tol)


# (B, H, W, C): H*W 77 (one partial of 77 pixels), 1517 = 37 * 41 (37
# partials of 41), 65536 (512 partials of 128), 25 (one of 25)
@pytest.mark.parametrize("shape", [(2, 7, 11, 48), (1, 37, 41, 16),
                                   (2, 256, 256, 8), (3, 5, 5, 64)], ids=str)
def test_chain_partial_sums_match_flax(shape):
    """The chain's statistics summed in partials of pixels, at sizes whose
    partials differ, against flax's GroupNorm in float32 (that a row's
    bits do not depend on the rows beside it is the card's reduction's
    property: tests/test_torch_port_cuda.py)."""
    x, gamma, beta = _case(17, *shape)
    groups = shape[-1] // 4
    got = gn_silu_chain(torch.from_numpy(x), *_t(gamma, beta), groups,
                        torch.float32)
    np.testing.assert_allclose(got.numpy(), _flax_ref(x, gamma, beta, groups),
                               atol=1e-5, rtol=1e-5)


# (group size, channels): the notebook net's groups of 4 and the DDPM
# UNet's 32 groups (of 8 here)
@pytest.mark.parametrize("group,c", [(4, 48), (8, 256)], ids=str)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("mode", ["int8", "bf16", "float32"])
def test_plain_shift_is_the_float32_sum(group, c, silu, mode):
    """``shift=s`` is GroupNorm of ``x.float() + s[:, None, None, :]``, bit
    for bit, in every output mode, with SiLU and without; a shift moves
    the answer (it is no per-channel constant within a group)."""
    x, gamma, beta = _case(23 + c, 2, 6, 10, c)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    s = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (2, c)).astype(np.float32))
    kw = {"int8": {"quant_scale": 0.03}, "bf16": {},
          "float32": {"out_dtype": torch.float32}}[mode]
    kw.update(num_groups=c // group, eps=1e-6 if group > 4 else 1e-5,
              silu=silu)
    got = groupnorm_silu_plain(xt, *_t(gamma, beta), shift=s, **kw)
    want = groupnorm_silu_plain(xt.float() + s[:, None, None, :],
                                *_t(gamma, beta), **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, groupnorm_silu_plain(xt, *_t(gamma, beta),
                                                     **kw))
    assert torch.equal(groupnorm_silu(xt, *_t(gamma, beta), shift=s, **kw),
                       got)  # the wrapper on a CPU tensor
