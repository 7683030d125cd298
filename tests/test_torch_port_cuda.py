"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
there is no card (decided when the test runs, not at import).  This file
imports neither jax nor mrisr_tpu, so it runs on a machine with the card
and no JAX:  python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from mrisr_tpu_torch.ops.bias_residual import (
    bias_residual,
    bias_residual_plain,
)
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv2d_int8_plain,
    pack_conv,
)
from mrisr_tpu_torch.ops.groupnorm import (
    groupnorm_silu,
    groupnorm_silu_plain,
)
from mrisr_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain
from mrisr_tpu_torch.ops.ssim import ssim
from mrisr_tpu_torch.ops.ssim_fused import ssim_fused, ssim_fused_plain
from mrisr_tpu_torch.ops.upconv import (
    pack_upconv,
    upconv2x2_int8,
    upconv2x2_int8_plain,
    upconv_path,
)
from torch_port_quant_cases import (
    bias_sites,
    quant_edge_values,
    quant_sites,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _codes(g, shape, device):
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(device)


def _path_counts(fn):
    return fn.launches, fn.launches_tc, fn.launches_dp4a


def assert_launched(fn, before, path):
    """One launch, counted on ``path`` and on no other path."""
    want = (before[0] + 1, before[1] + (path == "tc"),
            before[2] + (path == "dp4a"))
    assert _path_counts(fn) == want


# (N, H, W, Ci, Co, k, path).  The sums are exact on both paths, so every
# case must equal its plain version bit for bit, twice.  Tensor cores: Ci
# 16 / 48 (a channel tail inside a 64-code step) / 64 / 128, Co 40 and 200
# (ragged column tiles), 1x1 and 3x3, a 9x7 image (a rectangle past the
# image edge), a 16^2 x 1024 deep K; dp4a: enc1's Ci = 2 (joint (tap, c)
# staging) at Co 64 / 24 / 40, the final 1x1 with Co = 1 (one thread a
# pixel) and a 3x3 with Co = 1 (the tiled loop), a Ci = 8 conv.
CONV_CASES = [(2, 16, 16, 2, 64, 3, "dp4a"), (1, 9, 7, 48, 40, 3, "tc"),
              (2, 16, 16, 64, 64, 3, "tc"), (2, 8, 8, 64, 1, 1, "dp4a"),
              (2, 16, 16, 16, 64, 3, "tc"), (2, 12, 20, 128, 200, 3, "tc"),
              (2, 12, 20, 64, 40, 1, "tc"), (1, 5, 6, 8, 16, 3, "dp4a"),
              (2, 16, 16, 1024, 256, 3, "tc"), (3, 9, 7, 2, 24, 3, "dp4a"),
              (2, 8, 8, 64, 1, 3, "dp4a"), (1, 5, 7, 32, 1, 1, "dp4a"),
              (2, 6, 6, 2, 40, 3, "dp4a")]


@pytest.mark.parametrize("n,h,w,ci,co,k,path", CONV_CASES)
@pytest.mark.parametrize("out_float", [False, True])
def test_conv_int8_kernel_matches_plain(cuda, n, h, w, ci, co, k, path,
                                        out_float):
    from mrisr_tpu_torch.ops.conv_int8 import conv_path

    assert conv_path(ci, co, k) == path
    g = torch.Generator().manual_seed(n * 1000 + ci * 10 + co)
    x = _codes(g, (n, h, w, ci), cuda)
    wp = pack_conv(_codes(g, (k, k, ci, co), "cpu")).to(cuda)
    acc_std = 127 * 127 / 3 * (k * k * ci) ** 0.5
    s = (torch.rand(co, generator=g) * 2 + 0.3) * 60 / acc_std
    b = torch.rand(co, generator=g) * 4 - 2
    s, b = s.to(cuda), b.to(cuda)
    before = _path_counts(conv2d_int8)
    got = conv2d_int8(x, wp, s, b, relu=True, out_float=out_float)
    torch.cuda.synchronize()
    assert_launched(conv2d_int8, before, path)
    want = conv2d_int8_plain(x, wp, s, b, relu=True, out_float=out_float)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(conv2d_int8(x, wp, s, b, relu=True,
                                   out_float=out_float), got)


@pytest.mark.parametrize("k", [1, 3])
def test_conv_int8_float_epilogue_without_relu(cuda, k):
    """The diffusion sites' mode: relu=False, float32 out, s = a * w_scale
    and b = the conv bias."""
    g = torch.Generator().manual_seed(40 + k)
    x = _codes(g, (2, 16, 16, 96), cuda)
    wp = pack_conv(_codes(g, (k, k, 96, 80), "cpu")).to(cuda)
    s = (torch.rand(80, generator=g) * 1e-4).to(cuda)
    b = (torch.randn(80, generator=g) * 0.1).to(cuda)
    got = conv2d_int8(x, wp, s, b, relu=False, out_float=True)
    torch.cuda.synchronize()
    want = conv2d_int8_plain(x, wp, s, b, relu=False, out_float=True)
    assert bool((got < 0).any())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,c,co", [(8, 8, 512, 256), (5, 3, 16, 6),
                                      (4, 6, 8, 8)])
def test_upconv_kernel_float_mode(cuda, h, w, c, co):
    g = torch.Generator().manual_seed(h * 10 + co)
    x = _codes(g, (2, h, w, c), cuda)
    w2, s4, b4 = pack_upconv(_codes(g, (2, 2, c, co), "cpu"),
                             torch.rand(co, generator=g) * 1e-4,
                             torch.randn(co, generator=g) * 0.1)
    w2 = w2.t().to(cuda).t()
    s4, b4 = s4.to(cuda), b4.to(cuda)
    before = _path_counts(upconv2x2_int8)
    got = upconv2x2_int8(x, w2, s4, b4, out_float=True)
    torch.cuda.synchronize()
    assert_launched(upconv2x2_int8, before, upconv_path(c, co))
    want = upconv2x2_int8_plain(x, w2, s4, b4, out_float=True)
    assert got.dtype == torch.float32 and got.shape == (2, 2 * h, 2 * w, co)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, want)
    assert torch.equal(upconv2x2_int8(x, w2, s4, b4, out_float=True), got)
    with pytest.raises(ValueError, match="skip"):
        upconv2x2_int8(x, w2, s4, b4, skip=_codes(g, (2, 2 * h, 2 * w, 4),
                                                  cuda), out_float=True)


# K3: the diffusion sites' widths, an odd H*W, a tile-ragged C
GN_CASES = [(2, 16, 16, 128), (2, 9, 7, 768), (1, 33, 5, 48), (3, 8, 8, 20)]


def _gn_case(shape, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0 + 0.5
    c = shape[-1]
    gamma = torch.randn(c, generator=g) * 0.5 + 1.0
    beta = torch.randn(c, generator=g) * 0.2
    return x.to(device, dtype), gamma.to(device), beta.to(device)


@pytest.mark.parametrize("shape", GN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_groupnorm_kernel_matches_plain(cuda, shape, dtype):
    """int8: no code more than 1 off and under 0.1 % off by one (the
    Pallas kernel's contract); bf16 out atol 0.03; float32 out 1e-5."""
    x, gamma, beta = _gn_case(shape, cuda, dtype, seed=shape[-1])
    groups = shape[-1] // 4
    ref = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                               out_dtype=torch.float32)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    before = groupnorm_silu.launches
    q = groupnorm_silu(x, gamma, beta, num_groups=groups, quant_scale=scale)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == shape
    want = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                                quant_scale=scale)
    diff = (q.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    assert torch.equal(groupnorm_silu(x, gamma, beta, num_groups=groups,
                                      quant_scale=scale), q)  # deterministic
    y16 = groupnorm_silu(x, gamma, beta, num_groups=groups)
    assert y16.dtype == torch.bfloat16
    torch.testing.assert_close(y16.float(), ref, rtol=0, atol=0.03)
    y32 = groupnorm_silu(x, gamma, beta, num_groups=groups,
                         out_dtype=torch.float32)
    torch.testing.assert_close(y32, ref, rtol=1e-5, atol=1e-5)


# K3 at groups wider than 4 (the DDPM UNet's 32 groups): (shape, group
# size, SiLU) at that network's sites, batch 2: 256^2 x 256 (two reads),
# 128^2 x 384, 64^2 x 256, 16^2 x 768 and 8^2 x 1024; the attention norms
# (GroupNorm alone) at 16^2 and 8^2 x 512
GN_WIDE_CASES = [((2, 256, 256, 256), 8, True), ((2, 128, 128, 384), 12, True),
                 ((2, 64, 64, 256), 8, True), ((2, 16, 16, 512), 16, True),
                 ((2, 16, 16, 768), 24, True), ((2, 8, 8, 1024), 32, True),
                 ((2, 16, 16, 512), 16, False), ((2, 8, 8, 512), 16, False)]


@pytest.mark.parametrize("shape,group,silu", GN_WIDE_CASES, ids=str)
def test_groupnorm_kernel_wide_groups_match_plain(cuda, shape, group, silu):
    """Groups of 8 to 32 channels, with SiLU or without, held as group
    size 4 is: int8 codes at most 1 off and under 0.1 % off by one, bf16
    out within one bf16 rounding step (max(0.03, 2^-8 |y|)), two launches
    the same bits; eps 1e-6."""
    x, gamma, beta = _gn_case(shape, cuda, torch.bfloat16, seed=group)
    kw = dict(num_groups=shape[-1] // group, eps=1e-6, silu=silu)
    ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32, **kw)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    before = groupnorm_silu.launches
    q = groupnorm_silu(x, gamma, beta, quant_scale=scale, **kw)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == before + 1
    want = groupnorm_silu_plain(x, gamma, beta, quant_scale=scale, **kw)
    diff = (q.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    assert torch.equal(groupnorm_silu(x, gamma, beta, quant_scale=scale,
                                      **kw), q)
    y16 = groupnorm_silu(x, gamma, beta, **kw)
    tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
    assert bool(((y16.float() - ref).abs() <= tol).all())
    assert torch.equal(groupnorm_silu(x, gamma, beta, **kw), y16)


# K3's plans: (2, 256^2, 192) one read, one sample a pass (the widest
# 256^2 site); (1, 512^2, 64) bf16, 33.5 MB, more than a grid of 132 x 227
# KB holds: the two-read form; (8, 32^2, 512) eight samples a pass (the
# bottleneck's); (3, 11 x 13, 36) an odd H*W with H*W*C not a multiple of
# 16 (8-byte staging); (1, 2 x 2, 4200) more groups (1050) than threads
GN_PLAN_CASES = [((2, 256, 256, 192), True, 1), ((1, 512, 512, 64), False, 1),
                 ((8, 32, 32, 512), True, 8), ((3, 11, 13, 36), True, 3),
                 ((1, 2, 2, 4200), True, 1)]


@pytest.mark.parametrize("shape,one_read,spp", GN_PLAN_CASES, ids=str)
def test_groupnorm_kernel_plans_match_plain(cuda, shape, one_read, spp):
    """Each form of the plan against the plain version: int8 codes as in
    test_groupnorm_kernel_matches_plain, bf16 out within one bf16 rounding
    step (max(0.03, 2^-8 |y|), chip_smoke.py's contract: wide shapes reach
    past |y| = 8), two launches the same bits."""
    from mrisr_tpu_torch.device import sm_count
    from mrisr_tpu_torch.ops.groupnorm import plan

    b, h, w, c = shape
    p = plan(b, h * w, c, 2, sm_count(cuda))
    assert (p.one_read, p.spp) == (one_read, spp)
    x, gamma, beta = _gn_case(shape, cuda, torch.bfloat16, seed=c)
    groups = c // 4
    ref = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                               out_dtype=torch.float32)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    before = groupnorm_silu.launches
    q = groupnorm_silu(x, gamma, beta, num_groups=groups, quant_scale=scale)
    torch.cuda.synchronize()
    assert groupnorm_silu.launches == before + 1
    want = groupnorm_silu_plain(x, gamma, beta, num_groups=groups,
                                quant_scale=scale)
    diff = (q.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-3
    assert torch.equal(groupnorm_silu(x, gamma, beta, num_groups=groups,
                                      quant_scale=scale), q)
    y16 = groupnorm_silu(x, gamma, beta, num_groups=groups)
    tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
    assert bool(((y16.float() - ref).abs() <= tol).all())
    assert torch.equal(groupnorm_silu(x, gamma, beta, num_groups=groups), y16)


def test_groupnorm_kernel_raises_when_the_grid_cannot_be_co_resident(cuda):
    """Two 200 KB blocks an SM cannot be co-resident: the cooperative launch
    is refused and the check raises; nothing falls back."""
    from mrisr_tpu_torch import _build
    from mrisr_tpu_torch.device import sm_count

    sms = sm_count(cuda)
    n, px, c = 2, 4, 64
    hw = sms * px
    x = torch.zeros((n, hw, c), device=cuda, dtype=torch.bfloat16)
    gamma = torch.ones(c, device=cuda)
    out = torch.empty_like(x)
    partial = torch.empty((1, c // 4, 2 * sms, 2), device=cuda,
                          dtype=torch.float64)
    lib = _build.library("groupnorm_silu")
    err = lib.groupnorm_launch(
        x.data_ptr(), 1, gamma.data_ptr(), gamma.data_ptr(), None, None,
        None, partial.data_ptr(), out.data_ptr(), 1, n, hw, c, 4, 1, n, sms, px, 1,
        1, 200_000, 1e-5, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="co-resident"):
        _build.check(err, "groupnorm_silu")


def test_groupnorm_kernel_refuses_what_it_does_not_take(cuda):
    x, gamma, beta = _gn_case((1, 4, 4, 16), cuda, torch.float32)
    with pytest.raises(ValueError, match="groups of a multiple of 4"):
        groupnorm_silu(x, gamma, beta, num_groups=8)  # groups of 2
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_silu(x.transpose(1, 2), gamma, beta, num_groups=4)
    with pytest.raises(ValueError, match="one value"):
        groupnorm_silu(x, gamma, beta, num_groups=4,
                       quant_scale=torch.ones(2, device=cuda))
    shift = torch.zeros((1, 16), device=cuda)
    with pytest.raises(ValueError, match="with SiLU"):
        groupnorm_silu(x, gamma, beta, num_groups=4, shift=shift, silu=False)
    with pytest.raises(ValueError, match="shift"):
        groupnorm_silu(x, gamma, beta, num_groups=4, shift=shift[:, :8])
    with pytest.raises(ValueError, match="x's dtype"):  # float32 in, bf16 out
        groupnorm_silu(x, gamma, beta, num_groups=4, shift=shift)


# The GroupNorm sites of one denoiser call at batch 32, 256^2: (name, H, C,
# groups, int8 out, SiLU, eps, shifted: a ResBlock's norm2, which takes its
# time projection as K3's shift).  The notebook net (base 64): 15 sites,
# groups of 4, its 5 full-size ones bf16 out.
NOTEBOOK_GN_SITES = [
    (name, h, c, c // 4, h < 256, True, 1e-5, name.endswith("norm2"))
    for name, h, c in (
        ("enc1/norm1", 256, 64), ("enc1/norm2", 256, 128),
        ("enc2/norm1", 128, 128), ("enc2/norm2", 128, 256),
        ("enc3/norm1", 64, 256), ("enc3/norm2", 64, 512),
        ("bottleneck/norm1", 32, 512), ("bottleneck/norm2", 32, 512),
        ("dec3/norm1", 64, 768), ("dec3/norm2", 64, 256),
        ("dec2/norm1", 128, 384), ("dec2/norm2", 128, 128),
        ("dec1/norm1", 256, 192), ("dec1/norm2", 256, 64),
        ("final_norm", 256, 64))]


def ddpm_gn_sites():
    """The DDPM UNet's 71 GroupNorm sites at ch 128 (32 groups, eps 1e-6;
    the full-size level bf16 out, the attention norms without SiLU)."""
    from mrisr_tpu_torch.models.ddpm_unet import attn_levels, level_plan

    plan, sites = level_plan(128), []
    for part in ("down", "up"):
        for i, j, ci, co in plan[part]:
            h = 256 >> i
            sites += [(f"{part}/{i}/block/{j}/norm1", h, ci, 32, i > 0, True,
                       1e-6, False),
                      (f"{part}/{i}/block/{j}/norm2", h, co, 32, i > 0, True,
                       1e-6, True)]
            if i in attn_levels():
                sites.append((f"{part}/{i}/attn/{j}/norm", h, co, 32, True,
                              False, 1e-6, False))
    m = plan["mid"]
    for k in (1, 2):
        sites += [(f"mid/block_{k}/norm1", 8, m, 32, True, True, 1e-6, False),
                  (f"mid/block_{k}/norm2", 8, m, 32, True, True, 1e-6, True)]
    sites += [("mid/attn_1/norm", 8, m, 32, True, False, 1e-6, False),
              ("norm_out", 256, 128, 32, False, True, 1e-6, False)]
    return sites


def _distinct(sites):
    """One site of each (H, C, groups, SiLU, eps, shifted)."""
    seen = {}
    for site in sites:
        seen.setdefault((site[1:4] + site[5:]), site)
    return list(seen.values())


def _site_case(cuda, h, c, batch=32):
    """A site's bf16 input, gamma, beta and time-projection shift from a
    generator on the card seeded by the shape."""
    g = torch.Generator(device=cuda).manual_seed(1000 * h + c)
    x = (3 * torch.randn((batch, h, h, c), generator=g, device=cuda)
         + 0.5).to(torch.bfloat16)
    gamma = 1 + 0.5 * torch.randn(c, generator=g, device=cuda)
    beta = 0.2 * torch.randn(c, generator=g, device=cuda)
    shift = torch.randn((batch, c), generator=g, device=cuda).to(
        torch.bfloat16)
    return x, gamma, beta, shift


def _two_read(n, hw, c, itemsize, sms):
    """K3's plan in its two-read form whatever fits (what :func:`plan`
    gives where one sample does not fit the grid's shared memory)."""
    from mrisr_tpu_torch.ops.groupnorm import Plan, _blocks, _reserve

    bs, px = _blocks(hw, 1, sms)
    return Plan(1, bs, px, n, False, _reserve(c))


# (name, H, C, groups, eps) of each distinct norm2 of both nets
NORM2_CASES = [s[:4] + s[6:7] for s in _distinct(NOTEBOOK_GN_SITES)
               + _distinct(ddpm_gn_sites()) if s[-1]]


@pytest.mark.parametrize("name,h,c,groups,eps", NORM2_CASES, ids=str)
def test_groupnorm_kernel_shift_matches_plain(cuda, name, h, c, groups, eps):
    """K3 with a shift at every norm2 shape of both nets, batch 32: int8
    codes equal to the plain version's, bf16 out within one bf16 rounding
    step (max(0.03, 2^-8 |y|), chip_smoke.py's phase 6), the same bits
    twice, one launch counted in ``launches_shift``."""
    x, gamma, beta, shift = _site_case(cuda, h, c)
    kw = dict(num_groups=groups, eps=eps, shift=shift)
    ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32, **kw)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    before = (groupnorm_silu.launches, groupnorm_silu.launches_shift)
    q = groupnorm_silu(x, gamma, beta, quant_scale=scale, **kw)
    torch.cuda.synchronize()
    assert (groupnorm_silu.launches, groupnorm_silu.launches_shift) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(q, groupnorm_silu_plain(x, gamma, beta,
                                               quant_scale=scale, **kw))
    assert torch.equal(groupnorm_silu(x, gamma, beta, quant_scale=scale,
                                      **kw), q)
    y16 = groupnorm_silu(x, gamma, beta, **kw)
    tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
    assert bool(((y16.float() - ref).abs() <= tol).all())
    assert torch.equal(groupnorm_silu(x, gamma, beta, **kw), y16)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_groupnorm_kernel_shift_two_read_form(cuda, mode, monkeypatch):
    """The widest norm2 (256^2 x 128, batch 32) with its plan forced into
    the two-read form (statistics from device memory, then an apply that
    reads x again): the plain version's int8 codes, bf16 within phase 6's
    tolerance, and the one-read form's bits."""
    from mrisr_tpu_torch.ops import groupnorm

    x, gamma, beta, shift = _site_case(cuda, 256, 128)
    kw = dict(num_groups=32, eps=1e-6, shift=shift)
    ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32, **kw)
    if mode == "int8":
        kw["quant_scale"] = (ref.abs().amax() / 127.0).reshape(1)
    one_read = groupnorm_silu(x, gamma, beta, **kw)
    monkeypatch.setattr(groupnorm, "plan", _two_read)
    got = groupnorm_silu(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, one_read)
    if mode == "int8":
        assert torch.equal(got, groupnorm_silu_plain(x, gamma, beta, **kw))
    else:
        tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
        assert bool(((got.float() - ref).abs() <= tol).all())


def k3_bits(cuda, sites):
    """{site shape: sha256 of K3's int8 and bf16 outputs there without a
    shift}, batch 32, inputs from :func:`_site_case`."""
    import hashlib

    out = {}
    for h, c, groups, silu, eps in sorted({s[1:4] + s[5:7] for s in sites}):
        x, gamma, beta, _ = _site_case(cuda, h, c)
        kw = dict(num_groups=groups, eps=eps, silu=silu)
        scale = torch.full((1,), 0.05, device=cuda)
        digest = hashlib.sha256()
        for y in (groupnorm_silu(x, gamma, beta, quant_scale=scale, **kw),
                  groupnorm_silu(x, gamma, beta, **kw)):
            digest.update(y.view(torch.uint8).cpu().numpy().tobytes())
        out[f"{h}x{h}x{c}/{c // groups}{'' if silu else ' no SiLU'}"] = (
            digest.hexdigest()[:16])
    return out


# K3 without a shift, as the kernel was before the shift form: its outputs'
# digests (k3_bits) at the shapes of the notebook net's 15 sites (10
# shapes) and of the DDPM UNet's 71 (20 shapes), recorded on an H100 with
# that kernel
K3_BITS_WITHOUT_SHIFT = {
    "notebook": {
        "32x32x512/4": "e530b6295be07ad1",
        "64x64x256/4": "8fbcb173b2a88433",
        "64x64x512/4": "7dea06e5f88af3c1",
        "64x64x768/4": "465c7bf140e84a66",
        "128x128x128/4": "e64e7507e11db00f",
        "128x128x256/4": "808edeee4aae36c2",
        "128x128x384/4": "a73061663d2e5173",
        "256x256x64/4": "8e27c1dd08b52d6a",
        "256x256x128/4": "8e3a9f8e60223cb1",
        "256x256x192/4": "d31d5235ea9618db",
    },
    "ddpm": {
        "8x8x512/16": "f239358e68df741f",
        "8x8x512/16 no SiLU": "eac796ba466ecbd0",
        "8x8x1024/32": "d9a09cc256b1315e",
        "16x16x256/8": "20893421e032ef90",
        "16x16x512/16": "300f1f699b0e4f70",
        "16x16x512/16 no SiLU": "48a4d85da4d2469e",
        "16x16x768/24": "034209c21ee46f66",
        "16x16x1024/32": "ef0d81140af0bde6",
        "32x32x256/8": "56b8194f3f6e7a98",
        "32x32x512/16": "1c416af2367fb7ea",
        "32x32x768/24": "8a01e68e210a0e39",
        "64x64x128/4": "82139d0998b04d4b",
        "64x64x256/8": "df79399af1933dbf",
        "64x64x384/12": "d2cdb7d9bb6f232d",
        "64x64x512/16": "a692abe4d8766abb",
        "128x128x128/4": "4be50240a341cffc",
        "128x128x256/8": "eb30910449f646a6",
        "128x128x384/12": "55f44e2bdf5e33cc",
        "256x256x128/4": "78a8d6e89862cf68",
        "256x256x256/8": "28a1432eda36278f",
    },
}


@pytest.mark.parametrize("net", ["notebook", "ddpm"])
def test_groupnorm_kernel_without_shift_keeps_its_bits(cuda, net):
    """Launches without a shift (norm1, the attention norms, the final
    norm) run the kernel's code from before the shift form: the bits it
    gave then, at every site shape of both nets."""
    sites = NOTEBOOK_GN_SITES if net == "notebook" else ddpm_gn_sites()
    got = k3_bits(cuda, sites)
    assert len(got) == (10 if net == "notebook" else 20)
    assert got == {k: K3_BITS_WITHOUT_SHIFT[net][k] for k in got}


@pytest.mark.parametrize("only", ["deep", "all"])
def test_diffusion_int8_forward_on_card_equals_plain(cuda, only):
    """The int8 Fast-DDPM forward through kernels A, B and K3 against the
    same tables through their plain versions, on the card."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        DEEP_SITES,
        calibrate_fastddpm,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    params = fastddpm_flax_params(FastDDPMUNet(base_features=16,
                                               time_dim=32).to(cuda))
    sched = DiffusionSchedule.create(50, 4, "linear", "linspace")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 32, 32, 2), generator=g).to(cuda)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib,
                          only=DEEP_SITES if only == "deep" else None)
    x = torch.randn((2, 32, 32, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    counts = (conv2d_int8.launches, upconv2x2_int8.launches,
              groupnorm_silu.launches, groupnorm_silu.launches_shift)
    got = int8_forward(q, device=cuda)(x, t)
    # K3 at all 15 GroupNorm sites: int8 codes or, at int8_deep's 5 float
    # sites, the forward's bf16; the 7 norm2 of them with a shift
    assert (conv2d_int8.launches - counts[0], upconv2x2_int8.launches
            - counts[1], groupnorm_silu.launches - counts[2],
            groupnorm_silu.launches_shift - counts[3]) == (
        (14, 2, 15, 7) if only == "deep" else (22, 3, 15, 7))
    want = int8_forward(q, device=cuda, plain=True)(x, t)
    assert got.shape == (2, 32, 32, 1) and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.02, rel


@pytest.mark.parametrize("c", [64, 128, 192])
def test_groupnorm_kernel_bf16_rows_do_not_depend_on_the_batch(cuda, c):
    """K3's bf16 mode at the float sites' shapes (256^2, bf16 in) gives a
    row the same bits at batch 1, 4 and 32, whatever the plan, so
    data-parallel replicas answer as one engine does."""
    x, gamma, beta = _gn_case((32, 256, 256, c), cuda, torch.bfloat16,
                              seed=c)
    full = groupnorm_silu(x, gamma, beta, num_groups=c // 4)
    for rows in (1, 4):
        assert torch.equal(groupnorm_silu(x[:rows], gamma, beta,
                                          num_groups=c // 4), full[:rows])


def test_fused_float_sites_no_further_from_float32_than_chain(cuda):
    """An int8_deep forward (bf16) with 'fused', K3 at all 15 sites, is no
    further (rel-RMSE) from the float32 forward than 'chain' is, plus
    0.005; K3 launches 15 times a call with 'fused' and never with
    'chain'."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.device import fp32_reference
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        DEEP_SITES,
        FastDDPMForward,
        calibrate_fastddpm,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(2)
    params = fastddpm_flax_params(FastDDPMUNet(base_features=16,
                                               time_dim=32).to(cuda))
    sched = DiffusionSchedule.create(50, 4, "linear", "linspace")
    g = torch.Generator().manual_seed(3)
    cond = torch.randn((2, 32, 32, 2), generator=g).to(cuda)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib, only=DEEP_SITES)
    x = torch.randn((4, 32, 32, 3), generator=g).to(cuda)
    t = torch.full((4,), int(sched.timesteps[-1]), device=cuda)
    with fp32_reference():
        want = FastDDPMForward(params, dtype=torch.float32,
                               gn_impl="chain", device=cuda)(x, t).double()
    rel = {}
    for gn, launches in (("fused", 15), ("chain", 0)):
        before = groupnorm_silu.launches
        got = int8_forward(q, gn_impl=gn, device=cuda)(x, t)
        assert groupnorm_silu.launches - before == launches, gn
        rel[gn] = float((got.double() - want).square().mean().sqrt()
                        / want.std())
    assert rel["fused"] <= rel["chain"] + 0.005, rel


# (H, C) of the Fast-DDPM's GroupNorm sites at 256^2 (base 64) and two
# sizes whose partial sums are not powers of two
CHAIN_ROW_CASES = [(256, 64), (256, 128), (128, 128), (128, 192), (64, 256),
                   (64, 384), (32, 512), (32, 768), (200, 64), (24, 96)]


@pytest.mark.parametrize("h,c", CHAIN_ROW_CASES)
def test_gn_silu_chain_rows_do_not_depend_on_the_batch(cuda, h, c):
    """The plain-op GroupNorm chain at 1-7 rows gives those rows the bits
    the 8-row call gives them, so data-parallel replicas answer as one
    engine does."""
    from mrisr_tpu_torch.serve.quant_diffusion import gn_silu_chain

    g = torch.Generator(device=cuda).manual_seed(h + c)
    x = torch.randn((8, h, h, c), generator=g, device=cuda) * 2 + 0.5
    gamma = torch.rand(c, generator=g, device=cuda) + 0.5
    beta = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        full = gn_silu_chain(x.to(dtype), gamma, beta, c // 4, dtype)
        for rows in range(1, 8):
            assert torch.equal(gn_silu_chain(x[:rows].to(dtype), gamma, beta,
                                             c // 4, dtype), full[:rows])


# (H, W, C, Co, Cs): tensor cores at the UNet's upconv1 shape, a Co = 6
# with and without skip (ragged phases), C = 16; dp4a at C = 8
@pytest.mark.parametrize("h,w,c,co,cs", [(4, 4, 64, 32, 32),
                                         (8, 8, 32, 16, 0),
                                         (5, 3, 16, 6, 6),
                                         (5, 3, 16, 6, 0),
                                         (16, 16, 128, 64, 64),
                                         (3, 5, 8, 4, 4)])
def test_upconv_kernel_matches_plain(cuda, h, w, c, co, cs):
    g = torch.Generator().manual_seed(h * 100 + c)
    x = _codes(g, (2, h, w, c), cuda)
    w2, s4, b4 = pack_upconv(_codes(g, (2, 2, c, co), "cpu"),
                             torch.rand(co, generator=g) * 0.2 + 0.03,
                             torch.rand(co, generator=g) * 20 - 10)
    w2 = w2.t().to(cuda).t()
    s4, b4 = s4.to(cuda), b4.to(cuda)
    skip = _codes(g, (2, 2 * h, 2 * w, cs), cuda) if cs else None
    before = _path_counts(upconv2x2_int8)
    got = upconv2x2_int8(x, w2, s4, b4, skip=skip)
    torch.cuda.synchronize()
    assert_launched(upconv2x2_int8, before, upconv_path(c, co))
    want = upconv2x2_int8_plain(x, w2, s4, b4, skip=skip)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    if cs:
        assert torch.equal(got[..., co:], skip)
    assert torch.equal(upconv2x2_int8(x, w2, s4, b4, skip=skip), got)


# The half-width student's (features 32) full-size sites: kernel A's
# tensor-core Co = 32 convs at 256^2 (enc1/dec1 Conv_1 32 -> 32, dec1
# Conv_0 64 -> 32: the 64-column tile over a 32-row weight), kernel B's
# upconv1 C = 64 -> Co = 32 on a 128^2 input, with its 32-channel skip.
STUDENT_CONV_SITES = [(2, 256, 256, 32, 32), (2, 256, 256, 64, 32)]


@pytest.mark.parametrize("n,h,w,ci,co", STUDENT_CONV_SITES)
@pytest.mark.parametrize("out_float", [False, True])
def test_student_conv_sites_match_plain(cuda, n, h, w, ci, co, out_float):
    from mrisr_tpu_torch.ops.conv_int8 import conv_path

    assert conv_path(ci, co, 3) == "tc"
    g = torch.Generator().manual_seed(ci * 10 + co + out_float)
    x = _codes(g, (n, h, w, ci), cuda)
    wp = pack_conv(_codes(g, (3, 3, ci, co), "cpu")).to(cuda)
    acc_std = 127 * 127 / 3 * (9 * ci) ** 0.5
    s = ((torch.rand(co, generator=g) * 2 + 0.3) * 60 / acc_std).to(cuda)
    b = (torch.rand(co, generator=g) * 4 - 2).to(cuda)
    before = _path_counts(conv2d_int8)
    got = conv2d_int8(x, wp, s, b, relu=True, out_float=out_float)
    torch.cuda.synchronize()
    assert_launched(conv2d_int8, before, "tc")
    want = conv2d_int8_plain(x, wp, s, b, relu=True, out_float=out_float)
    assert got.dtype == want.dtype and got.shape == (n, h, w, co)
    assert torch.equal(got, want)
    assert torch.equal(conv2d_int8(x, wp, s, b, relu=True,
                                   out_float=out_float), got)


@pytest.mark.parametrize("out_float", [False, True])
def test_student_upconv_site_matches_plain(cuda, out_float):
    g = torch.Generator().manual_seed(64 + out_float)
    h = w = 128
    x = _codes(g, (2, h, w, 64), cuda)
    w2, s4, b4 = pack_upconv(_codes(g, (2, 2, 64, 32), "cpu"),
                             torch.rand(32, generator=g) * 0.2 + 0.03,
                             torch.rand(32, generator=g) * 20 - 10)
    w2 = w2.t().to(cuda).t()
    s4, b4 = s4.to(cuda), b4.to(cuda)
    # the int8 mode fuses the decoder's concat; the float mode takes none
    skip = None if out_float else _codes(g, (2, 2 * h, 2 * w, 32), cuda)
    before = _path_counts(upconv2x2_int8)
    got = upconv2x2_int8(x, w2, s4, b4, skip=skip, out_float=out_float)
    torch.cuda.synchronize()
    assert upconv_path(64, 32) == "tc"
    assert_launched(upconv2x2_int8, before, "tc")
    want = upconv2x2_int8_plain(x, w2, s4, b4, skip=skip,
                                out_float=out_float)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(upconv2x2_int8(x, w2, s4, b4, skip=skip,
                                      out_float=out_float), got)


def test_engine_on_card(cuda):
    from mrisr_tpu_torch.serve import InferenceEngine

    with InferenceEngine(lambda x: x[..., :1] * 2, batch_size=4,
                         input_shape=(8, 8, 2), device=cuda) as eng:
        xs = [np.full((8, 8, 2), i, np.float32) for i in range(6)]
        ys = eng.predict_many(xs)
    for i, y in enumerate(ys):
        np.testing.assert_array_equal(y, np.full((8, 8, 1), 2 * i))
    assert eng.stats.requests == 6


@pytest.mark.parametrize("skip_emit", ["shared", "dual"])
def test_fused_unet_on_card_equals_plain(cuda, skip_emit):
    """The kernels round their epilogue as the plain versions do, so the
    whole int8_fused forward on the card equals the plain one exactly; no
    launch takes kernel A's GEMM form."""
    from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
    from mrisr_tpu_torch.models import UNet
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, calibrate_unet, quantize_unet)

    torch.manual_seed(0)
    folded = fold_unet_batchnorm(UNet(features=8).eval().to(cuda))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 2), generator=g).to(cuda)
    q = quantize_unet(folded, calibrate_unet(folded, [x]))
    gemm = conv2d_int8.launches_gemm
    got = Int8FusedUNet(q, skip_emit, device=cuda)(x)
    want = Int8FusedUNet(q, skip_emit, device=cuda, plain=True)(x)
    assert got.shape == (4, 32, 32, 1)
    assert torch.equal(got, want)
    assert conv2d_int8.launches_gemm == gemm  # its one 1x1 site has Co = 1


# the 18 kernel-A sites of the full-width unet_int8_apply forward (features
# 64, 256^2) at batch 1: (name, H, Ci, Co).  Each runs the float epilogue
# with ReLU, and the forward casts its float32 output to bf16.
UNET_INT8_APPLY_SITES = (
    [(f"{name}/Conv_{i}", 256 >> lvl, ci if i == 0 else co, co)
     for lvl, (name, ci, co) in enumerate(
         (("enc1", 2, 64), ("enc2", 64, 128), ("enc3", 128, 256),
          ("enc4", 256, 512), ("bottleneck", 512, 1024))) for i in (0, 1)]
    + [(f"dec{lvl}/Conv_{i}", 256 >> (lvl - 1), 2 * co if i == 0 else co, co)
       for lvl, co in ((4, 512), (3, 256), (2, 128), (1, 64))
       for i in (0, 1)])


@pytest.mark.parametrize("name,h,ci,co", UNET_INT8_APPLY_SITES,
                         ids=[s[0] for s in UNET_INT8_APPLY_SITES])
def test_conv_int8_float_relu_at_unet_int8_apply_sites(cuda, name, h, ci,
                                                       co):
    """Kernel A's float-epilogue + ReLU mode at the shapes of
    ``unet_int8_apply``: the plain version's bits, twice, on the path
    ``conv_path`` gives the site, and the same bf16 values after the cast."""
    from mrisr_tpu_torch.ops.conv_int8 import conv_path

    g = torch.Generator().manual_seed(h + ci + co)
    x = _codes(g, (1, h, h, ci), cuda)
    wp = pack_conv(_codes(g, (3, 3, ci, co), "cpu")).to(cuda)
    acc_std = 127 * 127 / 3 * (9 * ci) ** 0.5
    s = ((torch.rand(co, generator=g) + 0.5) * 4 / acc_std).to(cuda)
    b = (torch.randn(co, generator=g) * 0.5).to(cuda)
    path = conv_path(ci, co, 3)
    before = _path_counts(conv2d_int8)
    got = conv2d_int8(x, wp, s, b, relu=True, out_float=True)
    torch.cuda.synchronize()
    assert_launched(conv2d_int8, before, path)
    want = conv2d_int8_plain(x, wp, s, b, relu=True, out_float=True)
    assert bool((got == 0).any()) and bool((got > 0).any())
    assert torch.equal(got, want)
    assert torch.equal(got.bfloat16(), want.bfloat16())
    assert torch.equal(conv2d_int8(x, wp, s, b, relu=True, out_float=True),
                       got)


@pytest.mark.parametrize("forward", ["unet_int8_apply", "legacy int8_fused"])
def test_int8_unet_forwards_on_card_equal_plain(cuda, forward):
    """``unet_int8_apply`` (every 3x3 conv through kernel A's float
    epilogue) and the pre-r3 int8_fused fallback (requantizing and float
    epilogues, bf16 upconvs) on the card equal their plain runs."""
    from mrisr_tpu_torch.ckpt import fold_unet_batchnorm
    from mrisr_tpu_torch.models import UNet
    from mrisr_tpu_torch.serve import (
        Int8FusedUNet, Int8UNet, calibrate_unet, quantize_unet)

    torch.manual_seed(0)
    folded = fold_unet_batchnorm(UNet(features=16).eval().to(cuda))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((4, 32, 32, 2), generator=g).to(cuda)
    calib = calibrate_unet(folded, [x])
    if forward == "unet_int8_apply":
        q = quantize_unet(folded, calib)
        run = (Int8UNet(q, device=cuda), Int8UNet(q, device=cuda, plain=True))
        want_a = 18
    else:
        q = quantize_unet(folded, {k: v for k, v in calib.items()
                                   if not k.startswith(("upconv", "final"))})
        run = (Int8FusedUNet(q, device=cuda),
               Int8FusedUNet(q, device=cuda, plain=True))
        want_a = 22  # 4 encoder blocks emit twice ('dual')
    before = conv2d_int8.launches
    got = run[0](x)
    torch.cuda.synchronize()
    assert conv2d_int8.launches - before == want_a
    want = run[1](x)
    assert got.shape == (4, 32, 32, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)


# K1: the eval shapes at 256^2 (test split of 3 patients: 174 3 mm
# triplets), ragged tiles, a 1x1 map, a 512^2 image; a width that is not a
# multiple of the 128-column strip (300), an output map shorter than a band
# (12 rows: 6), an odd width (scalar loads)
SSIM_SHAPES = [(1, 256, 256), (8, 256, 256), (64, 256, 256),
               (174, 256, 256), (3, 37, 53), (2, 7, 7), (1, 512, 512),
               (2, 64, 300), (3, 12, 256), (1, 9, 133)]


def _ssim_pair(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=device)
    y = (x + 0.2 * torch.randn(shape, generator=g, device=device)).clamp(0, 1)
    return x, y


@pytest.mark.parametrize("shape", SSIM_SHAPES, ids=str)
def test_ssim_kernel_matches_plain(cuda, shape):
    """atol 3e-5: the JAX package's own contract (tests/test_ssim.py)."""
    x, y = _ssim_pair(shape, cuda, seed=shape[0])
    before = ssim_fused.launches
    got = ssim_fused(x, y)
    torch.cuda.synchronize()
    assert ssim_fused.launches == before + 1
    want = ssim_fused_plain(x, y)
    assert got.shape == (shape[0],)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
    # deterministic: no float atomics, the same bits on every launch
    assert torch.equal(ssim_fused(x, y), got)


@pytest.mark.parametrize("win,data_range", [(3, 1.0), (11, 255.0)])
def test_ssim_kernel_window_and_range(cuda, win, data_range):
    x, y = _ssim_pair((4, 40, 70), cuda, seed=win)
    got = ssim_fused(x * data_range, y * data_range, data_range=data_range,
                     win_size=win)
    want = ssim_fused_plain(x * data_range, y * data_range,
                            data_range=data_range, win_size=win)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("win", [3, 11])
def test_ssim_kernel_window_across_strips(cuda, win):
    """win 3 and 11 on three strips: the halo (2 and 10 columns past a
    strip) gathered from the neighbouring strip's columns."""
    x, y = _ssim_pair((2, 30, 300), cuda, seed=win)
    got = ssim_fused(x, y, win_size=win)
    torch.testing.assert_close(got, ssim_fused_plain(x, y, win_size=win),
                               rtol=0, atol=3e-5)
    assert torch.equal(ssim_fused(x, y, win_size=win), got)


def test_ssim_kernel_identical_pair_is_one(cuda):
    x, _ = _ssim_pair((8, 256, 256), cuda)
    torch.testing.assert_close(ssim_fused(x, x), torch.ones(8, device=cuda),
                               rtol=0, atol=1e-6)


def test_ssim_kernel_refuses_what_it_does_not_take(cuda):
    x, y = _ssim_pair((2, 16, 16), cuda)
    with pytest.raises(ValueError, match="odd"):
        ssim_fused(x, y, win_size=4)
    with pytest.raises(ValueError, match="smaller"):
        ssim_fused(x[:, :6], y[:, :6])
    with pytest.raises(ValueError, match="one CUDA device"):
        ssim_fused(x, y.cpu())


def test_ssim_use_kernel_raises_on_cpu_tensor():
    x = torch.rand(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssim(x, x, use_kernel=True)


def test_train_step_and_device_epoch_on_card(cuda, tmp_path):
    """One combined-loss train step on the card against the CPU from the
    same init (FEAT 8, 64^2, batch 4), then a train epoch with the batches
    gathered on the card and augmented there."""
    import dataclasses

    from mrisr_tpu_torch.config import PRESETS
    from mrisr_tpu_torch.data.pipeline import build_loader
    from mrisr_tpu_torch.data.synthetic import make_synthetic_store
    from mrisr_tpu_torch.losses import make_perceptual_fn
    from mrisr_tpu_torch.train import SupervisedTrainer

    base = PRESETS["unet_combined"]
    cfg = base.replace(
        data=dataclasses.replace(base.data, image_size=(64, 64),
                                 augment=False),
        model=dataclasses.replace(base.model, base_features=8))
    store = make_synthetic_store(str(tmp_path / "s"), num_patients=8,
                                 slices_per_volume=8, height=64, width=64)
    batch = next(iter(build_loader(store, "train", cfg.data, device="cpu")))
    fn = make_perceptual_fn("gabor")
    card = SupervisedTrainer(cfg, perceptual_fn=fn, device=cuda)
    cpu = SupervisedTrainer(cfg, perceptual_fn=fn, device="cpu")
    _, mc = card.train_step(card.state, batch.to(cuda))
    _, mh = cpu.train_step(cpu.state, batch)
    assert float(mc["loss"]) == pytest.approx(float(mh["loss"]), rel=1e-4)
    hp = dict(cpu.state.module.named_parameters())
    for name, p in card.state.module.named_parameters():
        if name.endswith(("conv.0.bias", "conv.3.bias")):
            continue  # zero in exact arithmetic before a training-mode BN
        g, want = p.grad.cpu().double(), hp[name].grad.double()
        assert float((g - want).norm() / want.norm()) <= 1e-3, name
    hb = dict(cpu.state.module.named_buffers())
    for name, b in card.state.module.named_buffers():
        if "running" in name:
            torch.testing.assert_close(b.cpu(), hb[name], rtol=0, atol=1e-4)
    aug = dataclasses.replace(cfg.data, augment=True, rotate_degrees=5.0)
    loader = build_loader(store, "train", aug, backend="device", device=cuda)
    first = next(iter(loader))
    assert first.device.type == "cuda" and first.shape == (4, 64, 64, 3)
    card.enable_device_epochs(loader.bank, loader.plan_flat)
    metrics = card.run_epoch(None, train=True, epoch=1)
    assert np.isfinite(metrics["loss"])
    assert card.timings[-1]["steps"] == loader.num_samples // 4



def test_routed_conv_matches_cudnn_on_card(cuda):
    """dec2.conv.0's shape at batch 4 goes around cuDNN on the card; its
    forward and gradients agree with cuDNN's own conv within 1e-5."""
    import torch.nn.functional as F

    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.models.conv import Conv2d, avoids_cudnn

    torch.manual_seed(0)
    conv = Conv2d(256, 128, 3, padding=1).to(cuda)
    x = torch.randn(4, 256, 128, 128, device=cuda).contiguous(
        memory_format=torch.channels_last)
    assert avoids_cudnn(x, conv)
    outs = []
    for routed in (True, False):
        leaf = x.detach().requires_grad_(True)
        conv.zero_grad()
        with fp32_reference():
            y = conv(leaf) if routed else F.conv2d(leaf, conv.weight,
                                                   conv.bias, 1, 1)
            y.square().mean().backward()
        outs.append((y.detach(), leaf.grad, conv.weight.grad.clone()))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def test_remat_step_keeps_conv_routes_on_card(cuda, monkeypatch):
    """A remat train step at 64^2, batch 2 (where recorded convs take the
    'small map' route) against the plain step from the same weights: each
    conv's route in the backward's re-run is its route in the forward, and
    the plain step's; gradients within rel-L2 1e-5 (a conv bias before a
    training-mode BatchNorm against its weight's gradient), running
    statistics equal."""
    from mrisr_tpu_torch import fp32_reference
    from mrisr_tpu_torch.losses import mse
    from mrisr_tpu_torch.models import UNet, blocks
    from mrisr_tpu_torch.models import conv as conv_mod

    routes, rerun = [], {"now": False}
    real = conv_mod.avoids_cudnn

    def spy(x, conv):
        around = real(x, conv)
        routes.append((conv, rerun["now"], around))
        return around

    monkeypatch.setattr(conv_mod, "avoids_cudnn", spy)
    torch.manual_seed(0)
    state = UNet(features=8).state_dict()
    g = torch.Generator().manual_seed(1)
    batch = torch.rand(2, 64, 64, 3, generator=g).to(cuda)
    runs = {}
    for remat in (False, True):
        routes.clear()
        model = UNet(features=8, remat=remat).to(cuda)
        model.load_state_dict(state)
        for m in model.modules():  # a block's re-run marks its BatchNorms
            if isinstance(m, blocks.DoubleConv):
                m.register_forward_pre_hook(lambda m, i: rerun.update(
                    now=m.conv[1].recomputing))
        with fp32_reference():
            mse(model.train()(batch[..., :2]), batch[..., 2:]).backward()
        names = {m: n for n, m in model.named_modules()}
        runs[remat] = (model, [(names[c], r, a) for c, r, a in routes])
    (plain, plain_routes), (remat, remat_routes) = runs[False], runs[True]
    forward = [(n, a) for n, r, a in remat_routes if not r]
    again = {n: a for n, r, a in remat_routes if r}
    assert forward == [(n, a) for n, _, a in plain_routes]
    assert all(a for _, a in forward)  # 'small map' at every conv
    block_convs = [n for n, _ in forward if n != "final"]
    assert sorted(again) == sorted(block_convs) and len(again) == 18
    assert all(again[n] == a for n, a in forward if n in again)
    want = dict(plain.named_parameters())
    for name, p in remat.named_parameters():
        conv, _, leaf = name.rpartition(".")
        ref = (want[conv + ".weight"] if leaf == "bias"
               and conv.endswith((".conv.0", ".conv.3")) else want[name])
        err = float((p.grad - want[name].grad).norm() / ref.grad.norm())
        assert err <= 1e-5, (name, err)
    bufs = dict(plain.named_buffers())
    for name, b in remat.named_buffers():
        assert torch.equal(b, bufs[name]), name


def test_ddpm_unet_int8_deep_call_on_card(cuda):
    """One int8_deep denoiser call of the DDPM UNet (models/ddpm_unet.py;
    the published ch 128, whose 32 GroupNorm groups are 4 to 32 channels
    wide, at 64^2: all six levels and the attention) through K3 and kernel
    A: 71 K3 and 99 A launches, the same bits twice, and within 2 % (rel
    L2) of the same tables through the kernels' plain versions, which the
    kernels' own bf16 roundings move that far through 120 convs."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    params = fastddpm_flax_params(DDPMUNet(base_features=128).to(cuda))
    sched = DiffusionSchedule.create(1000, 2, "linear", "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 64, 64, 2), generator=g).to(cuda)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    x = torch.randn((2, 64, 64, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    fwd = int8_forward(q, device=cuda)
    counts = (conv2d_int8.launches, groupnorm_silu.launches,
              groupnorm_silu.launches_shift)
    got = fwd(x, t)
    assert (conv2d_int8.launches - counts[0],
            groupnorm_silu.launches - counts[1],
            groupnorm_silu.launches_shift - counts[2]) == (99, 71, 32)
    assert torch.equal(fwd(x, t), got)
    want = int8_forward(q, device=cuda, plain=True)(x, t)
    assert got.shape == (2, 64, 64, 1) and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.02, rel


# the distinct (H, C) of the quantizer's inputs in both nets' int8_deep
# call at 256^2 (the notebook net at base 64, the DDPM UNet at ch 128)
QUANT_SHAPES = sorted({s[1:] for net, ch in (("notebook", 64), ("ddpm", 128))
                       for s in quant_sites(net, ch, 256)})


@pytest.mark.parametrize("h,c", QUANT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_quantize_kernel_matches_plain_at_site_shapes(cuda, h, c, dtype):
    """The quantizer kernel at every input shape of both nets' int8_deep
    call, batch 32, from bf16 (what the forward quantizes) and float32,
    at a scale that saturates the top of |x|: the plain version's codes,
    twice, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(1000 * h + c)
    x = (3 * torch.randn((32, h, h, c), generator=g, device=cuda)).to(dtype)
    a = (x.float().abs().amax() / 150.0).reshape(1)
    before = quantize_int8.launches
    got = quantize_int8(x, a)
    torch.cuda.synchronize()
    assert quantize_int8.launches == before + 1
    want = quantize_int8_plain(x, a)
    assert bool((want == 127).any()) and bool((want == -127).any())
    assert torch.equal(got, want)
    assert torch.equal(quantize_int8(x, a), got)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_quantize_kernel_edges_tails_and_unaligned_bases(cuda, dtype, offset):
    """Ties, near-ties, the saturation edges, +-inf and NaN
    (:func:`quant_edge_values`) at three scales, a per-step scale row
    taken by ``index_select``; lengths 1 to 17 and others that are not a
    multiple of 8 or 16 (the scalar tail), from a base ``offset`` elements
    past 16-byte alignment (1, 3: the scalar path throughout): the plain
    version's codes."""
    g = torch.Generator().manual_seed(offset)
    table = torch.tensor([0.5, 0.1, 0.25, 0.0371], device=cuda)
    for row in (1, 2, 3):
        a = table.index_select(0, torch.tensor([row], device=cuda))
        vals = quant_edge_values(float(a), dtype)
        rand = (60 * float(a) * torch.randn(5000, generator=g)).to(dtype)
        buf = torch.cat([vals, torch.tensor([float("nan")], dtype=dtype),
                         rand]).to(cuda)
        for n in (1, 7, 9, 15, 17, 1023, buf.numel() - offset):
            x = buf[offset:offset + n]
            assert (x.data_ptr() % 16 != 0) == (offset != 0)
            assert torch.equal(quantize_int8(x, a), quantize_int8_plain(x, a))


def kernels_in_spans(prof, name, path):
    """The names of the kernels that start inside each device-side range
    of the record_function ``name`` (the trace's ``gpu_user_annotation``,
    which runs from the first to the last kernel launched inside the
    range), read from the profiler's trace written to ``path``."""
    import json

    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return [[k["name"] for k in kernels
             if s["ts"] - 1e-3 <= k["ts"] < s["ts"] + s["dur"]]
            for s in events if s.get("cat") == "gpu_user_annotation"
            and s.get("name") == name]


@pytest.mark.parametrize("net", ["notebook", "ddpm"])
def test_quantizer_in_an_int8_deep_sampler_call(cuda, net, tmp_path):
    """One int8_deep sampler call (10 steps) of each net through the
    kernels: the quantizer launches 6 (notebook net) or 27 (DDPM UNet)
    times a step, 60 or 270 a call, and the call has the same bits with
    the quantizer's plain version in its place.  Under a profiler each of a
    denoiser call's ``ddpm.quant`` spans holds the quantizer kernel and no
    other kernel (no copy, divide, round or clamp)."""
    from torch.profiler import ProfilerActivity, profile

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
        sample_ancestral,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    model, hw, per_step = ((FastDDPMUNet(base_features=16, time_dim=32), 32,
                            6) if net == "notebook" else
                           (DDPMUNet(base_features=128), 64, 27))
    params = fastddpm_flax_params(model.to(cuda))
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, hw, hw, 2), generator=g).to(cuda)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    fwd, ref = (int8_forward(q, device=cuda) for _ in range(2))
    ref._q8 = quantize_int8_plain
    before = quantize_int8.launches
    got = sample_ancestral(fwd, cond, torch.Generator(cuda).manual_seed(2),
                           sched)
    torch.cuda.synchronize()
    assert quantize_int8.launches - before == 10 * per_step
    want = sample_ancestral(ref, cond, torch.Generator(cuda).manual_seed(2),
                            sched)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)

    x = torch.randn((2, hw, hw, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[0]), device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd(x, t)
        torch.cuda.synchronize()
    spans = [e for e in prof.events() if e.name == "ddpm.quant"
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(spans) == per_step
    kernels = kernels_in_spans(prof, "ddpm.quant", tmp_path / "trace.json")
    assert len(kernels) == per_step
    assert all(len(k) == 1 and "quantize_kernel" in k[0] for k in kernels), (
        kernels)


def adm_gn_sites():
    """ADM's 101 GroupNorm sites at ch 256, 256^2 (models/adm_unet.py; 32
    groups of 8 to 64 channels, eps 1e-5): (name, H, C, groups, int8 out,
    SiLU, eps, scale-shift: a ResBlock's out_layers norm).  A
    down-ResBlock's first norm emits bf16 (its maps are pooled before the
    quantizer); the full-size level and the final norm bf16 too."""
    from mrisr_tpu_torch.models.adm_unet import layout

    inputs, mid, outputs = layout(256)
    sites = []

    def res(name, lvl_in, lvl_out, ci, co, codes=True):
        sites.extend([
            (f"{name}/in_layers/0", 256 >> lvl_in, ci, 32,
             codes and lvl_out > 0, True, 1e-5, False),
            (f"{name}/out_layers/0", 256 >> lvl_out, co, 32, lvl_out > 0,
             True, 1e-5, True)])

    def attn(name, lvl, c):
        sites.append((f"{name}/norm", 256 >> lvl, c, 32, True, False, 1e-5,
                      False))

    for k, blk in enumerate(inputs[1:], start=1):
        down = blk.kind == "down"
        res(f"input_blocks/{k}/0", blk.level - down, blk.level, blk.ci,
            blk.co, not down)
        if blk.attn:
            attn(f"input_blocks/{k}/1", blk.level, blk.co)
    res("middle_block/0", 5, 5, mid, mid)
    attn("middle_block/1", 5, mid)
    res("middle_block/2", 5, 5, mid, mid)
    for k, blk in enumerate(outputs):
        res(f"output_blocks/{k}/0", blk.level, blk.level, blk.ci, blk.co)
        if blk.attn:
            attn(f"output_blocks/{k}/1", blk.level, blk.co)
        if blk.up:
            res(f"output_blocks/{k}/{1 + blk.attn}", blk.level,
                blk.level - 1, blk.co, blk.co)
    sites.append(("out/0", 256, 256, 32, False, True, 1e-5, False))
    return sites


# (name, H, C) of each distinct out_layers norm shape of ADM, and of each
# distinct other norm shape
ADM_SCALE_SHIFT_CASES = [s[:3] for s in _distinct(adm_gn_sites()) if s[-1]]
ADM_GN_CASES = [s[:3] + s[5:6] for s in _distinct(adm_gn_sites())
                if not s[-1]]


@pytest.mark.parametrize("name,h,c", ADM_SCALE_SHIFT_CASES, ids=str)
def test_groupnorm_kernel_scale_shift_matches_plain(cuda, name, h, c):
    """K3 in its scale-shift mode at every out_layers norm shape of ADM
    (256^2 x 256 to 8^2 x 1024, groups of 8 to 32), batch 32: int8 codes
    equal to the plain version's, bf16 out within one bf16 rounding step
    (max(0.03, 2^-8 |y|)), the same bits twice, one launch counted in
    ``launches_scale_shift``."""
    x, gamma, beta, _ = _site_case(cuda, h, c)
    g = torch.Generator(device=cuda).manual_seed(c + h)
    ss = (0.5 * torch.randn((32, 2 * c), generator=g, device=cuda)).to(
        torch.bfloat16)
    kw = dict(num_groups=32, eps=1e-5, scale_shift=ss)
    ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32, **kw)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    before = (groupnorm_silu.launches, groupnorm_silu.launches_shift,
              groupnorm_silu.launches_scale_shift)
    q = groupnorm_silu(x, gamma, beta, quant_scale=scale, **kw)
    torch.cuda.synchronize()
    assert (groupnorm_silu.launches, groupnorm_silu.launches_shift,
            groupnorm_silu.launches_scale_shift) == (
        before[0] + 1, before[1], before[2] + 1)
    assert torch.equal(q, groupnorm_silu_plain(x, gamma, beta,
                                               quant_scale=scale, **kw))
    assert torch.equal(groupnorm_silu(x, gamma, beta, quant_scale=scale,
                                      **kw), q)
    y16 = groupnorm_silu(x, gamma, beta, **kw)
    tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
    assert bool(((y16.float() - ref).abs() <= tol).all())
    assert torch.equal(groupnorm_silu(x, gamma, beta, **kw), y16)
    with pytest.raises(ValueError, match="scale_shift"):
        groupnorm_silu(x, gamma, beta, num_groups=32, scale_shift=ss,
                       shift=ss[:, :c])


@pytest.mark.parametrize("name,h,c,silu", ADM_GN_CASES, ids=str)
def test_groupnorm_kernel_adm_groups_match_plain(cuda, name, h, c, silu):
    """K3 without a scale-shift at ADM's other norm shapes, up to 2048
    channels in groups of 64 and 1536 in groups of 48 (the decoder's
    concatenations), batch 32: the plain version's int8 codes, bf16
    within one rounding step."""
    x, gamma, beta, _ = _site_case(cuda, h, c)
    kw = dict(num_groups=32, eps=1e-5, silu=silu)
    ref = groupnorm_silu_plain(x, gamma, beta, out_dtype=torch.float32, **kw)
    scale = (ref.abs().amax() / 127.0).reshape(1)
    q = groupnorm_silu(x, gamma, beta, quant_scale=scale, **kw)
    assert torch.equal(q, groupnorm_silu_plain(x, gamma, beta,
                                               quant_scale=scale, **kw))
    y16 = groupnorm_silu(x, gamma, beta, **kw)
    tol = torch.clamp_min(ref.abs() * 2.0 ** -8, 0.03)
    assert bool(((y16.float() - ref).abs() <= tol).all())


def test_adm_unet_int8_deep_call_on_card(cuda):
    """One int8_deep denoiser call of ADM's UNet (models/adm_unet.py at
    its published ch 256 and heads of 64, 256^2, batch 2) through K3,
    kernel A, the quantizer and torch's fused attention: 121 A and 101 K3
    launches, 42 of them in the scale-shift mode, the 16 attention cores
    all on the fused path (8 heads at 32^2), both channels out, the
    same bits twice, and within 2 % (rel L2) of the same tables through
    the kernels' plain versions."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.adm_unet import ADMUNet, qkv_attention
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    params = fastddpm_flax_params(ADMUNet(base_features=256).to(cuda))
    sched = DiffusionSchedule.create(1000, 2, "linear", "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 256, 256, 2), generator=g).to(cuda)
    calib = calibrate_fastddpm({"params": params}, sched, [cond])
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    x = torch.randn((2, 256, 256, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    fwd = int8_forward(q, device=cuda)
    counts = (conv2d_int8.launches, groupnorm_silu.launches,
              groupnorm_silu.launches_scale_shift,
              qkv_attention.calls_fused, qkv_attention.calls_float)
    got = fwd(x, t)
    torch.cuda.synchronize()
    assert (conv2d_int8.launches - counts[0],
            groupnorm_silu.launches - counts[1],
            groupnorm_silu.launches_scale_shift - counts[2],
            qkv_attention.calls_fused - counts[3],
            qkv_attention.calls_float - counts[4]) == (121, 101, 42, 16, 0)
    assert torch.equal(fwd(x, t), got)
    want = int8_forward(q, device=cuda, plain=True)(x, t)
    assert got.shape == (2, 256, 256, 2) and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.02, rel


# kernel E's (H, C, mode) at 256^2 in one int8_deep call of each network
# at its published width (batch 32 in the served call): 'bias' alone, with
# the block input as 'residual', or with a 1x1 'shortcut' conv's output and
# its bias.  The notebook net at base 64: init_conv, upconv1 (bias), enc1,
# dec1 (shortcut); the DDPM UNet at ch 128: conv_in and up/1's upsample
# conv (bias), the two down-blocks (residual), the three up-blocks
# (shortcut), the five stride-2 downsamples (bias, 128^2 x 128 down to
# 8^2 x 512); ADM at ch 256: conv_in and six conv1 (bias), three
# residual, three shortcut.
BIAS_SHAPES = [(256, 64, "bias"), (256, 64, "shortcut"),
               (256, 128, "bias"), (256, 128, "residual"),
               (256, 128, "shortcut"), (128, 128, "bias"), (64, 128, "bias"),
               (32, 256, "bias"), (16, 256, "bias"), (8, 512, "bias"),
               (256, 256, "bias"), (256, 256, "residual"),
               (256, 256, "shortcut")]


def _bits(t):
    """Bit patterns, so that a NaN equals itself."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _bias_case(g, shape, mode, dtype, device):
    """(y, b, r, rb) of ``mode`` at NHWC ``shape``."""
    c = shape[-1]

    def draw(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=device)).to(dtype)

    y, b = draw(*shape, scale=3.0), draw(c)
    r = None if mode == "bias" else draw(*shape, scale=2.0)
    rb = draw(c) if mode == "shortcut" else None
    return y, b, r, rb


@pytest.mark.parametrize("h,c,mode", BIAS_SHAPES, ids=str)
def test_bias_residual_kernel_matches_plain_at_site_shapes(cuda, h, c, mode):
    """Kernel E at every (H, C, mode) of the three networks' int8_deep
    call, batch 32, bf16: the plain version's bits, in place into y (the
    same tensor back), r untouched, the same bits on a second launch, one
    launch counted (with a residual: counted as such too)."""
    g = torch.Generator(device=cuda).manual_seed(100 * h + c)
    y, b, r, rb = _bias_case(g, (32, h, h, c), mode, torch.bfloat16, cuda)
    r_before = None if r is None else r.clone()
    want = bias_residual_plain(y.clone(), b, r, rb)
    again = y.clone()
    before = (bias_residual.launches, bias_residual.launches_residual)
    got = bias_residual(y, b, r, rb)
    torch.cuda.synchronize()
    assert got is y
    assert (bias_residual.launches - before[0],
            bias_residual.launches_residual - before[1]) == (
                1, int(r is not None))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(bias_residual(again, b, r, rb)), _bits(got))
    if r is not None:
        assert torch.equal(_bits(r), _bits(r_before))


@pytest.mark.parametrize("mode", ["bias", "residual", "shortcut"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_bias_residual_kernel_ragged_and_unaligned(cuda, offset, dtype,
                                                   mode):
    """Pixel counts 1, 3, 37 and 1001 (no whole grid stride), rows of 8 to
    1024 channels, from a base ``offset`` elements past 16-byte alignment
    (1, 3: the scalar path throughout; 8: 16 bytes on in bf16, 32 in
    float32, the vector path), float32 too, with +-inf and NaN in y: the
    plain version's bits, r untouched."""
    g = torch.Generator(device=cuda).manual_seed(offset)
    for pixels, c in ((1, 8), (3, 24), (37, 64), (1001, 1024)):
        n = pixels * c
        y, b, r, rb = _bias_case(g, (n + offset,), mode, dtype, cuda)
        y[offset + 3:offset + 6] = torch.tensor(
            [float("inf"), float("-inf"), float("nan")], dtype=dtype)
        b, rb = (torch.randn(c, generator=g, device=cuda).to(dtype),
                 None if rb is None else
                 torch.randn(c, generator=g, device=cuda).to(dtype))
        ys = y[offset:].view(pixels, c)
        rs = None if r is None else r[offset:].view(pixels, c)
        assert (ys.data_ptr() % 16 != 0) == (offset in (1, 3))
        r_before = None if rs is None else rs.clone()
        want = bias_residual_plain(ys.clone(), b, rs, rb)
        assert torch.equal(_bits(bias_residual(ys, b, rs, rb)), _bits(want))
        if rs is not None:
            assert torch.equal(_bits(rs), _bits(r_before))


@pytest.mark.parametrize("mode", ["bias", "residual", "shortcut"])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_bias_residual_after_cudnn_is_its_conv_with_bias(cuda, c, mode):
    """On the card, cuDNN's bf16 conv without its bias, then E, is
    ``F.conv2d(h, w, b)`` (``+ x``, ``+ F.conv2d(x, ws, bs)``) bit for bit:
    torch adds a cuDNN conv's bias in a pass of its own, and E repeats its
    roundings; and the transposed conv (the notebook net's upconv1)."""
    import torch.nn.functional as F

    g = torch.Generator(device=cuda).manual_seed(c)

    def draw(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=cuda)).to(
            torch.bfloat16)

    cl = torch.channels_last
    h = draw(4, c, 64, 64).contiguous(memory_format=cl)
    w = draw(c, c, 3, 3, scale=0.05).contiguous(memory_format=cl)
    x = draw(4, 2 * c, 64, 64).contiguous(memory_format=cl)
    ws = draw(c, 2 * c, 1, 1, scale=0.1).contiguous(memory_format=cl)
    b, bs = draw(c), draw(c)
    want = F.conv2d(h, w, b, padding=1)
    r = rb = None
    if mode == "residual":
        r = draw(4, 64, 64, c)
        want = want + r.permute(0, 3, 1, 2)
    elif mode == "shortcut":
        want = want + F.conv2d(x, ws, bs)
        r, rb = F.conv2d(x, ws).permute(0, 2, 3, 1), bs
    y = F.conv2d(h, w, padding=1).permute(0, 2, 3, 1)
    got = bias_residual(y, b, r, rb)
    assert torch.equal(_bits(got), _bits(want.permute(0, 2, 3, 1)))
    wt = draw(c, c, 2, 2, scale=0.1)
    want_t = F.conv_transpose2d(h, wt, b, stride=2)
    got_t = bias_residual(F.conv_transpose2d(h, wt, stride=2).permute(
        0, 2, 3, 1).contiguous(), b)
    assert torch.equal(_bits(got_t), _bits(want_t.permute(0, 2, 3, 1)))


def _adds(prof):
    """(torch's non-vectorized adds, its vectorized adds) among the
    kernels a profiled run launched."""
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    adds = [n for n in names if "add" in n.lower()
            and "elementwise_kernel" in n]
    plain = [n for n in adds if "elementwise_kernel<128, 4" in n
             and "vectorized" not in n]
    return len(plain), sum("vectorized_elementwise_kernel" in n
                           for n in adds)


@pytest.mark.parametrize("net", ["notebook", "ddpm", "adm"])
def test_bias_residual_in_an_int8_deep_call(cuda, net):
    """One int8_deep denoiser call of each network at its published width,
    256^2, batch 2, through the kernels: E launched 4 / 12 / 13 times, 2 /
    5 / 6 of them with a residual (``bias_sites``); the same bits with E's
    plain version in its place, and with E's routing off (cuDNN's biases
    and torch's residual add, as before E); under a profiler, torch's
    non-vectorized adds fall by E's launches and its shortcut biases (each
    a bias add of cuDNN's conv that E took) to the output conv's one (1
    or 2 channels), its vectorized adds by the residuals E took."""
    from torch.profiler import ProfilerActivity, profile

    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.adm_unet import ADMUNet
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    model = {"notebook": lambda: FastDDPMUNet(base_features=64),
             "ddpm": lambda: DDPMUNet(base_features=128),
             "adm": lambda: ADMUNet(base_features=256)}[net]()
    params = fastddpm_flax_params(model.to(cuda))
    del model
    sched = DiffusionSchedule.create(1000, 2, "linear", "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 256, 256, 2), generator=g).to(cuda)
    q = quantize_fastddpm({"params": params},
                          calibrate_fastddpm({"params": params}, sched,
                                             [cond]),
                          only=deep_sites(params))
    del params
    x = torch.randn((2, 256, 256, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    fwd = int8_forward(q, device=cuda)
    assert fwd._e
    sites = bias_sites(net)
    before = (bias_residual.launches, bias_residual.launches_residual)
    got = fwd(x, t)
    torch.cuda.synchronize()
    assert (bias_residual.launches - before[0],
            bias_residual.launches_residual - before[1]) == (
                len(sites), sum(r for _, _, r in sites))
    assert bool(torch.isfinite(got).all())
    fwd._bias = bias_residual_plain
    assert torch.equal(fwd(x, t), got)
    fwd._bias, fwd._e = bias_residual, False
    assert torch.equal(fwd(x, t), got)
    counts = {}
    for on in (True, False):
        fwd._e = on
        fwd(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd(x, t)
            torch.cuda.synchronize()
        counts[on] = _adds(prof)
    shortcuts = sum(s is not None for _, s, _ in sites)
    print(f"{net}: torch's adds (non-vectorized, vectorized) a call with E "
          f"{counts[True]}, without {counts[False]}")
    assert counts[False][0] - counts[True][0] == len(sites) + shortcuts
    assert counts[True][0] == 1
    assert counts[False][1] - counts[True][1] == sum(
        r for _, _, r in sites)


# DiT-XL/8 (models/dit.py) at its published widths: batch 32 of 1024
# tokens (32^2 of a 256^2 slice), 1152 channels; a small width and a
# ragged token count besides
LN_SHAPES = [(32, 1024, 1152), (2, 1024, 1152), (3, 100, 64), (2, 37, 2048)]


def _ln_case(cuda, b, t, c, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(b * t + c)
    x = (torch.randn((b, t, c), generator=g, device=cuda) * 2 + 0.3).to(dtype)
    mods = 0.5 * torch.randn((b, 6 * c), generator=g, device=cuda)
    return x, mods


@pytest.mark.parametrize("b,t,c", LN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_layernorm_kernel_matches_plain(cuda, b, t, c, dtype):
    """Kernel L against its plain version at DiT's shape and others, the
    (shift, scale) rows read through a strided view of all six adaLN rows
    (a block's second half): int8 codes equal, the float output equal bit
    for bit (within one rounding of the float64 formula), the same bits
    twice; one launch each, counted in ``launches`` and, with codes, in
    ``launches_codes``."""
    from mrisr_tpu_torch.ops.layernorm import (
        layernorm_modulate,
        layernorm_modulate_plain,
    )

    if dtype == torch.float32 and c > 2048:
        pytest.skip("the float32 form holds rows of 2048 channels at most")
    x, mods = _ln_case(cuda, b, t, c, dtype)
    ss = mods[:, 3 * c:5 * c]
    want = layernorm_modulate_plain(x, ss, eps=1e-6)
    scale = (want.float().abs().amax() / 127.0).reshape(1)
    before = (layernorm_modulate.launches, layernorm_modulate.launches_codes)
    q = layernorm_modulate(x, ss, eps=1e-6, quant_scale=scale)
    y = layernorm_modulate(x, ss, eps=1e-6)
    torch.cuda.synchronize()
    assert (layernorm_modulate.launches - before[0],
            layernorm_modulate.launches_codes - before[1]) == (2, 1)
    assert torch.equal(q, layernorm_modulate_plain(x, ss, eps=1e-6,
                                                   quant_scale=scale))
    assert torch.equal(y, want) and y.dtype == dtype
    assert torch.equal(layernorm_modulate(x, ss, eps=1e-6,
                                          quant_scale=scale), q)
    xd = x.double()
    norm = (xd - xd.mean(-1, keepdim=True)) / torch.sqrt(
        xd.var(-1, unbiased=False, keepdim=True) + 1e-6)
    exact = norm * (1 + ss[:, None, c:].double()) + ss[:, None, :c].double()
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -21
    assert bool(((y.double() - exact).abs() <= exact.abs() * ulp + 1e-5)
                .all())


def test_layernorm_kernel_refuses_what_it_does_not_take(cuda):
    from mrisr_tpu_torch.ops.layernorm import layernorm_modulate

    x, mods = _ln_case(cuda, 2, 16, 64)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm_modulate(x[..., :60].contiguous(), mods[:, :120])
    with pytest.raises(ValueError, match="shift_scale"):
        layernorm_modulate(x, mods[:, :128].to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        layernorm_modulate(x.transpose(0, 1), mods[:, :128])


# DiT's four block linears as 1x1 convs of its 32^2 token map: (Ci, Co)
DIT_LINEARS = [(1152, 3456), (1152, 1152), (1152, 4608), (4608, 1152)]


@pytest.mark.parametrize("n", [4, 1])
def test_conv_int8_gelu_form_matches_plain(cuda, n):
    """Kernel A's GELU form at DiT's fc1 (1152 -> 4608 over 32^2 tokens,
    batch 4, and batch 1): the codes of GELU(y) at the next site's scale
    against the plain version's (torch's GELU, then the quantizer): none
    more than one code apart, and fewer than 1e-4 of them apart at all
    (the kernel's fast exponential, about 1e-6 relative); the same bits
    twice; one launch, counted in ``launches_gelu`` and on the
    tensor-core path."""
    g = torch.Generator().manual_seed(n)
    ci, co = 1152, 4608
    x = _codes(g, (n, 32, 32, ci), cuda)
    wp = pack_conv(_codes(g, (1, 1, ci, co), cuda))
    s = (torch.rand(co, generator=g) * 2e-5).to(cuda)
    b = (torch.randn(co, generator=g) * 0.2).to(cuda)
    y = conv2d_int8_plain(x, wp, s, b, relu=False, out_float=True)
    a = (torch.nn.functional.gelu(y, approximate="tanh").abs().amax()
         / 127.0).reshape(1)
    before = (_path_counts(conv2d_int8), conv2d_int8.launches_gelu)
    got = conv2d_int8(x, wp, s, b, relu=False, gelu_scale=a)
    torch.cuda.synchronize()
    assert_launched(conv2d_int8, before[0], "tc")
    assert conv2d_int8.launches_gelu == before[1] + 1
    want = conv2d_int8_plain(x, wp, s, b, relu=False, gelu_scale=a)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) < 1e-4, float(
        (diff > 0).float().mean())
    assert torch.equal(conv2d_int8(x, wp, s, b, relu=False, gelu_scale=a),
                       got)
    with pytest.raises(ValueError, match="tensor-core"):
        conv2d_int8(_codes(g, (1, 4, 4, 8), cuda),
                    pack_conv(_codes(g, (1, 1, 8, 16), cuda)), s[:16], b[:16],
                    relu=False, gelu_scale=a)


# Kernel A's GEMM form (1x1 sites): DiT's four linears at batch 2, and
# ragged shapes: M not a multiple of its 128-row tiles (63, 429, 800
# pixels), Co not a multiple of its 128 columns (200, 72, 8, 1000), Ci 64 x
# an odd number (192, 320) and 16 (one TMA row a fifth full)
GEMM_CASES = [(2, 32, 32, 1152, 3456), (2, 32, 32, 1152, 1152),
              (2, 32, 32, 1152, 4608), (2, 32, 32, 4608, 1152),
              (1, 9, 7, 192, 200), (3, 11, 13, 64, 72), (3, 11, 13, 16, 8),
              (2, 20, 20, 320, 1000)]


def _gemm_case(cuda, n, h, w, ci, co, seed):
    g = torch.Generator().manual_seed(seed)
    x = _codes(g, (n, h, w, ci), cuda)
    wp = pack_conv(_codes(g, (1, 1, ci, co), cuda))
    acc_std = 127 * 127 / 3 * ci ** 0.5
    s = ((torch.rand(co, generator=g) * 2 + 0.3) * 60 / acc_std).to(cuda)
    b = (torch.rand(co, generator=g) * 4 - 2).to(cuda)
    return x, wp, s, b


@pytest.mark.parametrize("n,h,w,ci,co", GEMM_CASES, ids=str)
@pytest.mark.parametrize("out_float,relu", [(True, False), (False, False),
                                            (False, True)])
def test_conv_int8_gemm_form_matches_plain(cuda, n, h, w, ci, co, out_float,
                                           relu):
    """The GEMM form: the plain version's float32 or codes bit for bit, the
    conv form's bits (the same exact sums through the same epilogue), the
    same bits twice; one launch, counted in ``launches_gemm`` and on the
    tensor-core path."""
    from mrisr_tpu_torch.ops.conv_int8 import conv_form

    assert conv_form(n * h * w, ci, co, 1) == "gemm"
    x, wp, s, b = _gemm_case(cuda, n, h, w, ci, co, ci + co + n)
    kw = dict(relu=relu, out_float=out_float)
    before = (_path_counts(conv2d_int8), conv2d_int8.launches_gemm)
    got = conv2d_int8(x, wp, s, b, **kw)
    torch.cuda.synchronize()
    assert_launched(conv2d_int8, before[0], "tc")
    assert conv2d_int8.launches_gemm == before[1] + 1
    assert torch.equal(got, conv2d_int8_plain(x, wp, s, b, **kw))
    assert torch.equal(conv2d_int8(x, wp, s, b, _form="tc", **kw), got)
    assert torch.equal(conv2d_int8(x, wp, s, b, **kw), got)


def _gelu_codes_direct(y, a):
    """The codes of GELU's tanh form at scale ``a``, in float64 and in the
    form the kernel computes, ``y / (1 + exp(-2 sqrt(2 / pi) (y + 0.044715
    y^3)))``, which keeps the far negative tail that torch's float32 GELU
    rounds to 0."""
    y, a = y.double(), float(a)
    u = -2 * math.sqrt(2 / math.pi) * (y + 0.044715 * y ** 3)
    g = y / (1 + torch.exp(u))
    return torch.clamp(torch.round(g / a), -127, 127).to(torch.int8)


@pytest.mark.parametrize("n,h,w,ci,co,shift,scale,gain", [
    (4, 32, 32, 1152, 4608, 0.0, 1.0, 1.0),
    (1, 9, 7, 192, 200, 0.0, 1.0, 1.0),
    (2, 16, 16, 192, 256, -9.0, 1.0, 1.0),
    (2, 16, 16, 192, 256, 1e19, 1.0, 1.0),
    (2, 16, 16, 192, 256, 0.0, 1e-20, 1.0),
    (2, 16, 16, 192, 256, 0.0, 1.0, 1e21)], ids=str)
def test_conv_int8_gemm_gelu_form_at_its_edges(cuda, n, h, w, ci, co, shift,
                                               scale, gain):
    """The GEMM form's GELU epilogue against GELU's formula in float64 at
    the next site's scale: none more than one code apart, fewer than 1e-4
    of them apart at all, and so against the plain version (torch's GELU)
    at unshifted values; at DiT's fc1 (batch 4) and a ragged shape; with
    the pre-activations shifted to GELU's far negative tail (values under
    2^-60, which the fast division takes), past 2^60 (which it leaves to
    __fdiv_rn), at a scale under 2^-60 and, with the values scaled up, one
    over 2^60 (likewise).  One launch, counted in ``launches_gemm`` and
    ``launches_gelu``; the same bits twice; the conv form refuses it."""
    x, wp, s, b = _gemm_case(cuda, n, h, w, ci, co, ci + co)
    s, b = s / 30 * gain, b + shift
    y = conv2d_int8_plain(x, wp, s, b, relu=False, out_float=True)
    a = (torch.nn.functional.gelu(y.double(), approximate="tanh").abs()
         .amax() / 127.0 * scale).float().reshape(1)
    before = (conv2d_int8.launches_gemm, conv2d_int8.launches_gelu)
    got = conv2d_int8(x, wp, s, b, relu=False, gelu_scale=a)
    torch.cuda.synchronize()
    assert (conv2d_int8.launches_gemm, conv2d_int8.launches_gelu) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(conv2d_int8(x, wp, s, b, relu=False, gelu_scale=a),
                       got)
    wants = [_gelu_codes_direct(y, a)]
    if shift == 0.0 and scale == 1.0 and gain == 1.0:
        wants.append(conv2d_int8_plain(x, wp, s, b, relu=False, gelu_scale=a))
    for want in wants:
        diff = (got.int().cpu() - want.int().cpu()).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) < 1e-4
    with pytest.raises(ValueError, match="GEMM form"):
        conv2d_int8(x, wp, s, b, relu=False, gelu_scale=a, _form="tc")


@pytest.mark.parametrize("ci,co", DIT_LINEARS, ids=str)
def test_conv_int8_float_form_at_dit_linears(cuda, ci, co):
    """Kernel A's float epilogue at DiT's four linear shapes (batch 2 of
    32^2 tokens): the plain version's float32 bit for bit."""
    g = torch.Generator().manual_seed(ci + co)
    x = _codes(g, (2, 32, 32, ci), cuda)
    wp = pack_conv(_codes(g, (1, 1, ci, co), cuda))
    s = (torch.rand(co, generator=g) * 1e-4).to(cuda)
    b = torch.randn(co, generator=g).to(cuda)
    got = conv2d_int8(x, wp, s, b, relu=False, out_float=True)
    assert torch.equal(got, conv2d_int8_plain(x, wp, s, b, relu=False,
                                              out_float=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", [(32, 32, 32, 1152), (3, 5, 7, 64)],
                         ids=str)
def test_gated_residual_kernel_matches_plain(cuda, dtype, shape):
    """Kernel E's gated form at DiT's residual stream (batch 32 of 32^2
    tokens, 1152 channels) and a small ragged map, the gate a strided view
    of the adaLN rows: the plain version's bits, in place; one launch,
    counted in ``launches`` and ``launches_gate``, not in
    ``launches_residual``."""
    from mrisr_tpu_torch.ops.bias_residual import (
        gated_residual,
        gated_residual_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y = torch.randn(shape, generator=g, device=cuda)
    gate = torch.randn((shape[0], 6 * c), generator=g,
                       device=cuda)[:, 2 * c:3 * c]
    want = gated_residual_plain(x.clone(), gate, y)
    before = (bias_residual.launches, bias_residual.launches_residual,
              bias_residual.launches_gate)
    got = gated_residual(x, gate, y)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr() and torch.equal(x, want)
    assert (bias_residual.launches - before[0],
            bias_residual.launches_residual - before[1],
            bias_residual.launches_gate - before[2]) == (1, 0, 1)


def _dit_tables(cuda, steps, batch=2):
    """DiT-XL/8 at its published widths with the registry's seeded init,
    its int8_deep tables calibrated over a ``steps``-step trajectory of
    one seeded batch, and that schedule."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
    from mrisr_tpu_torch.models.dit import DiT
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    # torch's default init: the adaLN linears and the final layer are not
    # zeroed (DiT's adaLN-Zero would make every block the identity)
    params = fastddpm_flax_params(DiT().to(cuda))
    sched = DiffusionSchedule.create(1000, steps, "linear",
                                     "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((batch, 256, 256, 2), generator=g).to(cuda)
    q = quantize_fastddpm({"params": params},
                          calibrate_fastddpm({"params": params}, sched,
                                             [cond]),
                          only=deep_sites(params))
    return q, sched, cond


def _dit_counts():
    from mrisr_tpu_torch.models.adm_unet import qkv_attention
    from mrisr_tpu_torch.ops.layernorm import layernorm_modulate

    return (conv2d_int8.launches, conv2d_int8.launches_gelu,
            layernorm_modulate.launches, layernorm_modulate.launches_codes,
            quantize_int8.launches, bias_residual.launches_gate,
            bias_residual.launches, qkv_attention.calls_fused,
            qkv_attention.calls_float, conv2d_int8.launches_gemm)


def test_dit_int8_deep_call_on_card(cuda):
    """One int8_deep denoiser call of DiT-XL/8 (256^2, 1024 tokens, batch
    2) through kernels L, A, Q and E and torch's fused attention: A 112,
    all in the GEMM form (28 of them GELU), L 57 (56 emitting codes), Q 28, E 56 (all
    gated), the 28 attention cores on the fused path and none on the
    float one; both channels out, the same bits twice, and within 2 %
    (rel L2) of the same tables through the kernels' plain versions.
    Then the 10-step sampler call: ten times each."""
    from mrisr_tpu_torch.models.diffusion import sample_ancestral
    from mrisr_tpu_torch.serve.quant_diffusion import int8_forward

    q, sched, cond = _dit_tables(cuda, 10)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 256, 256, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    fwd = int8_forward(q, device=cuda)
    before = _dit_counts()
    got = fwd(x, t)
    torch.cuda.synchronize()
    one = tuple(a - b for a, b in zip(_dit_counts(), before))
    assert one == (112, 28, 57, 56, 28, 56, 56, 28, 0, 112), one
    from portbench.reference.counts_dit import kernel_sites

    sites = kernel_sites(2)  # the benchmark's counts: one call's launches
    assert (len(sites["kernel_a"]), len(sites["kernel_l"])) == (one[0],
                                                                one[2])
    assert torch.equal(fwd(x, t), got)
    want = int8_forward(q, device=cuda, plain=True)(x, t)
    assert got.shape == (2, 256, 256, 2) and bool(torch.isfinite(got).all())
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.02, rel
    before = _dit_counts()
    y = sample_ancestral(fwd, cond, None, sched)
    torch.cuda.synchronize()
    ten = tuple(a - b for a, b in zip(_dit_counts(), before))
    assert ten == tuple(10 * n for n in one), ten
    assert y.shape == (2, 256, 256, 1) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("net", ["notebook", "ddpm", "adm"])
def test_existing_networks_keep_their_bits_around_a_dit_call(cuda, net):
    """One int8_deep denoiser call of each earlier network at its
    published width (256^2, batch 2) gives the same bits before and after
    a DiT call has launched kernel A's GELU form, L and E's gated form in
    the same process, with the same launches of A, K3, Q and E, and
    none of the new forms."""
    from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
    from mrisr_tpu_torch.models.adm_unet import ADMUNet
    from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
    from mrisr_tpu_torch.models.diffusion import (
        DiffusionSchedule,
        FastDDPMUNet,
    )
    from mrisr_tpu_torch.serve.quant_diffusion import (
        calibrate_fastddpm,
        deep_sites,
        int8_forward,
        quantize_fastddpm,
    )

    torch.manual_seed(0)
    model = {"notebook": lambda: FastDDPMUNet(base_features=64),
             "ddpm": lambda: DDPMUNet(base_features=128),
             "adm": lambda: ADMUNet(base_features=256)}[net]()
    params = fastddpm_flax_params(model.to(cuda))
    del model
    sched = DiffusionSchedule.create(1000, 2, "linear", "nonuniform-4060")
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 256, 256, 2), generator=g).to(cuda)
    q = quantize_fastddpm({"params": params},
                          calibrate_fastddpm({"params": params}, sched,
                                             [cond]),
                          only=deep_sites(params))
    del params
    x = torch.randn((2, 256, 256, 3), generator=g).to(cuda)
    t = torch.full((2,), int(sched.timesteps[-1]), device=cuda)
    fwd = int8_forward(q, device=cuda)

    def launches():
        return (conv2d_int8.launches, groupnorm_silu.launches,
                quantize_int8.launches, bias_residual.launches)

    def call():
        before = launches(), _dit_counts()
        out = fwd(x, t)
        torch.cuda.synchronize()
        new = tuple(a - b for a, b in zip(_dit_counts(), before[1]))
        assert new[1] == new[2] == new[5] == 0  # GELU, L, gated
        return out, tuple(a - b for a, b in zip(launches(), before[0]))

    first, n_first = call()
    dq, _, _ = _dit_tables(cuda, 2)
    dit_fwd = int8_forward(dq, device=cuda)
    dit_fwd(x, t)
    torch.cuda.synchronize()
    del dit_fwd, dq
    again, n_again = call()
    assert torch.equal(again, first) and n_again == n_first
