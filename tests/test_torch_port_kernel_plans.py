"""The tilings of kernels K3 (GroupNorm+SiLU+int8) and K1 (fused SSIM), on
the CPU.

Both kernels take their tiling from a pure-Python plan
(``ops/groupnorm.py:plan``, ``ops/ssim_fused.py:plan``) computed with the
card's 132 SMs and 227 KB of shared memory a block.  K3's sites are read
from the full-width Fast-DDPM UNet itself (base 64, 256^2): every GroupNorm,
with its width from the module and its spatial size from its block's level;
the int8_deep sites are those that feed a quantized conv of ``DEEP_SITES``.
K1's shapes are the eval's and the GPU tests'.  ``chip_smoke.py`` keeps its
own K3 site list for the card; it must name the same shapes."""

import math

import pytest
from torch import nn

import chip_smoke
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.ops import groupnorm, ssim_fused
from mrisr_tpu_torch.serve.quant_diffusion import DEEP_SITES

SMS, SMEM = 132, 232_448  # H100 SXM: SMs, a block's shared memory (227 KB)
SSIM_BLOCKS = 2  # K1's blocks an SM at win 7 on the H100 (its registers)
HW = 256
# spatial size of each level of the FastDDPMUNet at 256^2
LEVEL = {"enc1": HW, "enc2": HW // 2, "enc3": HW // 4, "bottleneck": HW // 8,
         "dec3": HW // 4, "dec2": HW // 2, "dec1": HW, "final": HW}


def _gn_sites():
    """{site: (H, C, int8_deep)} of every GroupNorm of the full-width
    FastDDPMUNet: ``enc2/norm1`` ..., ``final_norm``."""
    sites = {}
    for name, m in FastDDPMUNet(base_features=64, time_dim=128
                                ).named_modules():
        if not isinstance(m, nn.GroupNorm):
            continue
        assert m.num_channels // m.num_groups == groupnorm.QUAD
        block, norm = name.split(".")
        site = "final_norm" if block == "final" else f"{block}/{norm}"
        conv = f"{block}/conv{norm[-1]}" if block != "final" else "final_conv"
        sites[site] = (LEVEL[block], m.num_channels, conv in DEEP_SITES)
    return sites


GN_SITES = _gn_sites()


def test_gn_site_counts():
    deep = [s for s, (_, _, d) in GN_SITES.items() if d]
    assert (len(GN_SITES), len(deep)) == (15, 10)
    assert sorted(c for h, c, d in GN_SITES.values() if not d) == [
        64, 64, 64, 128, 192]


def test_chip_smoke_gn_sites_are_the_models():
    """chip_smoke.py's K3 sites are the int8_deep part, site for site, and
    its float sites the rest."""
    deep = {s: (h, c) for s, (h, c, d) in GN_SITES.items() if d}
    assert {n: (h, c) for n, h, c in chip_smoke.diffusion_gn_sites()} == deep
    rest = {s: (h, c) for s, (h, c, d) in GN_SITES.items() if not d}
    assert {n: (h, c) for n, h, c in
            chip_smoke.diffusion_float_gn_sites()} == rest


def _chunks(p, n, hw):
    """``(pass, block, sample, p0, p1)`` of every block that works in each
    pass, as the kernel indexes them (csrc/groupnorm_silu.cu)."""
    for pas in range(p.passes):
        for block in range(p.grid):
            slot, j = divmod(block, p.bs)
            sample = pas * p.spp + slot
            if sample < n:
                yield pas, block, sample, j * p.px, min((j + 1) * p.px, hw)


def _check_gn_plan(n, hw, c, itemsize):
    p = groupnorm.plan(n, hw, c, itemsize, SMS, SMEM)
    assert p.grid <= SMS  # one block an SM, all co-resident
    assert p.smem <= SMEM
    assert p.px % 4 == 0 and p.bs == math.ceil(hw / p.px)
    assert p.passes * p.spp >= n > (p.passes - 1) * p.spp
    want = p.px * c * itemsize if p.one_read else 0
    assert p.smem == groupnorm._reserve(c) + want
    covered = {}
    pass_of = {}
    for pas, block, sample, p0, p1 in _chunks(p, n, hw):
        assert 0 <= p0 < p1 <= hw
        # a pass never splits a sample: all its blocks in one pass
        assert pass_of.setdefault(sample, pas) == pas
        for px in range(p0, p1):
            covered[(sample, px)] = covered.get((sample, px), 0) + 1
        # the apply's items: whole groups of 4 channels
        assert ((p1 - p0) * c) % 4 == 0
    # every pixel (all its channels) of every sample exactly once
    assert len(covered) == n * hw and set(covered.values()) == {1}
    return p


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("site", sorted(GN_SITES))
def test_gn_plan_at_full_width_site(site, batch):
    """bf16 in, as the int8_deep forward gives it; the one-read form at
    every int8_deep site."""
    h, c, deep = GN_SITES[site]
    p = _check_gn_plan(batch, h * h, c, 2)
    if deep:
        assert p.one_read


@pytest.mark.parametrize("n,hw,c,itemsize,one_read,spp", [
    (1, 512 * 512, 64, 2, False, 1),    # 33.5 MB: past the grid's 30.7 MB
    (2, 256 * 256, 192, 2, True, 1),    # 25.2 MB a sample: one a pass
    (8, 32 * 32, 512, 2, True, 8),      # the bottleneck: all in one pass
    (3, 11 * 13, 36, 2, True, 3),       # odd H*W
    (2, 9 * 7, 768, 4, True, 2),        # float32, odd H*W, 192 groups
    (3, 8 * 8, 20, 4, True, 3),         # 5 groups
    (1, 4, 8192, 2, True, 1),           # more groups than threads
    (4, 1, 8, 2, True, 4),              # one pixel
])
def test_gn_plan_forms(n, hw, c, itemsize, one_read, spp):
    p = _check_gn_plan(n, hw, c, itemsize)
    assert (p.one_read, p.spp) == (one_read, spp)


def test_gn_plan_balances_passes():
    """dec2/norm1 at batch 8: 12.6 MB a sample, two a pass, four passes."""
    p = groupnorm.plan(8, 128 * 128, 384, 2, SMS, SMEM)
    assert (p.spp, p.passes, p.one_read) == (2, 4, True)


SSIM_CASES = [(shape, win) for shape in sorted({
    *chip_smoke.SSIM_SHAPES, (168, 256, 256), (2, 64, 300), (3, 12, 256),
    (1, 9, 133), (4, 40, 70), (2, 30, 300)}) for win in (3, 7, 11)
    if min(shape[1:]) >= win]


@pytest.mark.parametrize("shape,win", SSIM_CASES, ids=str)
def test_ssim_plan_covers_the_map_once(shape, win):
    n, h, w = shape
    p = ssim_fused.plan(n, h, w, win, SMS, SSIM_BLOCKS)
    vh, vw = h - win + 1, w - win + 1
    assert p.smem <= SMEM
    assert p.band >= min(vh, ssim_fused.BAND_MIN)
    seen = [[0] * vw for _ in range(vh)]
    for s in range(p.strips):
        c0, c1 = s * ssim_fused.STRIP, min((s + 1) * ssim_fused.STRIP, vw)
        for b in range(p.bands):
            r0, r1 = b * p.band, min((b + 1) * p.band, vh)
            assert c0 < c1 and r0 < r1  # no empty tile
            for r in range(r0, r1):
                for c in range(c0, c1):
                    seen[r][c] += 1
    assert {v for row in seen for v in row} == {1}


@pytest.mark.parametrize("n,bands,band", [(174, 3, 84), (64, 8, 32),
                                          (1, 15, 17)])
def test_ssim_plan_fills_one_wave(n, bands, band):
    """The eval's N = 174 at 256^2: two strips by three bands of 84 rows,
    1,044 warps in 261 blocks, one wave of 2 blocks an SM on 132 SMs (four
    bands of 63 rows would take two waves); N = 64: eight bands of 32 rows,
    256 blocks; one image: the shortest bands."""
    p = ssim_fused.plan(n, 256, 256, 7, SMS, SSIM_BLOCKS)
    assert (p.strips, p.bands, p.band) == (2, bands, band)
    assert math.ceil(n * p.tiles / ssim_fused.WARPS) <= SMS * SSIM_BLOCKS
