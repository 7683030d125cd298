"""Which main loop kernels A and B run at each site (CPU).

``conv_path`` / ``upconv_path`` pick the tensor-core loop (wgmma fed by TMA)
or the __dp4a loop from the shape alone, and ``conv_form`` kernel A's
persistent GEMM form for the 1x1 sites that fill the card.  The sites are read from the
full-width models themselves: the pair UNet (features 64: 19 convs, 4
upconvs, all int8 in int8_fused serving) and the Fast-DDPM UNet (base 64:
the 14 convs and 2 upconvs of ``DEEP_SITES``, int8_deep serving).
``chip_smoke.py`` keeps its own site lists for the card; they must name the
same shapes."""

import re
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch import nn

import chip_smoke
from mrisr_tpu_torch.models import UNet
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.ops.conv_int8 import (
    GEMM_MAX_ROWS,
    conv2d_int8,
    conv_form,
    conv_path,
    pack_conv,
    reset_launches,
)
from portbench.core import reader
from portbench.reference import counts, counts_adm, counts_dit, counts_pmub
from mrisr_tpu_torch.ops.upconv import pack_upconv, upconv2x2_int8, upconv_path
from mrisr_tpu_torch.serve.quant_diffusion import DEEP_SITES


def _modules(model, keep=lambda name: True):
    """{name: (Ci, Co, k)} of the Conv2d and {name: (C, Co)} of the
    ConvTranspose2d modules of ``model`` whose name ``keep`` accepts."""
    convs, upconvs = {}, {}
    for name, m in model.named_modules():
        if not keep(name):
            continue
        if isinstance(m, nn.ConvTranspose2d):
            upconvs[name] = (m.in_channels, m.out_channels)
        elif isinstance(m, nn.Conv2d):
            convs[name] = (m.in_channels, m.out_channels, m.kernel_size[0])
    return convs, upconvs


UNET_CONVS, UNET_UPCONVS = _modules(UNet(features=64))
DIFF_CONVS, DIFF_UPCONVS = _modules(
    FastDDPMUNet(base_features=64, time_dim=128),
    lambda name: name.replace(".", "/") in DEEP_SITES)
# at full width only these leave the tensor cores: Ci = 2 and Co = 1
UNET_DP4A = {"enc1.conv.0", "final"}


def test_site_counts():
    assert (len(UNET_CONVS), len(UNET_UPCONVS)) == (19, 4)
    assert (len(DIFF_CONVS), len(DIFF_UPCONVS)) == (14, 2)


@pytest.mark.parametrize("name", sorted(UNET_CONVS))
def test_unet_conv_site_path(name):
    ci, co, k = UNET_CONVS[name]
    assert conv_path(ci, co, k) == ("dp4a" if name in UNET_DP4A else "tc")


@pytest.mark.parametrize("name", sorted(DIFF_CONVS))
def test_fastddpm_conv_site_path(name):
    assert conv_path(*DIFF_CONVS[name]) == "tc"


@pytest.mark.parametrize("name", sorted({**{f"unet {k}": v for k, v in
                                            UNET_UPCONVS.items()},
                                         **{f"fastddpm {k}": v for k, v in
                                            DIFF_UPCONVS.items()}}))
def test_upconv_site_path(name):
    table = UNET_UPCONVS if name.startswith("unet") else DIFF_UPCONVS
    assert upconv_path(*table[name.split()[1]]) == "tc"


@pytest.mark.parametrize("ci,co,k,path", [
    (16, 8, 3, "tc"), (48, 40, 3, "tc"), (64, 200, 1, "tc"),
    (2, 64, 3, "dp4a"), (8, 64, 3, "dp4a"), (24, 64, 3, "dp4a"),
    (64, 7, 3, "dp4a"), (64, 1, 1, "dp4a")])
def test_conv_path_by_shape(ci, co, k, path):
    """Ci a multiple of 16 (TMA's 16-byte strides) and Co >= 8 (wgmma's
    narrowest N) take the tensor cores; the rest the dp4a loop."""
    assert conv_path(ci, co, k) == path


@pytest.mark.parametrize("c,co,path", [(16, 6, "tc"), (32, 2, "tc"),
                                       (16, 1, "dp4a"), (8, 4, "dp4a"),
                                       (40, 16, "dp4a")])
def test_upconv_path_by_shape(c, co, path):
    assert upconv_path(c, co) == path


def test_conv_path_refuses_other_kernel_sizes():
    with pytest.raises(ValueError, match="kernel size"):
        conv_path(64, 64, 5)


def test_chip_smoke_sites_are_the_models():
    """The card's site lists name the models' shapes, site for site."""
    conv = sorted((ci, co, k) for _, _, ci, co, k, _ in
                  chip_smoke.conv_sites())
    assert conv == sorted(UNET_CONVS.values())
    up = sorted((c, co) for _, _, c, co in chip_smoke.upconv_sites())
    assert up == sorted(UNET_UPCONVS.values())
    dconv = sorted((ci, co, k) for _, _, ci, co, k in
                   chip_smoke.diffusion_conv_sites())
    assert dconv == sorted(DIFF_CONVS.values())
    dup = sorted((c, co) for _, _, c, co in
                 chip_smoke.diffusion_upconv_sites())
    assert dup == sorted(DIFF_UPCONVS.values())


def test_packed_weights_are_the_rows_the_tensor_maps_read():
    """The tensor-core loop reads weights as K-contiguous rows: (Co, k, k,
    Ci) for A, (4 Co, C) behind pack_upconv's transposed view for B."""
    w = torch.randint(-127, 128, (3, 3, 48, 40), dtype=torch.int8)
    wp = pack_conv(w)
    assert wp.shape == (40, 3, 3, 48) and wp.is_contiguous()
    assert torch.equal(wp[7, 1, 2], w[1, 2, :, 7])
    w2, _, _ = pack_upconv(torch.randint(-127, 128, (2, 2, 32, 6),
                                         dtype=torch.int8),
                           torch.ones(6), torch.zeros(6))
    assert w2.shape == (32, 24) and w2.t().is_contiguous()


def test_cpu_calls_count_no_launch():
    """On a CPU tensor the wrappers run their plain versions: no path's
    count moves."""
    reset_launches(conv2d_int8, upconv2x2_int8)
    x = torch.randint(-127, 128, (1, 4, 4, 16), dtype=torch.int8)
    wp = pack_conv(torch.randint(-127, 128, (3, 3, 16, 8), dtype=torch.int8))
    conv2d_int8(x, wp, torch.ones(8) * 1e-3, torch.zeros(8))
    w2, s4, b4 = pack_upconv(torch.randint(-127, 128, (2, 2, 16, 4),
                                           dtype=torch.int8),
                             torch.ones(4) * 1e-3, torch.zeros(4))
    upconv2x2_int8(x, w2, s4, b4)
    for fn in (conv2d_int8, upconv2x2_int8):
        assert (fn.launches, fn.launches_tc, fn.launches_dp4a) == (0, 0, 0)
    assert (conv2d_int8.launches_gemm, conv2d_int8.launches_gelu) == (0, 0)


def _benchmark_1x1_sites(batch=32):
    """{"<config> <site>": (M, Ci, Co)} of every 1x1 kernel-A site of the
    benchmark's five configurations at ``batch``, as
    ``portbench/reference/counts*.py`` count them (each conv_site call)."""
    calls = []

    def capture(mod):
        real = mod.conv_site

        def conv_site(name, n, h, ci, co, k, out_bytes):
            calls.append((name, n * h * h, ci, co, k))
            return real(name, n, h, ci, co, k, out_bytes)
        return mock.patch.object(mod, "conv_site", conv_site)

    sites = {}
    for config, mod, fn in (
            ("unet_m2", counts, counts.unet_kernel_sites),
            ("fastddpm", counts, counts.fastddpm_kernel_sites),
            ("fastddpm_pmub", counts_pmub, counts_pmub.kernel_sites),
            ("fastddpm_adm", counts_adm, counts_adm.kernel_sites),
            ("fastddpm_dit", counts_dit, counts_dit.kernel_sites)):
        calls.clear()
        with capture(mod):
            fn(batch)
        for name, m, ci, co, k in calls:
            if k == 1:
                sites[f"{config} {name}"] = (m, ci, co)
    return sites


A_1X1 = _benchmark_1x1_sites()


def test_benchmark_1x1_site_counts():
    """DiT's 112 block linears, ADM's 17 skips and 16 attention pairs,
    PMUB's 17 shortcuts and 6 attention blocks' four projections, the
    notebook net's 4 skips and the UNet's head."""
    by = {}
    for key in A_1X1:
        by[key.split()[0]] = by.get(key.split()[0], 0) + 1
    assert by == {"fastddpm_dit": 112, "fastddpm_adm": 49,
                  "fastddpm_pmub": 41, "fastddpm": 4, "unet_m2": 1}


@pytest.mark.parametrize("site", sorted(A_1X1))
def test_benchmark_1x1_site_form(site):
    """The form kernel A takes at each 1x1 site of the benchmark's cells
    (batch 32): every tensor-core site the GEMM form, DiT's 112 block
    linears among them, the UNet's head (Co = 1) the dp4a loop."""
    m, ci, co = A_1X1[site]
    want = "dp4a" if site == "unet_m2 final" else "gemm"
    assert conv_form(m, ci, co, 1) == want


@pytest.mark.parametrize("m,ci,co,k,form", [
    (32768, 1152, 4608, 1, "gemm"), (2048, 1152, 1152, 1, "gemm"),
    (63, 192, 200, 1, "gemm"), (GEMM_MAX_ROWS - 1, 64, 64, 1, "gemm"),
    (GEMM_MAX_ROWS, 64, 64, 1, "tc"), (2048, 1024, 1024, 3, "tc"),
    (524288, 64, 64, 3, "tc"), (32768, 8, 64, 1, "dp4a"),
    (65536, 64, 1, 1, "dp4a")])
def test_conv_form_by_shape(m, ci, co, k, form):
    """The GEMM form at every 1x1 site on the tensor-core path whose rows
    it can index; every 3x3 site keeps the conv form, and the dp4a sites
    their loop."""
    assert conv_form(m, ci, co, k) == form


def test_every_kernel_a_symbol_matches_the_roofline_pattern():
    """Every __global__ kernel of csrc/conv_int8.cu is one that the
    benchmark's kernel_a_roofline counts as kernel A (its PATTERN, matched
    against the demangled name a profiler shows)."""
    src = (Path(__file__).resolve().parent.parent / "mrisr_tpu_torch" /
           "csrc" / "conv_int8.cu").read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        src)
    assert {"conv_int8_tc_kernel_gemm", "conv_int8_tc_kernel_gemm_gelu",
            "conv_int8_tc_kernel", "conv1x1_to1_kernel"} <= set(names)
    pattern = reader("kernel_a_roofline").PATTERN
    for name in names:
        assert re.search(pattern, f"void {name}<128, true>(CUtensorMap)"), \
            name
