"""Which main loop kernels A and B run at each site (CPU).

``conv_path`` / ``upconv_path`` pick the tensor-core loop (wgmma fed by TMA)
or the __dp4a loop from the shape alone.  The sites are read from the
full-width models themselves: the pair UNet (features 64: 19 convs, 4
upconvs, all int8 in int8_fused serving) and the Fast-DDPM UNet (base 64:
the 14 convs and 2 upconvs of ``DEEP_SITES``, int8_deep serving).
``chip_smoke.py`` keeps its own site lists for the card; they must name the
same shapes."""

import pytest
import torch
from torch import nn

import chip_smoke
from mrisr_tpu_torch.models import UNet
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv_path,
    pack_conv,
    reset_launches,
)
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
