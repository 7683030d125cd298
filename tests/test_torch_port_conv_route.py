"""The conv route of ``mrisr_tpu_torch/models/conv.py`` (CPU): the conv
with cuDNN off gives ``F.conv2d``'s values and gradients, the route is
never taken on the CPU, and among every conv of the six families' train
steps and eval forwards the routes name exactly the convs they were
measured on."""

import pytest
import torch
import torch.nn.functional as F

from mrisr_tpu_torch.models import conv as conv_module
from mrisr_tpu_torch.models.conv import (
    Conv2d,
    avoids_cudnn,
    conv2d_no_cudnn,
    route,
)
from mrisr_tpu_torch.models.registry import create_model
from mrisr_tpu_torch.config import PRESETS

torch.set_num_threads(2)


@pytest.mark.parametrize("stride,padding,bias", [
    (1, 1, True), (2, 1, False), (1, 0, True)])
def test_conv_without_cudnn_matches_conv2d(stride, padding, bias):
    g = torch.Generator().manual_seed(stride + padding)
    x = torch.randn(2, 5, 9, 11, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(7, 5, 3, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = (torch.randn(7, generator=g, dtype=torch.float64,
                     requires_grad=True) if bias else None)
    args = ((stride, stride), (padding, padding), (1, 1))
    got = conv2d_no_cudnn(x, w, b, *args)
    want = F.conv2d(x, w, b, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    inputs = (x, w) + ((b,) if bias else ())
    gy = torch.randn(got.shape, generator=g, dtype=torch.float64)
    for a, e in zip(torch.autograd.grad(got, inputs, gy),
                    torch.autograd.grad(want, inputs, gy)):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda x, w, *b: conv2d_no_cudnn(x, w, b[0] if b else None, *args),
        inputs)


def test_route_is_never_taken_on_the_cpu():
    conv = Conv2d(256, 128, 3, padding=1)
    for hw in (128, 32):
        x = torch.zeros(4, 256, hw, hw, requires_grad=True)
        assert route(x.shape, conv, True) is not None
        assert not avoids_cudnn(x, conv)
    assert (4, 256, 128, 128, 128) in conv_module.CUDNN_FFT_SHAPES


def routes(name: str, batch: int, recorded: bool):
    """{conv name: route} of registry model ``name`` (full width, 256^2)
    for the calls :func:`route` sends around cuDNN, found on the meta
    device (nothing is computed)."""
    cfg = PRESETS[name].model if name in PRESETS else PRESETS[
        "unet_gan"].model
    module = create_model(name, cfg).to("meta")
    names = {m: k for k, m in module.named_modules()}
    hits = {}

    def hook(mod, args):
        r = route(args[0].shape, mod, recorded)
        if r is not None:
            hits[names[mod]] = (r, args[0].shape[-1])

    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            assert isinstance(m, Conv2d), names[m]
            m.register_forward_pre_hook(hook)
    c = {"progressive_unet": 5, "patchgan": 3}.get(name, 2)
    x = torch.empty(batch, 256, 256, 3 if "fastddpm" in name else c,
                    device="meta")
    with torch.no_grad():
        if "fastddpm" in name:
            module(x, torch.zeros(batch, dtype=torch.int32, device="meta"))
        else:
            module(x)
    return hits


UNET_SMALL = ["enc3.conv.0", "enc3.conv.3", "enc4.conv.0", "enc4.conv.3",
              "bottleneck.conv.0", "bottleneck.conv.3", "dec4.conv.0",
              "dec4.conv.3", "dec3.conv.0", "dec3.conv.3"]


@pytest.mark.parametrize("name,batch,fft,small", [
    ("unet", 4, ["dec2.conv.0"], UNET_SMALL),
    ("unet", 8, [], []),
    ("unet_gan", 4, ["dec2.conv.0"], UNET_SMALL),
    ("patchgan", 4, [], ["model.5", "model.8", "model.11"]),
    ("deepcnn", 4, [], []), ("deepcnn", 8, [], []),
    ("progressive_unet", 4, [f"unet{i}.dec2.conv.0" for i in (1, 2, 3)],
     [f"unet{i}.{k}" for i in (1, 2, 3) for k in UNET_SMALL]),
    ("fastddpm", 4, [], ["enc3.conv1", "enc3.conv2", "enc3.skip",
                         "bottleneck.conv1", "bottleneck.conv2",
                         "dec3.conv1", "dec3.conv2", "dec3.skip"]),
    ("fastddpm", 8, [], []),
    ("fastddpm_simple", 4, [], ["down2.block.0", "down2.block.2"])])
def test_routes_are_the_measured_ones(name, batch, fft, small):
    """'fft' names dec2.conv.0 of every full-width UNet at batch 4, in a
    train step or not; 'small map' every conv on a map of 64^2 or less
    that a train step at batch <= 4 records, and nothing in an eval
    forward."""
    got = routes(name, batch, recorded=True)
    assert sorted(k for k, (r, _) in got.items() if r == "fft") == sorted(fft)
    assert sorted(k for k, (r, _) in got.items() if r == "small map") == (
        sorted(small))
    assert all(side <= 64 for r, side in got.values() if r == "small map")
    assert {k for k, (r, _) in routes(name, batch, recorded=False).items()
            } == set(fft)
