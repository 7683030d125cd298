"""Kernel E, a float conv's bias and a residual block's closing add in one
pass (``ops/bias_residual.py``), on the CPU: its plain version against the
sequence torch runs after a cuDNN conv, bit for bit; what the wrapper
refuses; and the Fast-DDPM forward's E sites.

On the card cuDNN runs a conv without its bias and torch adds the bias in
a pass of its own (``output.add_(bias.reshape(1, C, 1, 1))``, rounded to
the conv's type); the CPU's conv folds the bias into its sum, one rounding.
So the CPU tests hold E to the card's sequence through :func:`card_conv`,
which runs the CPU conv without its bias and then torch's add, and the card
tests (``test_torch_port_cuda.py``) hold it to cuDNN's ``F.conv2d(x, w,
b)`` itself."""

import pytest
import torch
import torch.nn.functional as F

from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.models.adm_unet import ADMUNet
from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.ops.bias_residual import (
    MAX_C,
    bias_residual,
    bias_residual_plain,
)
from mrisr_tpu_torch.serve.quant_diffusion import (
    FastDDPMForward,
    _layers,
    deep_sites,
    int8_forward,
    quantize_fastddpm,
)
from torch_port_quant_cases import bias_sites

BATCH = 2
# network -> the input's H = W (all six levels of the DDPM UNet and ADM)
NETS = {"notebook": 16, "ddpm": 32, "adm": 32}
_CONV2D, _CONVT = F.conv2d, F.conv_transpose2d


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def card_conv(x, w, b=None, **kw):
    """``F.conv2d`` as torch runs it on cuDNN: the conv without its bias,
    then the bias added in place in the conv's type."""
    y = _CONV2D(x, w, None, **kw)
    return y if b is None else y.add_(b.reshape(1, -1, 1, 1))


def card_convt(x, w, b=None, **kw):
    """``F.conv_transpose2d`` as torch runs it on cuDNN (:func:`card_conv`)."""
    y = _CONVT(x, w, None, **kw)
    return y if b is None else y.add_(b.reshape(1, -1, 1, 1))


def _bits(t):
    """Bit patterns (NaN equal to itself)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _conv_case(c, seed):
    """A 3x3 conv input (channels_last NCHW, bf16), its weight and bias,
    a block input ``x`` and a 1x1 shortcut's weight and bias, at C
    channels out."""
    g = torch.Generator().manual_seed(seed)

    def bf(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(torch.bfloat16)

    h = bf(BATCH, 16, 12, 12).contiguous(memory_format=torch.channels_last)
    w = bf(c, 16, 3, 3, scale=0.1).contiguous(
        memory_format=torch.channels_last)
    x = bf(BATCH, 24, 12, 12).contiguous(memory_format=torch.channels_last)
    ws = bf(c, 24, 1, 1, scale=0.2).contiguous(
        memory_format=torch.channels_last)
    return h, w, bf(c, scale=0.5), x, ws, bf(c, scale=0.5)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("mode", ["bias", "residual", "shortcut"])
@pytest.mark.parametrize("c", [8, 64, 128, 256])
def test_plain_is_the_card_sequence_bit_for_bit(c, mode):
    """bf16 at C 8 to 256: ``bias_residual_plain`` of a bias-less conv's
    output (and of the block input, or of a 1x1 shortcut conv's bias-less
    output and that conv's bias) is the card's ``F.conv2d(h, w, b)``
    (``+ x``, ``+ F.conv2d(x, ws, bs)``) bit for bit; the wrapper on the
    CPU is the plain version, in place; one rounding fewer is another
    answer."""
    h, w, b, x, ws, bs = _conv_case(c, c)
    want = card_conv(h, w, b, padding=1)
    r = rb = None
    if mode == "residual":  # a block input of C channels
        x = card_conv(x, ws, None)
        want = want + x
        r = _nhwc(x)
    elif mode == "shortcut":
        want = want + card_conv(x, ws, bs)
        r, rb = _nhwc(card_conv(x, ws, None)), bs
    y = _nhwc(card_conv(h, w, None, padding=1))
    assert y.is_contiguous()
    r_before = None if r is None else r.clone()
    got = bias_residual_plain(y, b, r, rb)
    assert got is y and torch.equal(_bits(got), _bits(_nhwc(want)))
    if r is not None:
        assert torch.equal(_bits(r), _bits(r_before))
        once = (_nhwc(card_conv(h, w, None, padding=1)).float() + b.float()
                + (r.float() if rb is None else r.float() + rb.float())
                ).to(torch.bfloat16)
        assert not torch.equal(once, got)
    y2 = _nhwc(card_conv(h, w, None, padding=1))
    before = (bias_residual.launches, bias_residual.launches_residual)
    assert bias_residual(y2, b, r, rb) is y2
    assert torch.equal(_bits(y2), _bits(got))
    assert (bias_residual.launches, bias_residual.launches_residual) == before


def test_plain_float32_is_torchs_float_adds():
    """float32: the same sequence of float adds, an upconv's output too
    (``F.conv_transpose2d``, as the notebook net's upconv1)."""
    g = torch.Generator().manual_seed(5)
    xt = torch.randn((BATCH, 16, 6, 6), generator=g)
    wt = torch.randn((16, 32, 2, 2), generator=g)
    b, r, rb = (torch.randn(32, generator=g),
                torch.randn((BATCH, 12, 12, 32), generator=g),
                torch.randn(32, generator=g))
    want = _nhwc(card_convt(xt, wt, b, stride=2)) + (r + rb)
    y = _nhwc(card_convt(xt, wt, None, stride=2)).contiguous()
    assert torch.equal(bias_residual_plain(y, b, r, rb), want)


def _case(**over):
    """A valid (y, b, r, rb) on the CPU at C 16, with ``over`` replacing
    one argument."""
    y = torch.zeros((2, 4, 4, 16), dtype=torch.bfloat16)
    row = torch.zeros(16, dtype=torch.bfloat16)
    args = dict(y=y, b=row, r=torch.zeros_like(y), rb=row.clone())
    args.update(over)
    return args


REFUSED = {
    "y float16": _case(y=torch.zeros((2, 4, 4, 16), dtype=torch.float16)),
    "y int8": _case(y=torch.zeros((2, 4, 4, 16), dtype=torch.int8)),
    "b float32": _case(b=torch.zeros(16)),
    "r float32": _case(r=torch.zeros((2, 4, 4, 16))),
    "rb float32": _case(rb=torch.zeros(16)),
    "y not contiguous": _case(
        y=torch.zeros((2, 16, 4, 4), dtype=torch.bfloat16).permute(0, 2, 3, 1)
        [:, :, :2], r=torch.zeros((2, 4, 2, 16), dtype=torch.bfloat16)),
    "r not contiguous": _case(
        r=torch.zeros((2, 16, 4, 4), dtype=torch.bfloat16).permute(0, 2, 3, 1)
        .transpose(1, 2)),
    "b not contiguous": _case(b=torch.zeros(32, dtype=torch.bfloat16)[::2]),
    "C 12": _case(y=torch.zeros((2, 4, 4, 12), dtype=torch.bfloat16),
                  b=torch.zeros(12, dtype=torch.bfloat16), r=None, rb=None),
    "C 4": _case(y=torch.zeros((2, 4, 4, 4), dtype=torch.bfloat16),
                 b=torch.zeros(4, dtype=torch.bfloat16), r=None, rb=None),
    f"C {MAX_C + 8}": _case(
        y=torch.zeros((1, 1, 1, MAX_C + 8), dtype=torch.bfloat16),
        b=torch.zeros(MAX_C + 8, dtype=torch.bfloat16), r=None, rb=None),
    "b (C, 1)": _case(b=torch.zeros((16, 1), dtype=torch.bfloat16)),
    "b (8,)": _case(b=torch.zeros(8, dtype=torch.bfloat16)),
    "r another shape": _case(r=torch.zeros((2, 4, 8, 16),
                                           dtype=torch.bfloat16)),
    "rb another shape": _case(rb=torch.zeros(32, dtype=torch.bfloat16)),
    "rb without r": _case(r=None),
    "y 0-dim": _case(y=torch.zeros((), dtype=torch.bfloat16), r=None,
                     rb=None),
    "b on another device": _case(b=torch.zeros(16, dtype=torch.bfloat16,
                                               device="meta")),
    "r on another device": _case(r=torch.zeros((2, 4, 4, 16),
                                               dtype=torch.bfloat16,
                                               device="meta")),
    "y on meta": dict(
        y=torch.zeros((2, 4, 4, 16), dtype=torch.bfloat16, device="meta"),
        b=torch.zeros(16, dtype=torch.bfloat16, device="meta")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses(case):
    """A wrong dtype, layout, channel count, shape or device is refused
    before anything runs, as the quantizer's wrapper refuses."""
    with pytest.raises(ValueError, match="bias_residual"):
        bias_residual(**REFUSED[case])


@pytest.fixture(scope="module")
def trees():
    """Seeded flax-layout trees at small widths: the notebook FastDDPMUNet
    at base 8, the DDPM UNet and ADM's UNet at ch 32 (32 GroupNorm
    groups)."""
    with torch.random.fork_rng():
        torch.manual_seed(20)
        nets = {"notebook": FastDDPMUNet(base_features=8, time_dim=16),
                "ddpm": DDPMUNet(base_features=32),
                "adm": ADMUNet(base_features=32)}
    return {k: fastddpm_flax_params(m) for k, m in nets.items()}


def _int8_deep(params):
    """int8_deep tables from a static calibration (every conv input's
    absmax 4): what the routing needs, without a sampler run."""
    calib = {name: 4.0 for name, p in _layers(params)
             if "kernel" in p and p["kernel"].dim() == 4}
    return quantize_fastddpm({"params": params}, calib,
                             only=deep_sites(params))


def _inputs(hw):
    g = torch.Generator().manual_seed(hw)
    return torch.randn((BATCH, hw, hw, 3), generator=g), torch.tensor(
        [999, 400])


def _recording(fwd, calls):
    """``fwd`` with E's routing on (as on the card) and E replaced by its
    plain version recording (conv, shortcut conv or None, residual)."""
    names = {id(layer[1]): name for name, layer in
             list(fwd.convs.items()) + list(fwd.upconvs.items())}
    inner = fwd._bias

    def e(y, b, r=None, rb=None):
        calls.append((names[id(b)], None if rb is None else names[id(rb)],
                      r is not None))
        return inner(y, b, r, rb)

    fwd._e, fwd._bias = True, e
    return fwd


@pytest.mark.parametrize("net", sorted(NETS))
def test_e_sites_of_an_int8_deep_call(trees, net):
    """Where E's routing is on ('fused' on the card), one int8_deep call
    calls E at exactly ``bias_sites(net)``: 4, 12 and 13 calls, 2, 5 and 6
    of them with a residual; on the CPU the routing is off for both
    gn_impls (the CPU's conv folds its bias)."""
    q = _int8_deep(trees[net])
    for gn_impl in ("chain", "fused"):
        assert not int8_forward(q, device="cpu", gn_impl=gn_impl)._e
    calls = []
    fwd = _recording(int8_forward(q, device="cpu", gn_impl="fused",
                                  plain=True), calls)
    y = fwd(*_inputs(NETS[net]))
    assert bool(torch.isfinite(y).all())
    assert calls == bias_sites(net)
    want = {"notebook": (4, 2), "ddpm": (12, 5), "adm": (13, 6)}[net]
    assert (len(calls), sum(r for _, _, r in calls)) == want


@pytest.mark.parametrize("tables", ["int8_deep", "float"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_e_routing_keeps_the_card_sequence_bits(trees, net, tables,
                                                monkeypatch):
    """With the convs run as cuDNN runs them (:func:`card_conv`), the
    'fused' forward with E's routing on (its plain version) gives the
    routing-off forward's output bit for bit, int8_deep and float: E
    takes each bias, the shortcut's and the residual add in torch's own
    order of roundings."""
    monkeypatch.setattr(F, "conv2d", card_conv)
    monkeypatch.setattr(F, "conv_transpose2d", card_convt)
    x, t = _inputs(NETS[net])
    make = ((lambda: int8_forward(_int8_deep(trees[net]), device="cpu",
                                  gn_impl="fused", plain=True))
            if tables == "int8_deep" else
            (lambda: FastDDPMForward(trees[net], dtype=torch.bfloat16,
                                     gn_impl="fused", device="cpu",
                                     plain=True)))
    want = make()(x, t)
    calls = []
    got = _recording(make(), calls)(x, t)
    assert calls and torch.equal(got, want)
