"""A residual block's time projection in the Fast-DDPM forward
(``serve/quant_diffusion.py:FastDDPMForward._block``), on the CPU: 'fused'
hands it to norm2's K3 as the input shift (kernels' plain versions here),
at exactly the norm2 sites of both networks, and leaves no broadcast add
of it; 'chain' adds it in ``dtype`` as the forward always did, bit for
bit."""

import types

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
from mrisr_tpu_torch.models.diffusion import FastDDPMUNet
from mrisr_tpu_torch.serve.quant_diffusion import FastDDPMForward

BATCH = 2
# network -> (its ResBlocks, the input's H = W)
NETS = {"notebook": (7, 16), "ddpm": (32, 64)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """Seeded flax-layout trees: the notebook FastDDPMUNet at base 8 and
    the DDPM UNet at ch 32 (its 32 GroupNorm groups need 32 channels)."""
    with torch.random.fork_rng():
        torch.manual_seed(20)
        notebook = FastDDPMUNet(base_features=8, time_dim=16)
        ddpm = DDPMUNet(base_features=32)
    return {"notebook": fastddpm_flax_params(notebook),
            "ddpm": fastddpm_flax_params(ddpm)}


def _inputs(hw):
    g = torch.Generator().manual_seed(hw)
    x = torch.randn((BATCH, hw, hw, 3), generator=g)
    return x, torch.tensor([999, 400])


def _forward(trees, net, gn_impl):
    return FastDDPMForward(trees[net], dtype=torch.bfloat16, gn_impl=gn_impl,
                           device="cpu", plain=True)


class _BroadcastAdds(TorchDispatchMode):
    """Counts the ``(B, H, W, C) + (B, 1, 1, C)`` adds (H * W > 1) outside
    K3 (whose plain version adds its shift so on the CPU)."""

    def __init__(self):
        super().__init__()
        self.count, self.in_k3 = 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.add.Tensor and not self.in_k3:
            shapes = sorted((tuple(a.shape) for a in args[:2]
                             if isinstance(a, torch.Tensor)),
                            key=lambda s: s[1:3] if len(s) == 4 else ())
            if (len(shapes) == 2 and all(len(s) == 4 for s in shapes)
                    and shapes[0][1:3] == (1, 1)
                    and shapes[1][1] * shapes[1][2] > 1
                    and shapes[0][3] == shapes[1][3]):
                self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("net", sorted(NETS))
def test_fused_passes_the_projection_to_norm2_only(trees, net):
    """'fused': K3 (``_gn8``) takes a ``(B, C)`` float shift at each
    ResBlock's norm2 and nowhere else: 7 a call on the notebook net, 32 on
    the DDPM UNet."""
    blocks, hw = NETS[net]
    fwd = _forward(trees, net, "fused")
    gn8, act = fwd._gn8, fwd._act
    shifted, norms = [], []

    def k3(h, gamma, beta, **kw):
        if kw.get("shift") is not None:
            shifted.append((tuple(h.shape), tuple(kw["shift"].shape)))
        return gn8(h, gamma, beta, **kw)

    def record(st, site, norm, h, **kw):
        if kw.get("shift") is not None:
            norms.append(norm)
        return act(st, site, norm, h, **kw)

    fwd._gn8, fwd._act = k3, record
    y = fwd(*_inputs(hw))
    assert y.shape == (BATCH, hw, hw, 1) and bool(torch.isfinite(y).all())
    assert len(shifted) == blocks
    assert all(s == (h[0], h[3]) for h, s in shifted)
    every_norm2 = sorted(n for n in fwd.norms if n.endswith("/norm2"))
    assert sorted(norms) == every_norm2 and len(every_norm2) == blocks


@pytest.mark.parametrize("net", sorted(NETS))
def test_no_broadcast_add_on_the_fused_path(trees, net):
    """The ``(B, H, W, C) + (B, 1, 1, C)`` add of the time projection
    outside K3: once a ResBlock with 'chain', never with 'fused'."""
    blocks, hw = NETS[net]
    x, t = _inputs(hw)
    for gn_impl, want in (("chain", blocks), ("fused", 0)):
        fwd = _forward(trees, net, gn_impl)
        adds, gn8 = _BroadcastAdds(), fwd._gn8

        def k3(*args, **kw):
            adds.in_k3 = True
            try:
                return gn8(*args, **kw)
            finally:
                adds.in_k3 = False

        fwd._gn8 = k3
        with adds:
            fwd(x, t)
        assert adds.count == want, gn_impl


def _parent_block(self, st, name, x):
    """``FastDDPMForward._block`` as it was before the shift: the
    projection added to conv1's output in ``dtype``, then norm2 (the
    leaf names from the tree's ``Network``)."""
    temb, skip = self.net.temb, self.net.skip
    h = self._act(st, f"{name}/conv1", f"{name}/norm1", x)
    h = self._conv(st, f"{name}/conv1", h)
    w, b = self.dense[f"{name}/{temb}"]
    h = h + F.linear(st.t_emb, w, b)[:, None, None, :]
    h = self._act(st, f"{name}/conv2", f"{name}/norm2", h)
    h = self._conv(st, f"{name}/conv2", h)
    if f"{name}/{skip}" in self.q or f"{name}/{skip}" in self.convs:
        x = self._conv(st, f"{name}/{skip}", x)
    return h + x


@pytest.mark.parametrize("net", sorted(NETS))
def test_chain_is_the_broadcast_add_bit_for_bit(trees, net):
    """'chain' gives the forward's output as it was, bit for bit; 'fused'
    (one bf16 rounding fewer at every norm2) is another answer, near it."""
    _, hw = NETS[net]
    x, t = _inputs(hw)
    parent = _forward(trees, net, "chain")
    parent._block = types.MethodType(_parent_block, parent)
    want = parent(x, t)
    assert torch.equal(_forward(trees, net, "chain")(x, t), want)
    fused = _forward(trees, net, "fused")(x, t)
    assert not torch.equal(fused, want)
    assert float((fused - want).norm() / want.norm()) < 0.05


@pytest.mark.parametrize("net", sorted(NETS))
def test_fused_float_conv1_bias_rides_the_shift(trees, net):
    """'fused' at a float conv1 (every one in the float forward): cuDNN
    runs it without its bias, and norm2 reads that output plus a float32
    shift of the time projection and the bias: conv1 + bias + projection
    in float64, within the bf16 rounding of conv1's output."""
    blocks, hw = NETS[net]
    x, t = _inputs(hw)
    fwd = _forward(trees, net, "fused")
    conv, act = fwd._conv, fwd._act
    inputs, sums = {}, {}

    def record_conv(st, name, h, **kw):
        if name.endswith("/conv1"):
            inputs[name.rpartition("/")[0]] = h
        return conv(st, name, h, **kw)

    def record_act(st, site, norm, h, **kw):
        if kw.get("shift") is not None:
            sums[norm.rpartition("/")[0]] = (h, kw["shift"])
        return act(st, site, norm, h, **kw)

    fwd._conv, fwd._act = record_conv, record_act
    fwd(x, t)
    t_emb = fwd.time_embedding(t)
    temb = "temb_proj" if net == "ddpm" else "time_fc"
    assert len(sums) == blocks
    for block, (h, shift) in sums.items():
        w, b, pad = fwd.convs[f"{block}/conv1"]
        assert shift.dtype == torch.float32
        want = F.conv2d(inputs[block].double().permute(0, 3, 1, 2),
                        w.double(), b.double(), padding=pad)
        want = want.permute(0, 2, 3, 1) + F.linear(
            t_emb, *fwd.dense[f"{block}/{temb}"]).double()[:, None, None, :]
        err = h.double() + shift.double()[:, None, None, :] - want
        # conv1's output rounded to bf16 (the CPU's bf16 conv: about 2^-9
        # of its largest value); a bias left out or added twice moves a
        # channel's mean by that bias, which reaches 0.02 in every block
        assert float(err.abs().max()) <= float(
            (want - b.double()).abs().max()) * 2.0 ** -8, block
        assert float(err.mean(dim=(0, 1, 2)).abs().max()) < 1e-3, block
        assert float(b.abs().max()) > 0.02, block
