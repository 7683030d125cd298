"""The int8 activation quantizer (``ops/quantize.py``) on the CPU: its plain
version against the torch expression it took over and the JAX package's
``_quant_input`` (``mrisr_tpu/serve/quant.py``), bit for bit, at ties, their
neighbours, the saturation edges and +-inf; what the wrapper refuses; and
the Fast-DDPM forward's quantizer sites, 6 a notebook-net call and 27 a
DDPM-UNet call, shape for shape as ``torch_port_quant_cases`` lists them,
each inside a ``ddpm.quant`` span."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mrisr_tpu.serve import quant as jq
from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet
from mrisr_tpu_torch.models.diffusion import DiffusionSchedule, FastDDPMUNet
from mrisr_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain
from mrisr_tpu_torch.serve.quant_diffusion import (
    calibrate_fastddpm,
    deep_sites,
    int8_forward,
    quantize_fastddpm,
)
from mrisr_tpu_torch.utils.profiling import RECORDER
from torch_port_quant_cases import quant_edge_values, quant_sites

FEAT, BATCH = 4, 2
# network -> (width: the notebook net's base, the DDPM UNet's ch, whose 32
# GroupNorm groups need 32 channels; the input's H = W)
NETS = {"notebook": (FEAT, 32), "ddpm": (32, 64)}
SCALES = (0.1, 0.25, 0.0371)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scale(a, kind):
    """``a`` as a 0-dim tensor, a (1,) tensor, or a row of a per-step
    table taken by ``index_select`` (what the Fast-DDPM forward passes)."""
    if kind == "0-dim":
        return torch.tensor(a, dtype=torch.float32)
    if kind == "(1,)":
        return torch.tensor([a], dtype=torch.float32)
    table = torch.tensor([0.5, a, 2.0], dtype=torch.float32)
    return table.index_select(0, torch.tensor([1]))


@pytest.mark.parametrize("kind", ["0-dim", "(1,)", "step row"])
@pytest.mark.parametrize("a", SCALES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plain_equals_the_torch_expression_and_jax(dtype, a, kind):
    """The plain version, and the wrapper on the CPU, give the torch
    expression's codes and the JAX package's, bit for bit, from bf16 and
    float32, at a scalar, a (1,) scale and a per-step row."""
    g = torch.Generator().manual_seed(int(a * 1e4))
    x = torch.cat([quant_edge_values(a, dtype),
                   (60 * a * torch.randn(4096, generator=g)).to(dtype)])
    scale = _scale(a, kind)
    got = quantize_int8_plain(x, scale)
    chain = torch.clamp(torch.round(x.float() / scale), -127,
                        127).to(torch.int8)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, chain)
    assert torch.equal(quantize_int8(x, scale), got)
    xj = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    want = np.asarray(jq._quant_input(xj, jnp.asarray(scale.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


def test_edge_values_tell_the_division_from_a_multiply():
    """The edge inputs reach both saturation codes, and at a scale that is
    not a power of two some of their codes move if x is multiplied by
    1 / a in place of the division: a kernel that multiplied would fail
    the card tests that compare it on these inputs."""
    a = torch.tensor([0.1])
    x = quant_edge_values(0.1, torch.float32)
    got = quantize_int8_plain(x, a)
    mul = torch.clamp(torch.round(x * (1 / a)), -127, 127).to(torch.int8)
    assert bool((got == 127).any()) and bool((got == -127).any())
    assert bool((got != mul).any())


def _refused(case):
    x, a = torch.randn(2, 4, 4, 8), torch.tensor([0.1])
    return {
        "int8 x": (x.to(torch.int8), a),
        "float16 x": (x.half(), a),
        "float64 x": (x.double(), a),
        "non-contiguous x": (x.permute(0, 3, 1, 2), a),
        "scale (2,)": (x, torch.tensor([0.1, 0.2])),
        "scale (1, 1)": (x, torch.tensor([[0.1]])),
        "float64 scale": (x, torch.tensor([0.1], dtype=torch.float64)),
        "python float scale": (x, 0.1),
        "scale on another device": (x, torch.empty(1, device="meta")),
        "x on another device": (x.to("meta"), a.to("meta")),
    }[case]


@pytest.mark.parametrize("case", [
    "int8 x", "float16 x", "float64 x", "non-contiguous x", "scale (2,)",
    "scale (1, 1)", "float64 scale", "python float scale",
    "scale on another device", "x on another device"])
def test_wrapper_refuses(case):
    """x other than contiguous bf16 or float32 on the CPU or a CUDA card,
    and a scale other than one float32 value of shape () or (1,) on x's
    device, raise (never a silent fallback)."""
    x, a = _refused(case)
    with pytest.raises(ValueError, match="quantize_int8"):
        quantize_int8(x, a)


@pytest.fixture(scope="module")
def tables():
    """Per net: int8_deep tables from a 2-step trajectory's calibration
    (per-step scale rows), an input and its t."""
    out = {}
    with torch.random.fork_rng():
        torch.manual_seed(22)
        models = {"notebook": FastDDPMUNet(base_features=FEAT, time_dim=8),
                  "ddpm": DDPMUNet(base_features=NETS["ddpm"][0])}
    sched = DiffusionSchedule.create(1000, 2, "linear", "linspace")
    for net, model in models.items():
        hw = NETS[net][1]
        params = fastddpm_flax_params(model)
        g = torch.Generator().manual_seed(hw)
        cond = torch.randn((BATCH, hw, hw, 2), generator=g)
        calib = calibrate_fastddpm({"params": params}, sched, [cond])
        q = quantize_fastddpm({"params": params}, calib,
                              only=deep_sites(params))
        x = torch.randn((BATCH, hw, hw, 3), generator=g)
        out[net] = (q, x, torch.full((BATCH,), int(sched.timesteps[-1])))
    return out


@pytest.mark.parametrize("net", sorted(NETS))
def test_forward_quantizes_at_the_listed_sites(tables, net):
    """One int8_deep denoiser call with K3 (gn_impl 'fused', the card's
    default) quantizes bf16 inputs with a per-step scale row through
    ``quantize_int8`` at the listed sites (:func:`quant_sites`: 6 on
    the notebook net, 27 on the DDPM UNet), shape for shape, each inside a
    ``ddpm.quant`` span, and gives the bits it gives with the quantizer's
    plain version in its place."""
    q, x, t = tables[net]
    seen = []

    def quant(h, a):
        seen.append((tuple(h.shape), h.dtype, tuple(a.shape)))
        return quantize_int8(h, a)

    fwd, ref = (int8_forward(q, gn_impl="fused", device="cpu")
                for _ in range(2))
    fwd._q8, ref._q8 = quant, quantize_int8_plain
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = fwd(x, t)
    spans = [s for s in RECORDER.spans() if s.name == "ddpm.quant"]
    RECORDER.clear()
    width, hw = NETS[net]
    sites = quant_sites(net, width, hw)
    assert len(sites) == {"notebook": 6, "ddpm": 27}[net]
    assert sorted(s[0] for s in seen) == sorted(
        (BATCH, h, h, c) for _, h, c in sites)
    assert {s[1:] for s in seen} == {(torch.bfloat16, (1,))}
    assert len(spans) == len(sites)
    assert torch.equal(got, ref(x, t))


def test_chip_smoke_quant_sites_are_the_listed_ones():
    """chip_smoke.py's quantizer sites of the notebook net at full width
    (base 64, 256^2) are :func:`quant_sites`', which the forward test above
    holds to the forward, site for site."""
    import chip_smoke

    assert chip_smoke.diffusion_quant_sites() == quant_sites(
        "notebook", chip_smoke.FEATURES, chip_smoke.HW)
    assert chip_smoke.DDPM_QUANT == len(quant_sites("ddpm", chip_smoke.DDPM_CH,
                                                    chip_smoke.HW))
