"""ADM's diffusion UNet (``models/adm_unet.py``, registered
``fastddpm_adm``) against its plain reference
(``portbench/reference/fastddpm_adm.py``: plain float32 torch, nothing of
the port), on the benchmark's seeded weights, on the CPU at ch 32 and 64^2
(all six levels, the five down- and five up-ResBlocks, attention at the
three levels of 32^2, 16^2 and 8^2 of a 256^2 input, in the published
heads of 64 channels: 1, 2 and 2 heads at 64, 128 and 128 channels), and its int8_deep serving path: ``FastDDPMForward`` over its
tree with kernel A's, K3's and the quantizer's plain versions, the bundle,
and the benchmark's site counts."""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.config import PRESETS
from mrisr_tpu_torch.models import adm_unet
from mrisr_tpu_torch.models.adm_unet import ADMUNet, qkv_attention
from mrisr_tpu_torch.models.diffusion import (
    DiffusionSchedule,
    timestep_embedding,
)
from mrisr_tpu_torch.models.registry import TRAINABLE, init_model
from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu_plain
from mrisr_tpu_torch.serve.quant_diffusion import (
    ADM,
    FastDDPMForward,
    calibrate_fastddpm,
    deep_sites,
    gn_silu_chain,
    int8_forward,
    network,
    quantize_fastddpm,
)
from mrisr_tpu_torch.utils.profiling import RECORDER
from portbench.families.fastddpm_adm import _rule
from portbench.reference import counts, counts_adm
from portbench.reference import fastddpm_adm as ref
from portbench.reference.unet import Quantizer
from portbench.weights import draw

CH, HW, BATCH = 32, 64, 2
PUBLISHED = 552_804_866
RELEASED = 552_814_086  # 3 in, 6 out: the 256x256 unconditional model
# int8_deep against the float32 reference at the first sampler step
# (t = 999): 0.0337-0.0340 measured ('chain', 'fused'); every conv in int8
# (the 256^2 level, the first and last convs and the up-ResBlock into
# 256^2 too) 0.0661.  The budget sits between.
INT8_BUDGET = 0.05


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seeded():
    """The benchmark's seeded weights at ch 32, the port's model holding
    them and its flax-layout tree."""
    shapes = ref.param_shapes(CH)
    w = draw(shapes, _rule(shapes), 11, torch.device("cpu"))
    model = ADMUNet(base_features=CH).eval()
    model.load_state_dict(w, strict=True)
    return w, model, fastddpm_flax_params(model)


@pytest.fixture(scope="module")
def tables(seeded):
    """int8_deep tables from a float32 calibration over a 2-step
    trajectory, an input and the first step's t."""
    _, _, params = seeded
    sched = DiffusionSchedule.create(1000, 2, "linear", "linspace")
    g = torch.Generator().manual_seed(3)
    cond = torch.randn((BATCH, HW, HW, 2), generator=g)
    calib = calibrate_fastddpm({"params": params}, sched, [cond],
                               dtype=torch.float32)
    x = torch.randn((BATCH, HW, HW, 3), generator=g)
    t = torch.full((BATCH,), int(sched.timesteps[-1]))
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    return calib, q, x, t


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("cout,want", [(2, PUBLISHED), (6, RELEASED)])
def test_num_parameters_published(cout, want):
    """552,804,866 at ch 256, 3 in and 2 out (552,814,086 at the released
    model's 6 out), reckoned from shapes by the port and by the
    reference, and what a built model holds."""
    assert adm_unet.num_parameters(out_channels=cout) == \
        ref.num_parameters(cout=cout) == want
    model = ADMUNet(base_features=CH, out_channels=cout)
    assert sum(p.numel() for p in model.parameters()) == \
        adm_unet.num_parameters(CH, out_channels=cout) == \
        ref.num_parameters(CH, cout=cout)


def test_state_dict_keys_are_guided_diffusions():
    """The state dict is guided-diffusion's, name for name and shape for
    shape (the attention's 1x1 projections Conv1d): 101 GroupNorms, 42
    ResBlocks, 138 convs, 16 attention blocks, 20 1x1 skips."""
    sd = ADMUNet(base_features=CH).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == ref.param_shapes(CH)
    for k in ("time_embed.0.weight", "time_embed.2.bias",
              "input_blocks.0.0.weight", "input_blocks.1.0.in_layers.2.weight",
              "input_blocks.3.0.emb_layers.1.weight",
              "input_blocks.7.0.skip_connection.weight",
              "input_blocks.10.1.qkv.weight", "middle_block.1.proj_out.bias",
              "middle_block.2.out_layers.3.weight",
              "output_blocks.2.2.in_layers.0.weight",
              "output_blocks.14.1.emb_layers.1.weight",
              "output_blocks.8.2.out_layers.0.bias", "out.0.weight",
              "out.2.bias"):
        assert k in sd, k
    assert tuple(sd["input_blocks.10.1.qkv.weight"].shape) == (
        3 * 2 * CH, 2 * CH, 1)
    norms = sum(k.endswith((".in_layers.0.weight", ".out_layers.0.weight",
                            ".norm.weight")) or k == "out.0.weight"
                for k in sd)
    convs = sum(v.dim() >= 3 for k, v in sd.items() if k.endswith("weight"))
    assert (norms, convs) == (101, 138)
    assert sum(k.endswith("emb_layers.1.weight") for k in sd) == 42
    assert sum(k.endswith(".qkv.weight") for k in sd) == 16
    assert sum(k.endswith("skip_connection.weight") for k in sd) == 20


def test_registry_and_preset():
    """``fastddpm_adm`` is a diffusion model of the registry with two
    outputs (the noise and the learned variance); its preset is the
    published network's: ch 256, time embedding 1024, linear betas over
    1000 steps, 10 steps of 'nonuniform-4060'."""
    assert TRAINABLE["fastddpm_adm"] == "diffusion"
    cfg = PRESETS["fastddpm_adm"].model
    assert (cfg.base_features, cfg.time_dim, cfg.beta_schedule,
            cfg.num_timesteps, cfg.num_inference_steps,
            cfg.timestep_selection) == (256, 1024, "linear", 1000, 10,
                                        "nonuniform-4060")
    model, kind = init_model("fastddpm_adm", dataclasses.replace(
        cfg, base_features=CH, time_dim=4 * CH))
    assert kind == "diffusion" and isinstance(model, ADMUNet)
    assert model.out[2].out_channels == 2
    assert adm_unet.HEAD_CHANNELS == 64
    # heads of 64 at ch 32: 64 channels at 8^2, 128 at 4^2 and 2^2
    assert collections.Counter(
        m.heads for m in model.modules()
        if isinstance(m, adm_unet.AttentionBlock)) == {1: 5, 2: 11}


def test_timestep_embedding_adm():
    """'adm' is guided-diffusion's: ``[cos, sin]`` of t times
    ``exp(-ln(1e4) i / half)``, the frequencies over ``half`` where
    'ddpm' divides by ``half - 1``; the reference's to float32 rounding."""
    t = torch.tensor([0, 1, 17, 999])
    dim, half = 256, 128
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half).double()
                      / half)
    args = t.double()[:, None] * freqs[None]
    want = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    got = timestep_embedding(t, dim, "adm")
    torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-4)
    torch.testing.assert_close(got, ref.embedding(t, dim), rtol=0, atol=0)
    assert torch.equal(got[:, :half], timestep_embedding(t, dim,
                                                         "simple")[:, half:])


def test_float32_forward_matches_reference(seeded):
    """The module and ``FastDDPMForward`` in float32, both output channels,
    against the plain reference: float32 rounding alone (2e-7 measured),
    at t 999 and 0."""
    w, model, params = seeded
    g = torch.Generator().manual_seed(5)
    x = torch.randn((BATCH, HW, HW, 3), generator=g)
    fwd = FastDDPMForward(params, dtype=torch.float32, device="cpu")
    for tv in (999, 0):
        t = torch.full((BATCH,), tv)
        with torch.no_grad():
            want = ref.denoiser(w, x, t)
            got = model(x, t)
        assert got.shape == want.shape == (BATCH, HW, HW, 2)
        assert _rel(got, want) < 1e-5
        assert _rel(fwd(x, t), want) < 1e-5


@pytest.mark.parametrize("group", [8, 16, 24, 32, 48, 64])
def test_groupnorm_plain_scale_shift(group):
    """K3's plain version in its scale-shift mode at ADM's group sizes
    (8 to 64 channels) against ``F.group_norm(eps=1e-5) (1 + scale) +
    shift``, then SiLU: float32 rounding (1e-5); the chain the same in
    float32."""
    c = 32 * group
    g = torch.Generator().manual_seed(group)
    x = torch.randn((2, 4, 4, c), generator=g) * 3.0 + 0.5
    gamma = torch.randn(c, generator=g) * 0.5 + 1.0
    beta = torch.randn(c, generator=g) * 0.2
    ss = torch.randn((2, 2 * c), generator=g) * 0.5
    scale, shift = ss[:, None, None, :c], ss[:, None, None, c:]
    norm = F.group_norm(x.permute(0, 3, 1, 2), 32, gamma, beta,
                        1e-5).permute(0, 2, 3, 1)
    want = F.silu(norm * (1 + scale) + shift)
    got = groupnorm_silu_plain(x, gamma, beta, num_groups=32, eps=1e-5,
                               out_dtype=torch.float32, scale_shift=ss)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    chain = gn_silu_chain(x, gamma, beta, 32, torch.float32, 1e-5,
                          scale_shift=ss)
    torch.testing.assert_close(chain, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads", [1, 2, 8])
def test_legacy_qkv_split_matches_a_per_head_loop(heads):
    """``qkv_attention`` on tokens against guided-diffusion's legacy split
    done head by head on the NCT layout: head ``i`` takes channels ``[3 i
    ch, 3 (i + 1) ch)`` of the qkv conv as its q, k and v, ``q`` and ``k``
    scaled by ``ch^-1/4``, and writes channels ``[i ch, (i + 1) ch)``:
    float32 rounding (1e-5).  The float path runs on the CPU."""
    ch, t, b = 16, 48, 2
    g = torch.Generator().manual_seed(heads)
    qkv = torch.randn((b, 3 * heads * ch, t), generator=g)  # NCT
    outs = []
    for i in range(heads):
        q, k, v = qkv[:, 3 * i * ch:3 * (i + 1) * ch].split(ch, dim=1)
        s = ch ** -0.25
        weight = torch.softmax(torch.einsum("bct,bcs->bts", q * s, k * s),
                               dim=-1)
        outs.append(torch.einsum("bts,bcs->bct", weight, v))
    want = torch.cat(outs, dim=1)
    before = (qkv_attention.calls_fused, qkv_attention.calls_float)
    got = qkv_attention(qkv.transpose(1, 2), heads).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (qkv_attention.calls_fused, qkv_attention.calls_float) == (
        before[0], before[1] + 1)


def _served(w, calib, x, t, sites, row=1):
    """The reference served by the port's tables: ``sites`` in int8 at
    the port's per-step activation scales (``row`` 1, t = 999: the
    schedule's last row) with int8 weights per output channel, every
    other weight the bundle's bf16 copy."""
    leaves = {f"{n}.{leaf}" for n in sites for leaf in ("weight", "bias")}
    w_tables = {k: v if k in leaves else v.to(torch.bfloat16).float()
                for k, v in w.items()}
    quant = Quantizer(8, sites)
    for name in sites:
        quant.absmax[(name, 0)] = float(calib[name.replace(".", "/")][row])
    quant.recording = False
    with torch.no_grad():
        return ref.denoiser(w_tables, x, t, quant)


def test_int8_deep_forward_matches_reference_emulation(seeded, tables):
    """int8_deep (the 121 convs whose input is below the full-size level;
    K3, A and the quantizer as their plain versions, 'fused' and 'chain')
    against the reference served by the same tables, both channels.
    Within 0.05: 0.0278-0.0280 measured, which is the emulation's own
    distance from itself computed in float64 (0.0259): a code a boundary
    apart at one site moves the next site's inputs, and that runs on
    through 121 int8 sites, so the whole network cannot tell an int8 site
    from a float one (the float-served port reads 0.033 from it); the
    site-by-site test below does.  The emulation at the wrong per-step
    scales (row 0, t = 0) reads 0.28 and fails it.  Within the int8 budget
    of the float32 reference, which an emulation with every conv in int8
    fails."""
    w, _, params = seeded
    calib, q, x, t = tables
    assert len(q["int8"]) == 121
    deep = ref.deep_sites(CH)
    assert sorted(n.replace(".", "/") for n in deep) == sorted(q["int8"])
    with torch.no_grad():
        want = ref.denoiser(w, x, t)
    emulated = _served(w, calib, x, t, deep)
    for gn_impl in ("fused", "chain"):
        got = int8_forward(q, dtype=torch.float32, gn_impl=gn_impl,
                           device="cpu")(x, t)
        assert _rel(got, emulated) < 0.05
        assert _rel(got, want) < INT8_BUDGET
    assert _rel(_served(w, calib, x, t, deep, row=0), emulated) > 0.05
    every = tuple(ref.conv_levels(CH))
    assert len(every) == 138
    assert _rel(_served(w, calib, x, t, every), want) > INT8_BUDGET


@pytest.mark.parametrize("site", [
    "input_blocks.3.0.in_layers.2",  # down: K3 in dtype, pool, quantizer
    "input_blocks.3.0.out_layers.3",  # K3's scale-shift codes
    "input_blocks.4.0.in_layers.2",  # K3's codes
    "input_blocks.7.0.skip_connection",  # the quantizer on x
    "input_blocks.10.1.qkv",  # K3's codes without SiLU
    "input_blocks.10.1.proj_out",  # the quantizer on the attention's output
    "output_blocks.0.0.skip_connection",  # the quantizer on a concatenation
    "output_blocks.2.2.in_layers.2",  # up: K3's codes repeated
    "output_blocks.11.1.out_layers.3",  # an up-ResBlock's scale-shift codes
])
def test_int8_deep_site_matches_reference_emulation(seeded, tables, site):
    """One int8_deep site at a time in int8, the rest float from the
    bundle's bf16 copies, each of the port's int8 code paths once, 'fused'
    and 'chain', against the reference served by the same tables.  With
    one site, no code flip runs on into another site: the port reads the
    emulation to float32 rounding (1.3e-6 measured; 2.8e-5 and 1.5e-4
    where a few codes lie a boundary apart, as far as the emulation in
    float64 reads from itself), and the site served in float reads 4e-4
    to 1.2e-2 from it, 70 times the port's distance or more.  So the port
    must stay within a twentieth of the float-served site's distance."""
    w, _, params = seeded
    calib, _, x, t = tables
    q = quantize_fastddpm({"params": params}, calib,
                          only=[site.replace(".", "/")])
    emulated = _served(w, calib, x, t, (site,))
    floated = _rel(FastDDPMForward(q["params"], dtype=torch.float32,
                                   device="cpu")(x, t), emulated)
    for gn_impl in ("fused", "chain"):
        got = int8_forward(q, dtype=torch.float32, gn_impl=gn_impl,
                           device="cpu")(x, t)
        assert _rel(got, emulated) < floated / 20


def _visits(q, x, t, gn_impl="fused"):
    """One int8_deep call with kernel A's and K3's plain versions
    recorded: each launch's site as ``counts_adm`` reckons it."""
    fwd = int8_forward(q, dtype=torch.bfloat16, gn_impl=gn_impl,
                       device="cpu")
    conv8, gn8 = fwd._conv8, fwd._gn8
    seen = {"kernel_a": [], "k3": []}

    def a(xq, wp, s, b, **kw):
        n, h, _, ci = xq.shape
        seen["kernel_a"].append(counts.conv_site(
            "", n, h, ci, wp.shape[0], wp.shape[1], 4)[1:])
        return conv8(xq, wp, s, b, **kw)

    def k3(h, gamma, beta, **kw):
        n, hh, _, c = h.shape
        seen["k3"].append(counts_adm.gn_site(
            "", n, hh, c, kw.get("quant_scale") is not None, kw["silu"],
            kw.get("scale_shift") is not None)[1:])
        return gn8(h, gamma, beta, **kw)

    fwd._conv8, fwd._gn8 = a, k3
    return fwd(x, t), seen


def test_family_sites_are_the_sites_a_call_visits(tables):
    """The benchmark's counts (``counts_adm.kernel_sites``) list every
    launch one int8_deep denoiser call makes: 121 of kernel A, 101 of K3
    (42 of them scale-shift norms; the five down-ResBlocks' first norms
    and the full-size level's emitting bf16), shape for shape."""
    _, q, x, t = tables
    _, seen = _visits(q, x, t)
    sites = counts_adm.kernel_sites(BATCH, HW, CH)
    for kernel in ("kernel_a", "k3"):
        assert sorted(seen[kernel]) == sorted(s[1:] for s in sites[kernel])
    assert (len(seen["kernel_a"]), len(seen["k3"])) == (121, 101)
    ops = counts_adm.model_ops(HW, CH, 4 * CH, steps=1)
    deep = sum(o for _, o, _, p in ops if p == counts.PEAK_INT8_OPS)
    assert deep == sum(s[1] for s in sites["kernel_a"]) / BATCH


def test_chip_smoke_adm_counts_are_a_calls(tables):
    """chip_smoke.py's counts of one ADM int8_deep call (K3 at all 101
    norms, 42 of them scale-shift and none shifted, 121 A, 38 quantizer
    launches, 16 attention cores) are what a call launches; the topology
    sets them, so ch 32 gives ch 256's."""
    import chip_smoke

    _, q, x, t = tables
    fwd = int8_forward(q, dtype=torch.bfloat16, gn_impl="fused",
                       device="cpu")
    conv8, gn8, q8 = fwd._conv8, fwd._gn8, fwd._q8
    seen = collections.Counter()

    def a(*args, **kw):
        seen["a"] += 1
        return conv8(*args, **kw)

    def k3(*args, **kw):
        seen["k3"] += 1
        seen["scale_shift"] += kw.get("scale_shift") is not None
        seen["shift"] += kw.get("shift") is not None
        return gn8(*args, **kw)

    def quant(*args):
        seen["quant"] += 1
        return q8(*args)

    fwd._conv8, fwd._gn8, fwd._q8 = a, k3, quant
    before = qkv_attention.calls_fused + qkv_attention.calls_float
    fwd(x, t)
    seen["attn"] = qkv_attention.calls_fused + qkv_attention.calls_float \
        - before
    assert seen == {"k3": chip_smoke.ADM_K3,
                    "scale_shift": chip_smoke.ADM_SCALE_SHIFT, "shift": 0,
                    "a": chip_smoke.ADM_A, "quant": chip_smoke.ADM_QUANT,
                    "attn": chip_smoke.ADM_ATTN}
    assert (chip_smoke.ADM_K3, chip_smoke.ADM_SCALE_SHIFT, chip_smoke.ADM_A,
            chip_smoke.ADM_QUANT, chip_smoke.ADM_ATTN) == (101, 42, 121, 38,
                                                           16)
    assert chip_smoke.ADM_CH == PRESETS["fastddpm_adm"].model.base_features


def test_spans_of_a_call(tables):
    """Under a profiler, one call records ``ddpm.attn`` 16 times,
    ``ddpm.level`` 13 (six levels down, the middle, six up) with ``res``
    the maps' height, ``ddpm.updown`` 10 (five ``down``, five ``up``),
    and ``ddpm.k3`` at all 101 GroupNorms."""
    _, q, x, t = tables
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        int8_forward(q, gn_impl="fused", device="cpu")(x, t)
    spans = RECORDER.spans()
    RECORDER.clear()
    names = collections.Counter(s.name for s in spans)
    assert (names["ddpm.attn"], names["ddpm.level"], names["ddpm.updown"],
            names["ddpm.k3"]) == (16, 13, 10, 101)
    res = collections.Counter(s.ids["res"] for s in spans
                              if s.name == "ddpm.level")
    assert res == {HW: 2, HW // 2: 2, HW // 4: 2, HW // 8: 2, HW // 16: 2,
                   HW // 32: 3}
    assert collections.Counter(s.ids["dir"] for s in spans
                               if s.name == "ddpm.updown") == {"down": 5,
                                                               "up": 5}


def test_network_is_told_apart(seeded):
    """``network`` reads ADM's tree as ADM: its time MLP, its projection
    and skip leaves, its first conv, its 'adm' sinusoids."""
    _, _, params = seeded
    desc = network(params)
    assert desc is ADM and desc.t_embed == "adm"
    assert (desc.time_dim(params), desc.base_features(params)) == (4 * CH,
                                                                   CH)


def test_bundle_serves_through_the_normal_path(tmp_path):
    """``export_serving_bundle(model_name='fastddpm_adm',
    quant='int8_deep')`` from a checkpoint, then ``engine_from_bundle``:
    the ancestral sampler over the bundle's 121 int8 sites, reading the
    noise channel, 'fused' and 'chain' within int8 rounding of each
    other."""
    from mrisr_tpu_torch.serve.bundle import (
        _reflatten_int8_sites,
        engine_from_bundle,
        export_serving_bundle,
        load_bundle,
        make_bundle_apply,
    )

    cfg = dataclasses.replace(PRESETS["fastddpm_adm"].model,
                              base_features=CH, time_dim=4 * CH,
                              num_inference_steps=2)
    model, _ = init_model("fastddpm_adm", cfg, seed=4)
    torch.save({"model_state_dict": model.state_dict()},
               tmp_path / "fastddpm_adm_best.pt")
    cond = np.random.default_rng(0).random((2, 64, 64, 2), np.float32)
    path = export_serving_bundle(
        str(tmp_path / "b"), model_name="fastddpm_adm",
        models_dir=str(tmp_path), quant="int8_deep",
        calibration_batches=[cond], cfg=cfg, image_size=(64, 64),
        device="cpu")
    params, meta = load_bundle(path)
    assert (meta["kind"], meta["base_features"], meta["time_dim"]) == (
        "diffusion", CH, 4 * CH)
    sites = _reflatten_int8_sites(params["int8"])
    assert len(sites) == 121
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        y = eng.predict(cond[0])
    assert y.shape == (64, 64, 1) and np.isfinite(y).all()
    fused = make_bundle_apply(params, meta, "cpu", gn_impl="fused")(
        torch.from_numpy(cond))
    chain = make_bundle_apply(params, meta, "cpu", gn_impl="chain")(
        torch.from_numpy(cond))
    assert fused.shape == (2, 64, 64, 1)
    assert _rel(fused, chain) < 0.05
    np.testing.assert_allclose(y, chain[0].numpy(), rtol=0, atol=1e-5)
