"""The DDPM UNet that Fast-DDPM publishes (``models/ddpm_unet.py``,
registered ``fastddpm_pmub``) against its plain reference
(``portbench/reference/fastddpm_pmub.py``: plain float32 torch, nothing of
the port), on the benchmark's seeded weights, on the CPU at ch 32 and 64^2
(all six levels and the attention level), and its int8_deep serving path:
``FastDDPMForward`` over its tree with kernel A's and K3's plain versions,
the bundle, and the benchmark's site counts.  For both Fast-DDPM networks:
the ``Network`` description that the forward, the quantizer and the
exporter read, and the trainer building each diffusion preset's network."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mrisr_tpu_torch.ckpt.from_jax import fastddpm_flax_params
from mrisr_tpu_torch.config import PRESETS
from mrisr_tpu_torch.models import ddpm_unet
from mrisr_tpu_torch.models.ddpm_unet import DDPMUNet, attention
from mrisr_tpu_torch.models.diffusion import (
    DiffusionSchedule,
    FastDDPMUNet,
    SimpleDiffusionUNet,
)
from mrisr_tpu_torch.models.registry import TRAINABLE, init_model
from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu_plain
from mrisr_tpu_torch.serve.quant_diffusion import (
    DDPM,
    DEEP_SITES,
    NOTEBOOK,
    FastDDPMForward,
    calibrate_fastddpm,
    deep_sites,
    int8_forward,
    network,
    quantize_fastddpm,
)
from mrisr_tpu_torch.train import DiffusionTrainer
from mrisr_tpu_torch.utils.profiling import RECORDER
from portbench.families.fastddpm_pmub import _rule
from portbench.reference import counts, counts_pmub
from portbench.reference import fastddpm_pmub as ref
from portbench.reference.unet import Quantizer
from portbench.weights import draw

CH, HW, BATCH = 32, 64, 2
PUBLISHED = 113_670_913
# int8_deep against the float32 reference at the first sampler step
# (t = 999): 0.024 measured; every conv in int8 (the 256^2 level, conv_in,
# conv_out and the downsamples too) 0.057.  The budget sits between.
INT8_BUDGET = 0.04


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
    model = DDPMUNet(base_features=CH).eval()
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
    return calib, x, t


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_num_parameters_published():
    """113,670,913 at ch 128, 3 in and 1 out, reckoned from shapes by the
    port and by the reference, and what a built model holds."""
    assert ddpm_unet.num_parameters() == ref.num_parameters() == PUBLISHED
    model = DDPMUNet(base_features=CH)
    assert sum(p.numel() for p in model.parameters()) == \
        ddpm_unet.num_parameters(CH) == ref.num_parameters(CH)


def test_state_dict_keys_are_the_ddim_names():
    """The state dict is the DDIM code's, name for name and shape for
    shape: 71 GroupNorms, 120 convs, five down- and five upsamplers, six
    attention blocks."""
    sd = DDPMUNet(base_features=CH).state_dict()
    want = ref.param_shapes(CH)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    names = set(sd)
    for k in ("temb.dense.0.weight", "temb.dense.1.bias", "conv_in.weight",
              "down.0.block.0.norm1.weight",
              "down.2.block.0.nin_shortcut.weight",
              "down.4.attn.1.proj_out.weight", "down.4.downsample.conv.weight",
              "mid.block_1.temb_proj.weight", "mid.attn_1.q.weight",
              "up.4.attn.2.k.weight", "up.1.upsample.conv.weight",
              "up.0.block.2.nin_shortcut.bias", "norm_out.weight",
              "conv_out.bias"):
        assert k in names, k
    assert not any(k.startswith(("down.5.downsample", "up.0.upsample"))
                   for k in names)
    kinds = collections.Counter(
        "norm" if v.dim() == 1 and "norm" in k.rsplit(".", 2)[-2] else
        "conv" if v.dim() == 4 else None for k, v in sd.items()
        if k.endswith("weight"))
    assert (kinds["norm"], kinds["conv"]) == (71, 120)
    assert sum(k.endswith("attn_1.q.weight") or ".attn." in k and
               k.endswith(".q.weight") for k in names) == 6


def test_registry_and_preset():
    """``fastddpm_pmub`` is a diffusion model of the registry; its preset
    is the published network's: ch 128, time embedding 512, linear betas
    over 1000 steps, 10 steps of 'nonuniform-4060'."""
    assert TRAINABLE["fastddpm_pmub"] == "diffusion"
    cfg = PRESETS["fastddpm_pmub"].model
    assert (cfg.base_features, cfg.time_dim, cfg.beta_schedule,
            cfg.num_timesteps, cfg.num_inference_steps,
            cfg.timestep_selection) == (128, 512, "linear", 1000, 10,
                                        "nonuniform-4060")
    model, kind = init_model("fastddpm_pmub", dataclasses.replace(
        cfg, base_features=CH, time_dim=4 * CH))
    assert kind == "diffusion" and isinstance(model, DDPMUNet)
    sched = DiffusionSchedule.create(1000, 10, "linear", "nonuniform-4060")
    np.testing.assert_allclose(sched.betas.numpy(), ref.linear_betas(),
                               rtol=1e-6)
    assert [t for t, *_ in ref.chain()] == sched.timesteps.tolist()[::-1]


def test_float32_forward_matches_reference(seeded):
    """The module and ``FastDDPMForward`` in float32 against the plain
    reference: float32 rounding alone (1.2e-6 measured), at t 999 and 0."""
    w, model, params = seeded
    g = torch.Generator().manual_seed(5)
    x = torch.randn((BATCH, HW, HW, 3), generator=g)
    fwd = FastDDPMForward(params, dtype=torch.float32, device="cpu")
    for tv in (999, 0):
        t = torch.full((BATCH,), tv)
        with torch.no_grad():
            want = ref.denoiser(w, x, t)
            got = model(x, t)
        assert got.shape == (BATCH, HW, HW, 1)
        assert _rel(got, want) < 1e-5
        assert _rel(fwd(x, t), want) < 1e-5


@pytest.mark.parametrize("group", [8, 12, 16, 24, 32])
def test_groupnorm_plain_wide_groups(group):
    """K3's plain version at the DDPM UNet's group sizes against
    ``F.group_norm`` with eps 1e-6, then SiLU (and alone, the attention
    norms' identity mode): float32 rounding (1e-5)."""
    c = 32 * group
    g = torch.Generator().manual_seed(group)
    x = torch.randn((2, 8, 8, c), generator=g) * 3.0 + 0.5
    gamma = torch.randn(c, generator=g) * 0.5 + 1.0
    beta = torch.randn(c, generator=g) * 0.2
    norm = F.group_norm(x.permute(0, 3, 1, 2), 32, gamma, beta,
                        1e-6).permute(0, 2, 3, 1)
    for silu, want in ((True, F.silu(norm)), (False, norm)):
        got = groupnorm_silu_plain(x, gamma, beta, num_groups=32, eps=1e-6,
                                   out_dtype=torch.float32, silu=silu)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_int8_deep_forward_matches_reference_emulation(seeded, tables):
    """int8_deep (the 99 convs below the full-size level; K3 and A as
    their plain versions, 'fused' and 'chain') against the reference served
    by the same tables: the port's per-step activation scales, int8 weights
    per output channel, and the bundle's bf16 copies of the float sites'
    weights.  Within 0.05 (0.019-0.022 measured: a code a boundary apart
    at one site moves the next site's inputs, and that runs on through 99
    int8 sites); and within the int8 budget of the float32 reference,
    which an emulation with every conv in int8 fails."""
    w, _, params = seeded
    calib, x, t = tables
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    assert len(q["int8"]) == 99
    deep = ref.deep_sites(CH)
    assert sorted(n.replace(".", "/") for n in deep) == sorted(q["int8"])
    leaves = {f"{n}.{leaf}" for n in deep for leaf in ("weight", "bias")}
    w_tables = {k: v if k in leaves else v.to(torch.bfloat16).float()
                for k, v in w.items()}
    row = 1  # t = 999: the schedule's last row

    def served(sites):
        quant = Quantizer(8, sites)
        for name in sites:
            quant.absmax[(name, 0)] = float(calib[name.replace(".", "/")][row])
        quant.recording = False
        with torch.no_grad():
            return ref.denoiser(w_tables, x, t, quant)

    with torch.no_grad():
        want = ref.denoiser(w, x, t)
    emulated = served(deep)
    for gn_impl in ("fused", "chain"):
        got = int8_forward(q, dtype=torch.float32, gn_impl=gn_impl,
                           device="cpu")(x, t)
        assert _rel(got, emulated) < 0.05
        assert _rel(got, want) < INT8_BUDGET
    every = tuple(k[:-len(".weight")] for k, s in ref.param_shapes(CH).items()
                  if len(s) == 4)
    assert len(every) == 120
    assert _rel(served(every), want) > INT8_BUDGET


def test_attention_core_is_float():
    """The attention core (``models/ddpm_unet.py:attention``: float32
    scores and softmax) against the reference's float core, to float32
    rounding (1e-5); its operands and weights in int8 (absmax scales)
    would read 5e-3 or more at these 256 tokens, far past that."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, 256, 128), generator=g) for _ in range(3))

    def core(q, k, v, quant=lambda a: a):
        p = torch.softmax(torch.bmm(quant(q), quant(k).transpose(1, 2))
                          * q.shape[-1] ** -0.5, dim=-1)
        return torch.bmm(quant(p), quant(v))

    def int8(a):
        s = a.abs().amax() / 127
        return torch.clamp(torch.round(a / s), -127, 127) * s

    want = core(q, k, v)
    assert _rel(attention(q, k, v), want) < 1e-5
    assert _rel(core(q, k, v, int8), want) > 5e-3


def _visits(q, x, t, gn_impl="fused"):
    """One int8_deep call with kernel A's and K3's plain versions
    recorded: each launch's site as ``counts`` reckons it."""
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
        seen["k3"].append(counts_pmub.gn_site(
            "", n, hh, c, kw.get("quant_scale") is not None,
            kw["silu"])[1:])
        return gn8(h, gamma, beta, **kw)

    fwd._conv8, fwd._gn8 = a, k3
    return fwd(x, t), seen


def test_family_sites_are_the_sites_a_call_visits(seeded, tables):
    """The benchmark's counts (``counts_pmub.kernel_sites``) list every
    launch one int8_deep denoiser call makes: 99 of kernel A, 71 of K3 (60
    emitting int8 codes, 6 of them GroupNorm alone, and the full-size
    level's 11 emitting bf16), shape for shape."""
    _, _, params = seeded
    calib, x, t = tables
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    _, seen = _visits(q, x, t)
    sites = counts_pmub.kernel_sites(BATCH, HW, CH)
    for kernel in ("kernel_a", "k3"):
        assert sorted(seen[kernel]) == sorted(s[1:] for s in sites[kernel])
    assert (len(seen["kernel_a"]), len(seen["k3"])) == (99, 71)
    ops = counts_pmub.model_ops(HW, CH, 4 * CH, steps=1)
    deep = sum(o for _, o, _, p in ops if p == counts.PEAK_INT8_OPS)
    assert deep == sum(s[1] for s in sites["kernel_a"]) / BATCH


def test_spans_of_a_call(seeded, tables):
    """Under a profiler, one call records ``ddpm.attn`` 6 times,
    ``ddpm.attn_bmm`` 6, ``ddpm.level`` 13 (six levels down, the middle,
    six up) with ``res`` the maps' height, and ``ddpm.k3`` at all 71
    GroupNorms, 11 of them (the full-size level) inside a
    ``ddpm.gn_chain``."""
    _, _, params = seeded
    calib, x, t = tables
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        int8_forward(q, gn_impl="fused", device="cpu")(x, t)
    spans = RECORDER.spans()
    RECORDER.clear()
    names = collections.Counter(s.name for s in spans)
    assert (names["ddpm.attn"], names["ddpm.attn_bmm"], names["ddpm.level"],
            names["ddpm.k3"], names["ddpm.gn_chain"]) == (6, 6, 13, 71, 11)
    res = collections.Counter(s.ids["res"] for s in spans
                              if s.name == "ddpm.level")
    assert res == {HW: 2, HW // 2: 2, HW // 4: 2, HW // 8: 2, HW // 16: 2,
                   HW // 32: 3}


def test_bundle_serves_through_the_normal_path(tmp_path):
    """``export_serving_bundle(model_name='fastddpm_pmub',
    quant='int8_deep')`` from a checkpoint, then ``engine_from_bundle``:
    the ancestral sampler over the bundle's 99 int8 sites, 'fused' and
    'chain' within int8 rounding of each other; tables holding a stride-2
    downsample, or q, k and v of one attention block at different scales,
    are refused (kernel A runs stride 1; K3 quantizes their input once)."""
    from mrisr_tpu_torch.serve.bundle import (
        _reflatten_int8_sites,
        engine_from_bundle,
        export_serving_bundle,
        load_bundle,
        make_bundle_apply,
    )

    cfg = dataclasses.replace(PRESETS["fastddpm_pmub"].model,
                              base_features=CH, time_dim=4 * CH,
                              num_inference_steps=3)
    model, _ = init_model("fastddpm_pmub", cfg, seed=4)
    torch.save({"model_state_dict": model.state_dict()},
               tmp_path / "fastddpm_pmub_best.pt")
    cond = np.random.default_rng(0).random((2, 32, 32, 2), np.float32)
    path = export_serving_bundle(
        str(tmp_path / "b"), model_name="fastddpm_pmub",
        models_dir=str(tmp_path), quant="int8_deep",
        calibration_batches=[cond], cfg=cfg, image_size=(32, 32),
        device="cpu")
    params, meta = load_bundle(path)
    assert (meta["kind"], meta["base_features"], meta["time_dim"]) == (
        "diffusion", CH, 4 * CH)
    sites = _reflatten_int8_sites(params["int8"])
    assert len(sites) == 99 and sites["up/2/upsample/conv"]["a_scale"].shape \
        == (2,)
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        y = eng.predict(cond[0])
    assert y.shape == (32, 32, 1) and np.isfinite(y).all()
    fused = make_bundle_apply(params, meta, "cpu", gn_impl="fused")(
        torch.from_numpy(cond))
    chain = make_bundle_apply(params, meta, "cpu", gn_impl="chain")(
        torch.from_numpy(cond))
    assert _rel(fused, chain) < 0.05
    np.testing.assert_allclose(y, chain[0].numpy(), rtol=0, atol=1e-5)
    bad = dict(sites)
    bad["down/1/downsample/conv"] = sites["up/2/upsample/conv"]
    with pytest.raises(ValueError, match="stride"):
        FastDDPMForward(params["params"], bad, params["timesteps"],
                        device="cpu")
    # K3 quantizes an attention norm's output once, for q, k and v
    k = "down/4/attn/0/k"
    odd = dict(sites, **{k: dict(sites[k], a_scale=2 * sites[k]["a_scale"])})
    with pytest.raises(ValueError, match="one activation scale"):
        FastDDPMForward(params["params"], odd, params["timesteps"],
                        device="cpu")


def test_int8_bundle_serves_with_the_downsamples_float(tmp_path):
    """``quant='int8'`` quantizes every conv kernel A runs: the 115
    stride-1 convs, the full-size level, conv_in and conv_out among them,
    and not the five stride-2 downsamples, so the bundle that
    ``export_serving_bundle`` writes is one ``engine_from_bundle`` serves."""
    from mrisr_tpu_torch.serve.bundle import (
        _reflatten_int8_sites,
        engine_from_bundle,
        export_serving_bundle,
        load_bundle,
    )

    cfg = dataclasses.replace(PRESETS["fastddpm_pmub"].model,
                              base_features=CH, time_dim=4 * CH,
                              num_inference_steps=2)
    model, _ = init_model("fastddpm_pmub", cfg, seed=5)
    torch.save({"model_state_dict": model.state_dict()},
               tmp_path / "fastddpm_pmub_best.pt")
    cond = np.random.default_rng(1).random((2, 32, 32, 2), np.float32)
    path = export_serving_bundle(
        str(tmp_path / "b"), model_name="fastddpm_pmub",
        models_dir=str(tmp_path), quant="int8",
        calibration_batches=[cond], cfg=cfg, image_size=(32, 32),
        device="cpu")
    params, meta = load_bundle(path)
    sites = _reflatten_int8_sites(params["int8"])
    convs = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert (len(convs), len(sites)) == (120, 115)
    assert not [n for n in sites if n.endswith("downsample/conv")]
    assert {"conv_in", "conv_out", "down/0/block/0/conv1"} <= set(sites)
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        y = eng.predict(cond[0])
    assert y.shape == (32, 32, 1) and np.isfinite(y).all()


def _tree_layers(tree, path=()):
    """A flax-layout tree's layers (a dict that holds a ``kernel`` or a
    GroupNorm's ``scale``) as ('/'-joined name, leaves)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "kernel" in v or "scale" in v:
                yield "/".join(path + (k,)), v
            else:
                yield from _tree_layers(v, path + (k,))


# network -> (its description, its input's H = W, int8_deep's site count,
# the stride-2 convs that int8 leaves float)
NETWORKS = {
    "notebook": (NOTEBOOK, 16, 16, set()),
    "ddpm": (DDPM, 32, 99, {f"down/{i}/downsample/conv" for i in range(5)}),
}


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_network_description(net):
    """``network`` names each tree's network (the notebook FastDDPMUNet at
    base 8, the DDPM UNet at ch 32) and every layer its description names
    is in the tree; its GroupNorm eps and groups are the model's; the
    forward that reads it is the model's in float32 (1e-5); ``deep_sites``
    gives the notebook's :data:`DEEP_SITES` and the DDPM UNet's 99;
    ``quantize_fastddpm(only=None)`` leaves exactly the DDPM UNet's five
    downsamples float; the exporter's ``time_dim`` and ``base_features``
    are the widths the model was built with."""
    desc, hw, n_deep, strided = NETWORKS[net]
    torch.manual_seed(31)
    if net == "notebook":
        model, base, tdim = FastDDPMUNet(base_features=8, time_dim=16), 8, 16
    else:
        model, base, tdim = DDPMUNet(base_features=CH), CH, 4 * CH
    params = fastddpm_flax_params(model.eval())
    assert network(params) is desc
    layers = dict(_tree_layers(params))
    names = set(layers)
    assert {*desc.time_mlp, desc.first_conv, *desc.upconvs} <= names
    leaves = collections.Counter(n.rpartition("/")[2] for n in names)
    assert leaves[desc.temb] == leaves["conv2"] and leaves[desc.skip] > 0
    norms = [m for m in model.modules() if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(
        (m.eps, m.num_groups) == (desc.gn_eps, desc.groups(m.num_channels))
        for m in norms)
    g = torch.Generator().manual_seed(32)
    x, t = torch.randn((BATCH, hw, hw, 3), generator=g), torch.tensor([9, 700])
    fwd = FastDDPMForward(params, dtype=torch.float32, device="cpu")
    assert fwd.net is desc
    with torch.no_grad():
        assert _rel(fwd(x, t), model(x, t)) < 1e-5
    deep = deep_sites(params)
    assert len(deep) == n_deep
    if net == "notebook":
        assert set(deep) == set(DEEP_SITES)
    convs = {n for n, p in layers.items()
             if "kernel" in p and p["kernel"].dim() == 4}
    calib = {n: np.ones(2, np.float32) for n in convs}
    q = quantize_fastddpm({"params": params}, calib)
    assert convs - set(q["int8"]) == strided
    assert (desc.time_dim(params), desc.base_features(params)) == (tdim, base)


@pytest.mark.parametrize("preset,cls,count", [
    ("fastddpm", FastDDPMUNet, 3_588_353),
    ("fastddpm_simple", SimpleDiffusionUNet, 676_865),
    ("fastddpm_pmub", DDPMUNet, ddpm_unet.num_parameters(CH)),
])
def test_trainer_builds_the_presets_network(preset, cls, count):
    """``DiffusionTrainer`` trains the network its preset names, at base
    32: ``fastddpm_pmub`` the DDPM UNet (it built the notebook net once),
    the other two the modules they always had (class, parameter count and
    state-dict keys); one train step runs and moves the weights."""
    cfg = PRESETS[preset]
    tdim = 4 * CH if preset == "fastddpm_pmub" else cfg.model.time_dim
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, base_features=CH, time_dim=tdim))
    tr = DiffusionTrainer(cfg, device="cpu")
    module = tr.state.module
    assert type(module) is cls
    assert sum(p.numel() for p in module.parameters()) == count
    kwargs = {} if cls is SimpleDiffusionUNet else {"time_dim": tdim}
    assert list(module.state_dict()) == list(
        cls(base_features=CH, **kwargs).state_dict())
    before = [p.detach().clone() for p in module.parameters()]
    batch = torch.rand((2, 32, 32, 3), generator=torch.Generator()
                       .manual_seed(33))
    metrics = tr._train(batch, tr._generator(0, True, 0))
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, module.parameters()))
