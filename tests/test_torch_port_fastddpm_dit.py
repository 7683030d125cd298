"""DiT-XL/8 (``models/dit.py``, registered ``fastddpm_dit``) against its
plain reference (``portbench/reference/fastddpm_dit.py``: plain float32
torch, nothing of the port), on the benchmark's seeded weights (the adaLN
linears and the final layer non-zero), on the CPU at depth 2, hidden 64, 4
heads of 16 and patch 8 over 64^2 (64 tokens); kernel L's, A's GELU
form's and E's gated form's plain versions against direct formulas; and
its int8_deep serving path: ``FastDDPMForward`` over its tree with the
kernels' plain versions, the bundle, the trainer and the benchmark's site
counts."""

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
from mrisr_tpu_torch.models import dit
from mrisr_tpu_torch.models.adm_unet import qkv_attention
from mrisr_tpu_torch.models.diffusion import DiffusionSchedule
from mrisr_tpu_torch.models.dit import DiT
from mrisr_tpu_torch.models.registry import (
    TRAINABLE,
    init_model,
    param_count,
)
from mrisr_tpu_torch.ops.bias_residual import (
    bias_residual,
    gated_residual,
    gated_residual_plain,
)
from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8_plain, pack_conv
from mrisr_tpu_torch.ops.layernorm import (
    layernorm_modulate,
    layernorm_modulate_plain,
)
from mrisr_tpu_torch.serve.quant_diffusion import (
    DIT,
    FastDDPMForward,
    calibrate_fastddpm,
    deep_sites,
    int8_forward,
    network,
    quantize_fastddpm,
)
from mrisr_tpu_torch.utils.profiling import RECORDER
from portbench.families.fastddpm_dit import _rule
from portbench.reference import counts, counts_dit
from portbench.reference import fastddpm_dit as ref
from portbench.reference.unet import Quantizer
from portbench.weights import draw

HIDDEN, DEPTH, HEADS, HW, BATCH = 64, 2, 4, 64, 2
PUBLISHED = 673_995_008
# int8_deep (the 8 block linears) against the float32 reference at the
# first sampler step: 0.0063 measured; an emulation with every linear in
# int8 (the time MLP, the adaLN linears and the final layer too) reads
# 0.0154 even at scales taken from its own input.  The budget sits between.
INT8_BUDGET = 0.01


def _at_small_size(mp):
    """The port's DiT at the tests' depth, heads and input size: the
    module constants that the constructor and the int8 forward read."""
    mp.setattr(dit, "DEPTH", DEPTH)
    mp.setattr(dit, "HEADS", HEADS)
    mp.setattr(dit, "INPUT_SIZE", HW)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """Two threads; the small size."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    _at_small_size(monkeypatch)
    yield
    torch.set_num_threads(n)


def _weights(seed=11):
    shapes = ref.param_shapes(HIDDEN, DEPTH)
    w = draw(shapes, _rule(shapes), seed, torch.device("cpu"))
    w["pos_embed"] = ref.pos_embed(HIDDEN, HW // 8)
    return w


@pytest.fixture(scope="module")
def seeded():
    """The benchmark's seeded weights at the small size, the port's model
    holding them and its flax-layout tree."""
    w = _weights()
    with pytest.MonkeyPatch.context() as mp:
        _at_small_size(mp)
        model = DiT(hidden=HIDDEN).eval()
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
    with pytest.MonkeyPatch.context() as mp:
        _at_small_size(mp)
        calib = calibrate_fastddpm({"params": params}, sched, [cond],
                                   dtype=torch.float32)
    x = torch.randn((BATCH, HW, HW, 3), generator=g)
    t = torch.full((BATCH,), int(sched.timesteps[-1]))
    q = quantize_fastddpm({"params": params}, calib,
                          only=deep_sites(params))
    return calib, q, x, t


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_num_parameters_published():
    """673,995,008 trainable at DiT-XL/8's widths, 3 in and 2 out, by the
    port and by the reference; 23,905,152 a block; a built model holds
    its shapes' count, with ``pos_embed`` a buffer apart."""
    assert dit.num_parameters(1152, 28) == ref.num_parameters() == PUBLISHED
    per_block = sum(math.prod(s) for k, s in ref.param_shapes().items()
                    if k.startswith("blocks.0."))
    assert per_block == 23_905_152
    model = DiT(hidden=HIDDEN)
    assert sum(p.numel() for p in model.parameters()) == \
        dit.num_parameters(HIDDEN, DEPTH) == ref.num_parameters(HIDDEN, DEPTH)
    assert param_count(model.state_dict()) == param_count(model)
    assert tuple(model.pos_embed.shape) == (1, (HW // 8) ** 2, HIDDEN)
    assert "pos_embed" not in dict(model.named_parameters())


def test_state_dict_keys_are_dits():
    """The state dict is DiT's without its class embedder, name for name
    and shape for shape, ``pos_embed`` included."""
    sd = DiT(hidden=HIDDEN).state_dict()
    want = dict(ref.param_shapes(HIDDEN, DEPTH))
    want["pos_embed"] = (1, (HW // 8) ** 2, HIDDEN)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    for k in ("x_embedder.proj.weight", "t_embedder.mlp.0.weight",
              "t_embedder.mlp.2.bias", "blocks.1.attn.qkv.weight",
              "blocks.1.attn.proj.bias", "blocks.0.mlp.fc1.weight",
              "blocks.0.mlp.fc2.weight", "blocks.1.adaLN_modulation.1.weight",
              "final_layer.linear.weight",
              "final_layer.adaLN_modulation.1.bias"):
        assert k in sd, k


def test_registry_and_preset():
    """``fastddpm_dit`` is a diffusion model of the registry with two
    outputs (the noise and the learned variance); its preset is DiT-XL/8's
    width with the other sampler cells' schedule: linear betas over 1000
    steps, 10 steps of 'nonuniform-4060'."""
    assert TRAINABLE["fastddpm_dit"] == "diffusion"
    cfg = PRESETS["fastddpm_dit"].model
    assert (cfg.base_features, cfg.time_dim, cfg.beta_schedule,
            cfg.num_timesteps, cfg.num_inference_steps,
            cfg.timestep_selection) == (1152, 1152, "linear", 1000, 10,
                                        "nonuniform-4060")
    model, kind = init_model("fastddpm_dit", dataclasses.replace(
        cfg, base_features=HIDDEN, time_dim=HIDDEN))
    assert kind == "diffusion" and isinstance(model, DiT)
    assert model.final_layer.linear.out_features == 8 * 8 * 2
    assert len(model.blocks) == DEPTH and model.heads == HEADS


def test_pos_embed_on_a_2x2_grid():
    """DiT's table by hand on a 2 x 2 grid of 8 channels: the first four
    channels encode the token's column, ``[sin(w), sin(w / 100), cos(w),
    cos(w / 100)]``, the last four its row; tokens row-major."""
    s1, c1 = math.sin(1.0), math.cos(1.0)
    s2, c2 = math.sin(0.01), math.cos(0.01)
    want = torch.tensor([
        [0, 0, 1, 1, 0, 0, 1, 1],           # row 0, column 0
        [s1, s2, c1, c2, 0, 0, 1, 1],       # row 0, column 1
        [0, 0, 1, 1, s1, s2, c1, c2],       # row 1, column 0
        [s1, s2, c1, c2, s1, s2, c1, c2],   # row 1, column 1
    ], dtype=torch.float32)
    torch.testing.assert_close(dit.pos_embed_table(8, 2), want, rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(ref.pos_embed(8, 2)[0], want, rtol=0,
                               atol=1e-7)
    assert torch.equal(dit.pos_embed_table(1152, 32),
                       ref.pos_embed(1152, 32)[0])


@pytest.mark.parametrize("heads", [1, 4, 16])
def test_timm_qkv_order_matches_a_per_head_loop(heads):
    """``qkv_attention(..., 'timm')`` against timm's order done head by
    head: head ``i`` takes channels ``[i ch, (i + 1) ch)`` of each third
    of the qkv Linear as its q, k and v, ``softmax(q k^T ch^-1/2) v``, and
    writes channels ``[i ch, (i + 1) ch)``: float32 rounding (1e-5)."""
    ch, t, b = 8, 24, 2
    c = heads * ch
    g = torch.Generator().manual_seed(heads)
    qkv = torch.randn((b, t, 3 * c), generator=g)
    outs = []
    for i in range(heads):
        q, k, v = (qkv[..., j * c + i * ch:j * c + (i + 1) * ch]
                   for j in range(3))
        a = torch.softmax(q @ k.transpose(1, 2) * ch ** -0.5, dim=-1)
        outs.append(a @ v)
    want = torch.cat(outs, dim=-1)
    before = qkv_attention.calls_float
    got = qkv_attention(qkv, heads, "timm")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert qkv_attention.calls_float == before + 1
    with pytest.raises(ValueError, match="order"):
        qkv_attention(qkv, heads, "heads_first")


def test_float32_forward_matches_reference(seeded):
    """The module and ``FastDDPMForward``'s float walk in float32, both
    output channels, against the plain reference: float32 rounding alone,
    within 1e-5, at t 999 and 0; the walk against the module too."""
    w, model, params = seeded
    g = torch.Generator().manual_seed(5)
    x = torch.randn((BATCH, HW, HW, 3), generator=g)
    fwd = FastDDPMForward(params, dtype=torch.float32, device="cpu")
    for tv in (999, 0):
        t = torch.full((BATCH,), tv)
        with torch.no_grad():
            want = ref.denoiser(w, x, t, heads=HEADS)
            got = model(x, t)
        walk = fwd(x, t)
        assert got.shape == want.shape == walk.shape == (BATCH, HW, HW, 2)
        assert _rel(got, want) < 1e-5
        assert _rel(walk, want) < 1e-5
        assert _rel(walk, got) < 1e-5


def test_layernorm_plain_matches_direct_formula():
    """Kernel L's plain version against ``F.layer_norm(eps=1e-6) (1 +
    scale) + shift`` in float64 (float32 rounding, 2e-6), and its codes
    against the direct formula's, equal wherever that formula is not
    within 1e-3 of a rounding boundary; bf16 x in, bf16 out within one
    rounding; the rows read through a strided view."""
    g = torch.Generator().manual_seed(7)
    b, t, c = 2, 16, 64
    x = (torch.randn((b, t, c), generator=g) * 3 + 0.5).to(torch.bfloat16)
    mods = torch.randn((b, 6 * c), generator=g) * 0.5
    ss = mods[:, 3 * c:5 * c]  # a block's (shift2, scale2): a strided view
    xd = x.double()
    norm = F.layer_norm(xd, (c,), eps=1e-6)
    want = (norm * (1 + ss[:, None, c:].double())
            + ss[:, None, :c].double())
    got = layernorm_modulate(x.float(), ss, eps=1e-6)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-6)
    bf = layernorm_modulate(x, ss, eps=1e-6)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, layernorm_modulate_plain(x, ss, eps=1e-6))
    assert (bf.double() - want).abs().le(want.abs() * 2 ** -8 + 1e-6).all()
    a = torch.tensor([0.03])
    codes = layernorm_modulate(x, ss, eps=1e-6, quant_scale=a)
    direct = want / 0.03
    far = ((direct - direct.floor() - 0.5).abs() > 1e-3) | \
        (direct.abs() > 127.5)
    want_codes = direct.round().clamp(-127, 127).to(torch.int8)
    assert codes.dtype == torch.int8
    assert torch.equal(codes[far], want_codes[far])
    assert far.float().mean() > 0.99
    assert layernorm_modulate.launches == 0  # the CPU runs no kernel


def test_gelu_form_plain_matches_direct_formula():
    """Kernel A's GELU form, plain version: the codes of ``0.5 y (1 +
    tanh(sqrt(2 / pi) (y + 0.044715 y^3)))`` at the next site's scale,
    ``y`` the float epilogue, equal to the direct formula in float64
    wherever it is not within 1e-3 of a rounding boundary."""
    g = torch.Generator().manual_seed(9)
    n, ci, co = 2, 32, 48
    x = torch.randint(-127, 128, (n, 4, 4, ci), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (1, 1, ci, co), generator=g,
                      dtype=torch.int8)
    s = torch.rand(co, generator=g) * 1e-4
    b = torch.randn(co, generator=g) * 0.1
    a = torch.tensor([0.01])
    codes = conv2d_int8_plain(x, pack_conv(w), s, b, relu=False,
                              gelu_scale=a)
    y = conv2d_int8_plain(x, pack_conv(w), s, b, relu=False,
                          out_float=True).double()
    gelu = 0.5 * y * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (y + 0.044715 * y ** 3)))
    direct = gelu / 0.01
    far = (direct - direct.floor() - 0.5).abs() > 1e-3
    want = direct.round().clamp(-127, 127).to(torch.int8)
    assert codes.dtype == torch.int8 and codes.shape == (n, 4, 4, co)
    assert torch.equal(codes[far], want[far]) and far.float().mean() > 0.99
    with pytest.raises(ValueError, match="GELU"):
        from mrisr_tpu_torch.ops.conv_int8 import conv2d_int8
        conv2d_int8(x, pack_conv(w), s, b, relu=True, gelu_scale=a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_residual_plain_matches_direct_formula(dtype):
    """Kernel E's gated form, plain version: ``x + gate[b] * y`` in place,
    the product and the sum float32 roundings, then x's type; the gate
    read through a strided view of the adaLN rows; E's other counters
    untouched."""
    g = torch.Generator().manual_seed(13)
    b, t, c = 2, 8, 32
    x = torch.randn((b, t, c), generator=g).to(dtype)
    y = torch.randn((b, t, c), generator=g)
    mods = torch.randn((b, 6 * c), generator=g)
    gate = mods[:, 2 * c:3 * c]
    want = (x.float() + gate[:, None, :] * y).to(dtype)
    before = (bias_residual.launches, bias_residual.launches_gate)
    out = gated_residual(x, gate, y)
    assert out.data_ptr() == x.data_ptr() and torch.equal(x, want)
    assert (bias_residual.launches, bias_residual.launches_gate) == before
    x2 = torch.randn((b, t, c), generator=g).to(dtype)
    assert torch.equal(gated_residual_plain(x2.clone(), gate, y),
                       (x2.double() + (gate[:, None, :] * y).double())
                       .float().to(dtype))


def _served(w, calib, x, t, sites, row=1):
    """The reference served by the port's tables: ``sites`` in int8 at
    the port's per-step activation scales (``row`` 1, t = 999: the
    schedule's last row) with int8 weights per output row, every other
    leaf the bundle's bf16 copy."""
    leaves = {f"{n}.{leaf}" for n in sites for leaf in ("weight", "bias")}
    w_tables = {k: v if k in leaves else v.to(torch.bfloat16).float()
                for k, v in w.items()}
    quant = Quantizer(8, sites)
    for name in sites:
        quant.absmax[(name, 0)] = float(calib[name.replace(".", "/")][row])
    quant.recording = False
    with torch.no_grad():
        return ref.denoiser(w_tables, x, t, quant, heads=HEADS)


def test_int8_deep_forward_matches_reference_emulation(seeded, tables):
    """int8_deep (the 8 block linears; L, A with its GELU form, the
    quantizer and E as their plain versions) against the reference served
    by the same tables, both channels: 1.7e-7 measured, where the
    emulation at the wrong per-step scales (row 0, t = 0) reads 7.7e-3 from
    it, so the port must stay 50 times nearer than that.  Within the int8
    budget of the float32 reference, which an emulation with every linear
    in int8 fails."""
    w, _, params = seeded
    calib, q, x, t = tables
    deep = ref.deep_sites(DEPTH)
    assert len(q["int8"]) == 4 * DEPTH
    assert sorted(n.replace(".", "/") for n in deep) == sorted(q["int8"])
    assert all(tuple(lq["w_int8"].shape[:2]) == (1, 1)
               for lq in q["int8"].values())
    with torch.no_grad():
        want = ref.denoiser(w, x, t, heads=HEADS)
    emulated = _served(w, calib, x, t, deep)
    got = int8_forward(q, dtype=torch.float32, device="cpu")(x, t)
    assert _rel(got, emulated) * 50 < _rel(
        _served(w, calib, x, t, deep, row=0), emulated)
    assert _rel(got, want) < INT8_BUDGET
    every = tuple(k[:-len(".weight")] for k, v in w.items()
                  if k.endswith(".weight") and v.dim() == 2)
    assert len(every) == 7 * DEPTH
    quant = Quantizer(8, every)
    with torch.no_grad():
        ref.denoiser(w, x, t, quant, heads=HEADS)  # scales from this input
        quant.recording = False
        assert _rel(ref.denoiser(w, x, t, quant, heads=HEADS),
                    want) > INT8_BUDGET


@pytest.mark.parametrize("sites", [
    ("blocks.0.attn.qkv",),  # L's codes, A's float32 out
    ("blocks.0.attn.proj",),  # the quantizer on the attention's output
    ("blocks.1.mlp.fc1",),  # L's codes, A's float out, torch's GELU
    ("blocks.1.mlp.fc2",),  # the quantizer on torch's GELU
    ("blocks.0.mlp.fc1", "blocks.0.mlp.fc2"),  # A's GELU form: fc2's codes
    ("blocks.1.mlp.fc1", "blocks.1.mlp.fc2"),
])
def test_int8_deep_site_matches_reference_emulation(seeded, tables, sites):
    """One linear (or an fc1-fc2 pair, A's GELU form) at a time in int8,
    the rest float from the bundle's bf16 copies, against the reference
    served by the same tables.  A site reads the emulation to float32
    rounding (1.7e-7 measured, where the site served in float reads 1.4e-3
    to 4.1e-3 from it), or a few codes a boundary apart (block 1's fc2
    alone, 3.9e-5: the emulation divides by its scale in float64).  So the
    port must stay within a tenth of the float-served site's distance."""
    w, _, params = seeded
    calib, _, x, t = tables
    q = quantize_fastddpm({"params": params}, calib,
                          only=[s.replace(".", "/") for s in sites])
    emulated = _served(w, calib, x, t, sites)
    floated = _rel(FastDDPMForward(q["params"], dtype=torch.float32,
                                   device="cpu")(x, t), emulated)
    got = int8_forward(q, dtype=torch.float32, device="cpu")(x, t)
    assert _rel(got, emulated) < floated / 10


def _visits(q, x, t):
    """One int8_deep call with kernel A's and L's plain versions
    recorded: each launch's site as ``counts_dit`` reckons it."""
    fwd = int8_forward(q, dtype=torch.bfloat16, device="cpu")
    conv8, ln8 = fwd._conv8, fwd._ln8
    seen = {"kernel_a": [], "kernel_l": []}

    def a(xq, wp, s, b, **kw):
        n, h, _, ci = xq.shape
        out = 1 if kw.get("gelu_scale") is not None else 4
        seen["kernel_a"].append(counts.conv_site(
            "", n, h, ci, wp.shape[0], wp.shape[1], out)[1:])
        return conv8(xq, wp, s, b, **kw)

    def ln(h, ss, **kw):
        n, hh, ww, c = h.shape
        seen["kernel_l"].append(counts_dit.l_site(
            "", n, hh * ww, c, kw.get("quant_scale") is not None)[1:])
        return ln8(h, ss, **kw)

    fwd._conv8, fwd._ln8 = a, ln
    return fwd(x, t), seen


def test_family_sites_are_the_sites_a_call_visits(tables):
    """The benchmark's counts (``counts_dit.kernel_sites``) list every
    launch one int8_deep denoiser call makes: 4 a block of kernel A (fc1's
    GELU form writing codes), 2 a block and the final layer's of kernel L
    (codes at the block's, bf16 at the final layer), shape for shape; a
    slice's int8 operations are the call's over its rows."""
    _, q, x, t = tables
    _, seen = _visits(q, x, t)
    sites = counts_dit.kernel_sites(BATCH, HW, HIDDEN, DEPTH)
    for kernel in ("kernel_a", "kernel_l"):
        assert sorted(seen[kernel]) == sorted(s[1:] for s in sites[kernel])
    assert (len(seen["kernel_a"]), len(seen["kernel_l"])) == (
        4 * DEPTH, 2 * DEPTH + 1)
    ops = counts_dit.model_ops(HW, HIDDEN, DEPTH, steps=1)
    deep = sum(o for _, o, _, p in ops if p == counts.PEAK_INT8_OPS)
    assert deep == sum(s[1] for s in sites["kernel_a"]) / BATCH


def _counted_call(fwd, x, t):
    """One call of ``fwd`` with its kernels' launches counted at the plain
    versions: A (and its GELU form), L (and with codes), the quantizer,
    E's gated form and the attention cores."""
    seen = collections.Counter()

    def count(key, fn, flag=None):
        def wrapped(*args, **kw):
            seen[key] += 1
            if flag and kw.get(flag) is not None:
                seen[f"{key}_{flag}"] += 1
            return fn(*args, **kw)
        return wrapped

    fwd._conv8 = count("a", fwd._conv8, "gelu_scale")
    fwd._ln8 = count("l", fwd._ln8, "quant_scale")
    fwd._q8 = count("q", fwd._q8)
    fwd._gate8 = count("e", fwd._gate8)
    before = qkv_attention.calls_fused + qkv_attention.calls_float
    fwd(x, t)
    seen["attn"] = qkv_attention.calls_fused + qkv_attention.calls_float \
        - before
    return seen


def test_launches_and_spans_of_a_call(tables):
    """One int8_deep call, counted at the plain versions: A 4 a block (1
    GELU), L 2 a block and 1 (codes at the blocks'), the quantizer 1 a
    block (proj), E's gated form 2 a block, one attention core a block;
    under a profiler ``ddpm.attn`` and ``dit.mlp`` once a block and
    ``dit.modulate`` 4 a block and once more (each L and each gated
    residual)."""
    _, q, x, t = tables
    fwd = int8_forward(q, dtype=torch.bfloat16, device="cpu")
    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        seen = _counted_call(fwd, x, t)
    spans = collections.Counter(s.name for s in RECORDER.spans())
    RECORDER.clear()
    assert seen == {"a": 4 * DEPTH, "a_gelu_scale": DEPTH,
                    "l": 2 * DEPTH + 1, "l_quant_scale": 2 * DEPTH,
                    "q": DEPTH, "e": 2 * DEPTH, "attn": DEPTH}
    assert (spans["ddpm.attn"], spans["dit.mlp"], spans["dit.modulate"]) == (
        DEPTH, DEPTH, 4 * DEPTH + 1)


def test_chip_smoke_dit_counts_are_a_calls(tables):
    """chip_smoke.py's counts of one DiT-XL/8 int8_deep call (112 A, 28 of
    them GELU; 57 L, 56 emitting codes; 28 quantizer launches; 56 gated
    E; 28 attention cores) are what a call launches at the published
    depth: the small call's per block, the final layer's L once."""
    import chip_smoke

    _, q, x, t = tables
    seen = _counted_call(int8_forward(q, dtype=torch.bfloat16, device="cpu"),
                         x, t)
    depth = ref.DEPTH
    per_block = {k: (v - (k == "l")) // DEPTH for k, v in seen.items()}
    assert (chip_smoke.DIT_A, chip_smoke.DIT_GELU, chip_smoke.DIT_L,
            chip_smoke.DIT_L_CODES, chip_smoke.DIT_QUANT, chip_smoke.DIT_GATE,
            chip_smoke.DIT_ATTN) == (
        depth * per_block["a"], depth * per_block["a_gelu_scale"],
        depth * per_block["l"] + 1, depth * per_block["l_quant_scale"],
        depth * per_block["q"], depth * per_block["e"],
        depth * per_block["attn"]) == (112, 28, 57, 56, 28, 56, 28)
    sites = counts_dit.kernel_sites(32)
    assert (len(sites["kernel_a"]), len(sites["kernel_l"])) == (
        chip_smoke.DIT_A, chip_smoke.DIT_L)


def test_network_is_told_apart(seeded):
    """``network`` reads DiT's tree as DiT: its time MLP, its 'adm'
    sinusoids, its width; the dense sites kernel A runs are the block
    linears alone; its patch embedding is strided."""
    _, _, params = seeded
    desc = network(params)
    assert desc is DIT and desc.t_embed == "adm"
    assert (desc.time_dim(params), desc.base_features(params)) == (HIDDEN,
                                                                   HIDDEN)
    assert desc.dense_on_a and desc.deep("blocks/1/mlp/fc2")
    assert not desc.deep("blocks/1/adaLN_modulation/1")
    assert not desc.deep("final_layer/linear")
    assert desc.strided("x_embedder/proj")
    calib = {name: np.ones(2, np.float32) for name in deep_sites(params)}
    assert set(quantize_fastddpm({"params": params}, calib)["int8"]) == \
        set(deep_sites(params))


def test_trainer_trains_dit():
    """``train --preset fastddpm_dit`` builds DiT through the registry
    and one train step at the small size runs and moves the weights."""
    from mrisr_tpu_torch.train.diffusion import DiffusionTrainer

    cfg = PRESETS["fastddpm_dit"]
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, base_features=HIDDEN, time_dim=HIDDEN))
    tr = DiffusionTrainer(cfg, device="cpu")
    module = tr.state.module
    assert type(module) is DiT and len(module.blocks) == DEPTH
    before = [p.detach().clone() for p in module.parameters()]
    batch = torch.rand((2, 32, 32, 3), generator=torch.Generator()
                       .manual_seed(33))
    metrics = tr._train(batch, tr._generator(0, True, 0))
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, module.parameters()))


def test_bundle_serves_through_the_normal_path(tmp_path):
    """``export_serving_bundle(model_name='fastddpm_dit',
    quant='int8_deep')`` from a checkpoint, then ``engine_from_bundle``:
    the ancestral sampler over the bundle's 8 int8 linears, reading the
    noise channel."""
    from mrisr_tpu_torch.serve.bundle import (
        _reflatten_int8_sites,
        engine_from_bundle,
        export_serving_bundle,
        load_bundle,
        make_bundle_apply,
    )

    cfg = dataclasses.replace(PRESETS["fastddpm_dit"].model,
                              base_features=HIDDEN, time_dim=HIDDEN,
                              num_inference_steps=2)
    model, _ = init_model("fastddpm_dit", cfg, seed=4)
    torch.save({"model_state_dict": model.state_dict()},
               tmp_path / "fastddpm_dit_best.pt")
    cond = np.random.default_rng(0).random((2, HW, HW, 2), np.float32)
    path = export_serving_bundle(
        str(tmp_path / "b"), model_name="fastddpm_dit",
        models_dir=str(tmp_path), quant="int8_deep",
        calibration_batches=[cond], cfg=cfg, image_size=(HW, HW),
        device="cpu")
    params, meta = load_bundle(path)
    assert (meta["kind"], meta["base_features"], meta["time_dim"]) == (
        "diffusion", HIDDEN, HIDDEN)
    assert len(_reflatten_int8_sites(params["int8"])) == 4 * DEPTH
    with engine_from_bundle(path, batch_size=2, device="cpu") as eng:
        y = eng.predict(cond[0])
    assert y.shape == (HW, HW, 1) and np.isfinite(y).all()
    got = make_bundle_apply(params, meta, "cpu")(torch.from_numpy(cond))
    assert got.shape == (2, HW, HW, 1)
    np.testing.assert_allclose(y, got[0].numpy(), rtol=0, atol=1e-5)
