"""Post-training int8 quantization of the Fast-DDPM sampling path
(counterpart: ``mrisr_tpu/serve/quant_diffusion.py``).

The scheme and the table format are the reference's, so tables and the
bundles that carry them move between the packages:

- weights per output channel, symmetric int8 (absmax / 127), HWIO;
- activations: one scale per conv input **per inference step**, from the
  absmax (or an |x| percentile) over the real sampling trajectory
  (:func:`calibrate_fastddpm`); the forward maps its ``t`` to the
  schedule row with ``searchsorted`` on the device;
- GroupNorm, SiLU, the time MLP and the unquantized sites stay in the
  float ``dtype``; ``quantize_fastddpm(only=DEEP_SITES)`` quantizes the
  16 sites at <= 128^2 (``int8_deep``).

The forward works on the flax-layout param tree (the bundle's), keeps
activations NHWC (channels_last for the float convs) and runs every int8
conv site through kernel A (``ops/conv_int8.py``, float epilogue
``acc * a_scale[row] * w_scale + bias``), the int8 upconv3/upconv2 through
kernel B's float mode (``ops/upconv.py``), and, with ``gn_impl='fused'``,
every GroupNorm + SiLU through K3 (``ops/groupnorm.py``): K3 emits what the
next conv reads, the int8 codes where that conv is quantized, else the
forward's float ``dtype``.  K3 rounds once, after SiLU (``bf16(silu(y))``);
the chain ('chain', the JAX package's 'xla') rounds the normalized value
before SiLU too (``silu(bf16(y))``).  Both take float32 statistics and hand
the conv its input in ``dtype``; in bf16 they differ by about one bf16
rounding an element, K3 as a rule the nearer to the float32 forward.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mrisr_tpu_torch.ckpt.from_jax import DIFFUSION_BLOCKS
from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.models.diffusion import (
    GN_EPS,
    DiffusionSchedule,
    num_groups,
    timestep_embedding,
)
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv2d_int8_plain,
    pack_conv,
)
from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_plain
from mrisr_tpu_torch.ops.upconv import (
    pack_upconv,
    upconv2x2_int8,
    upconv2x2_int8_plain,
)
from mrisr_tpu_torch.serve.quant import (
    _abs_percentile,
    _quantize_conv,
    quant_input,
)
from mrisr_tpu_torch.utils.profiling import span

UPCONVS = ("upconv3", "upconv2", "upconv1")

# the conv sites at <= 128^2 spatial size: the reference's int8_deep set
DEEP_SITES = (
    "enc2/conv1", "enc2/conv2", "enc2/skip",
    "enc3/conv1", "enc3/conv2", "enc3/skip",
    "bottleneck/conv1", "bottleneck/conv2",
    "upconv3", "dec3/conv1", "dec3/conv2", "dec3/skip",
    "upconv2", "dec2/conv1", "dec2/conv2", "dec2/skip",
)
GN_IMPLS = ("chain", "fused")
# the most pixels in one partial sum of gn_silu_chain's statistics: short
# enough that torch's CUDA reduction sums each partial in one thread
_PART = 255


def default_gn_impl(device: torch.device) -> str:
    """'fused' on the card, 'chain' on the CPU.

    The JAX package defaults to its XLA chain because on the TPU a Pallas
    call is pinned to one layout while XLA's int8 convs wanted a
    batch-inner one, so fusing cost a full-tensor transpose on each side
    of every site.  Here there is no such conflict: K3 writes the NHWC
    int8 codes that kernel A reads next, or the NHWC float activation a
    float conv reads, in the same layout.  On the CPU
    K3 is its plain version, slower than the chain and no closer to the
    reference, so the chain stays."""
    return "fused" if device.type == "cuda" else "chain"


def _group_sums(v: torch.Tensor, groups: int) -> torch.Tensor:
    """Per (row, group) sums of ``v`` ``(B, HW, C)``, each row summed the
    same way at any row count: partial sums over ``k`` pixels (the largest
    divisor of HW up to ``_PART``), then each group's sum of those.  Torch's
    CUDA reduction splits a long sum across blocks by the number of
    outputs, so one reduction over (HW, C / groups) gives a row other bits
    at 4 rows than at 8; a sum this short stays in one thread (the
    partials) or one warp (a group's), whatever the rows."""
    b, hw, c = v.shape
    k = max(d for d in range(1, min(hw, _PART) + 1) if hw % d == 0)
    part = v.reshape(b, hw // k, k, c).sum(dim=2)
    return part.reshape(b, -1, groups, c // groups).sum(dim=(1, 3))


def gn_silu_chain(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  groups: int, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.GroupNorm`` then SiLU, on NHWC: float32 statistics with
    the biased variance E[x^2] - E[x]^2 (clamped at 0), the normalized
    value cast to ``dtype``, SiLU in ``dtype``.  The JAX package's 'xla'
    path.  A row's statistics, and so its output, do not depend on the
    rows beside it (:func:`_group_sums`): a data-parallel replica answers
    as the single engine does."""
    b, hh, ww, c = h.shape
    xf = h.reshape(b, hh * ww, c).float()
    n = hh * ww * (c // groups)
    mean = _group_sums(xf, groups) / n
    var = torch.clamp_min(_group_sums(xf * xf, groups) / n - mean * mean,
                          0.0)
    xf = xf.reshape(b, hh * ww, groups, c // groups)
    mul = torch.rsqrt(var + GN_EPS)[..., None] * gamma.reshape(groups, -1)
    y = (xf - mean[:, None, :, None]) * mul[:, None] + beta.reshape(groups, -1)
    return F.silu(y.to(dtype).reshape(b, hh, ww, c))


def _nchw(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 3, 1, 2)


def _nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1)


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    n, hh, ww, c = h.shape
    return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _absmax(a: torch.Tensor) -> torch.Tensor:
    return a.abs().amax().float()


class _PreQuant(NamedTuple):
    """An activation K3 already emitted as int8 codes."""

    q: torch.Tensor


class _QSite:
    """One int8 site's tables on the device: per-step rows (R = steps) or
    one row (a static calibration)."""

    def __init__(self, name: str, lq: Dict, per_step: bool, device):
        a = lq["a_scale"].float()
        if per_step:
            s = a[:, None] * lq["w_scale"].float()[None, :]
        else:
            a, s = a.reshape(1), lq["scale"].float().reshape(1, -1)
        bias = lq["bias"].float()
        self.per_step = per_step
        self.a = a.to(device)
        if name.startswith("upconv"):
            w2, _, b4 = pack_upconv(lq["w_int8"], s[0], bias)
            self.w = w2.t().to(device).t()
            self.s = s.repeat(1, 4).contiguous().to(device)
            self.b = b4.to(device)
        else:
            self.w = pack_conv(lq["w_int8"]).to(device)
            self.s = s.contiguous().to(device)
            self.b = bias.contiguous().to(device)

    def scales(self, row: torch.Tensor, zero: torch.Tensor):
        """(activation scale (1,), dequant factors) of this step's row."""
        r = row if self.per_step else zero
        return self.a.index_select(0, r), self.s.index_select(0, r).reshape(-1)


class _Step:
    """What one forward call threads through the layers."""

    def __init__(self, row, zero, t_emb, stats, stat_fn):
        self.row, self.zero, self.t_emb = row, zero, t_emb
        self.stats, self.stat_fn = stats, stat_fn


class FastDDPMForward:
    """The FastDDPMUNet forward of a flax-layout param tree, prepared once
    for ``device``: ``(B, H, W, 3) + (B,) t -> (B, H, W, 1)`` float32.

    ``sites`` (``quantize_fastddpm``'s ``int8`` tables) makes those sites
    int8, with ``timesteps`` for per-step tables; without them it is the
    float forward in ``dtype``.  ``gn_impl``: 'chain' or 'fused'
    (:func:`default_gn_impl` when None).  ``plain=True`` runs the kernels'
    plain versions even on the card (the reference the kernels are held
    against).

    Spans (``utils/profiling.py:span``): ``ddpm.gn_chain`` around each
    GroupNorm + SiLU that feeds a float conv (a float site), whatever
    implements it, with its device time; host-only, ``ddpm.k3`` around
    each K3 call (inside the ``ddpm.gn_chain`` at a float site),
    ``ddpm.conv_int8`` (kernel A) and
    ``ddpm.conv_float`` (cuDNN) around each conv, ``ddpm.upconv`` around
    each upconv."""

    def __init__(self, params: Dict, sites: Optional[Dict] = None,
                 timesteps=None, *, dtype=torch.bfloat16, time_dim: int = 128,
                 gn_impl: Optional[str] = None, device: DeviceLike = None,
                 plain: bool = False):
        device = resolve_device(device)
        gn_impl = default_gn_impl(device) if gn_impl is None else gn_impl
        if gn_impl not in GN_IMPLS:
            raise ValueError(f"gn_impl must be one of {GN_IMPLS}, got "
                             f"{gn_impl!r}")
        self.device, self.dtype, self.time_dim = device, dtype, time_dim
        self.fused = gn_impl == "fused"
        self._conv8 = conv2d_int8_plain if plain else conv2d_int8
        self._up8 = upconv2x2_int8_plain if plain else upconv2x2_int8
        self._gn8 = groupnorm_silu_plain if plain else groupnorm_silu
        sites = sites or {}
        per_step = any(lq["a_scale"].dim() for lq in sites.values())
        if per_step and timesteps is None:
            raise ValueError(
                "per-step a_scale tables need the 'timesteps' lookup row in "
                "the qtree (quantize_fastddpm keeps it when the calibration "
                "came from calibrate_fastddpm)")
        self.timesteps = (None if timesteps is None else torch.as_tensor(
            timesteps).to(device=device, dtype=torch.int64))
        self.q = {name: _QSite(name, lq, lq["a_scale"].dim() > 0, device)
                  for name, lq in sites.items()}

        def f(v, dt=dtype):
            return v.to(device=device, dtype=dt)

        self.dense = {}
        for key, p in (("Dense_0", params["time_emb"]["Dense_0"]),
                       ("Dense_1", params["time_emb"]["Dense_1"])):
            self.dense[key] = (f(p["kernel"]).t(), f(p["bias"]))
        self.norms, self.convs = {}, {}
        for blk in DIFFUSION_BLOCKS:
            p = params[blk]
            self.dense[blk] = (f(p["time_fc"]["kernel"]).t(),
                               f(p["time_fc"]["bias"]))
            for norm in ("norm1", "norm2"):
                self.norms[f"{blk}/{norm}"] = (
                    f(p[norm]["scale"], torch.float32),
                    f(p[norm]["bias"], torch.float32))
            for conv in ("conv1", "conv2", "skip"):
                if conv in p:
                    self._float_conv_weights(f"{blk}/{conv}", p[conv], f)
        self.has_skip = {blk: "skip" in params[blk] for blk in DIFFUSION_BLOCKS}
        self.norms["final_norm"] = (
            f(params["final_norm"]["scale"], torch.float32),
            f(params["final_norm"]["bias"], torch.float32))
        for name in ("init_conv", "final_conv"):
            self._float_conv_weights(name, params[name], f)
        self.upconvs = {}
        for name in UPCONVS:
            if name not in self.q:
                k = params[name]["kernel"]
                self.upconvs[name] = (f(k.flip(0, 1).permute(2, 3, 0, 1))
                                      .contiguous(), f(params[name]["bias"]))

    def _float_conv_weights(self, name, p, f):
        if name in self.q:
            return
        w = f(p["kernel"].permute(3, 2, 0, 1)).contiguous(
            memory_format=torch.channels_last)
        self.convs[name] = (w, f(p["bias"]), w.shape[-1] // 2)

    # ------------------------------------------------------------- layers
    def _record(self, st: _Step, name: str, h) -> None:
        if st.stats is not None:
            v = st.stat_fn(h)
            st.stats[name] = (torch.maximum(st.stats[name], v)
                              if name in st.stats else v)

    def _conv(self, st: _Step, name: str, h) -> torch.Tensor:
        lq = self.q.get(name)
        if isinstance(h, _PreQuant):  # K3 already emitted the codes
            self._record(st, name, h.q)
            q = h.q
            s = lq.scales(st.row, st.zero)[1]
        else:
            self._record(st, name, h)
            if lq is None:  # not quantized: a float conv in dtype
                w, b, pad = self.convs[name]
                with span("ddpm.conv_float"):
                    return _nhwc(F.conv2d(_nchw(h.to(self.dtype)), w, b,
                                          padding=pad))
            a, s = lq.scales(st.row, st.zero)
            q = quant_input(h, a)
        with span("ddpm.conv_int8"):
            y = self._conv8(q.contiguous(), lq.w, s, lq.b, relu=False,
                            out_float=True)
            return y.to(self.dtype)

    def _upconv(self, st: _Step, name: str, h: torch.Tensor) -> torch.Tensor:
        self._record(st, name, h)
        lq = self.q.get(name)
        with span("ddpm.upconv"):
            if lq is None:
                w, b = self.upconvs[name]
                return _nhwc(F.conv_transpose2d(_nchw(h.to(self.dtype)), w,
                                                b, stride=2))
            a, s = lq.scales(st.row, st.zero)
            y = self._up8(quant_input(h, a).contiguous(), lq.w, s, lq.b,
                          out_float=True)
            return y.to(self.dtype)

    def _act(self, st: _Step, site: str, norm: str, h: torch.Tensor):
        """GroupNorm + SiLU feeding conv ``site``.  'fused': K3 at every
        site, emitting what that conv reads: int8 codes (its per-step
        activation scale) where it is quantized, else ``dtype``, rounded
        once after SiLU.  'chain': :func:`gn_silu_chain`, which rounds to
        ``dtype`` before SiLU too; the quantizer of an int8 conv follows
        in :meth:`_conv`."""
        gamma, beta = self.norms[norm]
        groups = num_groups(h.shape[-1])
        lq = self.q.get(site)
        if lq is None:  # a float site
            with span("ddpm.gn_chain", device_time=True):
                if not self.fused:
                    return gn_silu_chain(h, gamma, beta, groups, self.dtype)
                with span("ddpm.k3"):
                    return self._gn8(h.contiguous(), gamma, beta,
                                     num_groups=groups, out_dtype=self.dtype)
        if not self.fused:
            return gn_silu_chain(h, gamma, beta, groups, self.dtype)
        a = lq.scales(st.row, st.zero)[0]
        with span("ddpm.k3"):
            return _PreQuant(self._gn8(h.contiguous(), gamma, beta,
                                       num_groups=groups, quant_scale=a))

    def _block(self, st: _Step, name: str, x: torch.Tensor) -> torch.Tensor:
        h = self._act(st, f"{name}/conv1", f"{name}/norm1", x)
        h = self._conv(st, f"{name}/conv1", h)
        w, b = self.dense[name]
        h = h + F.linear(st.t_emb, w, b)[:, None, None, :]
        h = self._act(st, f"{name}/conv2", f"{name}/norm2", h)
        h = self._conv(st, f"{name}/conv2", h)
        if self.has_skip[name]:
            x = self._conv(st, f"{name}/skip", x)
        return h + x

    @torch.no_grad()
    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """The time MLP's output for ``(B,)`` timesteps, in ``dtype``."""
        emb = timestep_embedding(t.to(self.device), self.time_dim)
        w0, b0 = self.dense["Dense_0"]
        w1, b1 = self.dense["Dense_1"]
        return F.linear(F.silu(F.linear(emb.to(self.dtype), w0, b0)), w1, b1)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t: torch.Tensor,
                 stats: Optional[Dict] = None, stat_fn=None) -> torch.Tensor:
        """``stats``: a dict that receives each conv input's statistic
        (``stat_fn``, absmax by default) as a device scalar; where K3
        emitted a conv's input, the statistic of its int8 codes."""
        x = x.to(self.device, torch.float32)
        t = t.to(self.device)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        row = zero if self.timesteps is None else torch.searchsorted(
            self.timesteps, t[:1].to(torch.int64))
        st = _Step(row, zero, self.time_embedding(t), stats,
                   stat_fn or _absmax)

        h = self._conv(st, "init_conv", x)
        e1 = self._block(st, "enc1", h)
        e2 = self._block(st, "enc2", _max_pool(e1))
        e3 = self._block(st, "enc3", _max_pool(e2))
        h = self._block(st, "bottleneck", _max_pool(e3))
        h = self._block(st, "dec3", torch.cat(
            [self._upconv(st, "upconv3", h), e3], dim=-1))
        h = self._block(st, "dec2", torch.cat(
            [self._upconv(st, "upconv2", h), e2], dim=-1))
        h = self._block(st, "dec1", torch.cat(
            [self._upconv(st, "upconv1", h), e1], dim=-1))
        h = self._act(st, "final_conv", "final_norm", h)
        return self._conv(st, "final_conv", h).float()


def int8_forward(qtree: Dict, **kwargs) -> FastDDPMForward:
    """:class:`FastDDPMForward` of a ``quantize_fastddpm`` tree."""
    return FastDDPMForward(qtree["params"], qtree["int8"],
                           qtree.get("timesteps"), **kwargs)


def fastddpm_float_apply(params: Dict, x: torch.Tensor, t: torch.Tensor,
                         dtype=torch.float32, time_dim: int = 128,
                         stats: Optional[Dict] = None,
                         stat_fn=None) -> torch.Tensor:
    """Float forward on the flax-layout param tree, on ``x.device``, with
    optional per-conv-input statistics (:class:`FastDDPMForward`)."""
    fwd = FastDDPMForward(params, dtype=dtype, time_dim=time_dim,
                          device=x.device)
    return fwd(x, t, stats=stats, stat_fn=stat_fn)


def fastddpm_int8_apply(qtree: Dict, x: torch.Tensor, t: torch.Tensor,
                        dtype=torch.bfloat16, time_dim: int = 128,
                        gn_impl: Optional[str] = None) -> torch.Tensor:
    """int8-conv Fast-DDPM forward on ``x.device``: ``(B, H, W, 3) + (B,) t
    -> (B, H, W, 1)``.  Prepares the tables on every call; a server builds
    :func:`int8_forward` once instead.

    ``gn_impl``: 'chain' is the JAX package's 'xla' (GroupNorm + SiLU in
    ``dtype``, then ``clip(round(h / a))``); 'fused' is K3 at every
    GroupNorm + SiLU: its int8 codes where the conv it feeds is quantized
    (the JAX package's 'pallas'), else ``dtype``, rounded once after SiLU
    where the chain also rounds before it (about one bf16 rounding an
    element apart, no precision dropped).  None: 'fused' on the card,
    'chain' on the CPU (:func:`default_gn_impl`).  At 256^2, base 64,
    ``int8_deep`` the int8-emitting sites are exactly the ones the TPU
    kernel was eligible for; the port also runs K3 at the 256^2 sites,
    whose blocks the TPU could not hold in VMEM."""
    return int8_forward(qtree, dtype=dtype, time_dim=time_dim,
                        gn_impl=gn_impl, device=x.device)(x, t)


def _tree_device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


@torch.no_grad()
def calibrate_fastddpm(
    variables: Dict,
    schedule: DiffusionSchedule,
    cond_batches: List,
    generator: Optional[torch.Generator] = None,
    dtype=torch.bfloat16,
    time_dim: int = 128,
    percentile: Optional[float] = None,
    sampler: str = "ancestral",
    noise: Optional[List] = None,
) -> Dict[str, np.ndarray]:
    """Per-conv-input absmax (or |x| percentile) per inference step, over
    the real sampling trajectory, on the params' device.

    ``sampler='ancestral'`` runs the chain of ``sample_ancestral``;
    ``'ddim_grid'`` the deterministic DDIM-grid chain of the step-distilled
    students.  cond_batches: ``(B, H, W, 2)`` arrays or tensors.  Noise
    comes from ``generator`` (None: seeded 0 on the device) or from
    ``noise``: one ``(x_T, zs)`` per batch, ``zs`` one draw per step but
    the last, in iteration order (the tests feed the JAX package's draws).
    Returns ``{site: (T,) float32}`` plus ``"__timesteps__"``."""
    if sampler not in ("ancestral", "ddim_grid"):
        raise ValueError(
            f"sampler must be 'ancestral' or 'ddim_grid', got {sampler!r}")
    params = variables["params"]
    device = _tree_device(params)
    stat_fn = (None if percentile is None
               else (lambda a: _abs_percentile(a, percentile)))
    fwd = FastDDPMForward(params, dtype=dtype, time_dim=time_dim,
                          device=device)
    ts = schedule.timesteps.numpy()
    n_steps = len(ts)
    abar_all = schedule.alphas_cumprod.numpy()
    alphas_all = schedule.alphas.numpy()
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def draw(shape, given):
        if given is not None:
            return torch.as_tensor(given, dtype=torch.float32, device=device)
        return torch.randn(shape, generator=generator, device=device)

    acc: Dict[str, np.ndarray] = {}
    with fp32_reference():
        for bi, cond in enumerate(cond_batches):
            cond = torch.as_tensor(cond, dtype=torch.float32).to(device)
            b, h, w, _ = cond.shape
            chain = None if noise is None else noise[bi]
            x = draw((b, h, w, 1), None if chain is None else chain[0])
            for k, step_idx in enumerate(range(n_steps - 1, -1, -1)):
                t_val = int(ts[step_idx])
                abar = float(abar_all[t_val])
                stats: Dict[str, torch.Tensor] = {}
                eps = fwd(torch.cat([cond, x], dim=-1),
                          torch.full((b,), t_val, dtype=torch.int32,
                                     device=device),
                          stats=stats, stat_fn=stat_fn)
                values = torch.stack(list(stats.values())).cpu().numpy()
                for name, v in zip(stats, values):
                    row = acc.setdefault(name, np.zeros(n_steps, np.float32))
                    row[step_idx] = max(row[step_idx], float(v))
                # the JAX package's float64 constants on float32 tensors
                if sampler == "ddim_grid":
                    abar_next = (float(abar_all[int(ts[step_idx - 1])])
                                 if step_idx > 0 else 1.0)
                    x0 = (x - math.sqrt(1.0 - abar) * eps) / math.sqrt(abar)
                    x = (math.sqrt(abar_next) * x0
                         + math.sqrt(1.0 - abar_next) * eps)
                    continue
                x = (1.0 / math.sqrt(abar)) * (
                    x - (1.0 - abar) / math.sqrt(1.0 - abar) * eps)
                if step_idx > 0:
                    abar_prev = float(abar_all[int(ts[step_idx - 1])])
                    beta_t = 1.0 - float(alphas_all[t_val])
                    pvar = max((1.0 - abar_prev) / (1.0 - abar) * beta_t,
                               1e-20)
                    z = draw(x.shape, None if chain is None else chain[1][k])
                    x = x + math.sqrt(pvar) * z
    acc["__timesteps__"] = ts.astype(np.int32)
    return acc


@torch.no_grad()
def calibrate_fastddpm_inputs(variables: Dict, batches: List,
                              dtype=torch.bfloat16,
                              time_dim: int = 128) -> Dict[str, float]:
    """Per-conv-input absmax over given ``(x_in (B, H, W, 3), t (B,))``
    forward inputs (e.g. q_sample states), on the params' device."""
    params = variables["params"]
    device = _tree_device(params)
    fwd = FastDDPMForward(params, dtype=dtype, time_dim=time_dim,
                          device=device)
    acc: Dict[str, float] = {}
    with fp32_reference():
        for x_in, t in batches:
            stats: Dict[str, torch.Tensor] = {}
            fwd(torch.as_tensor(x_in, dtype=torch.float32),
                torch.as_tensor(t), stats=stats)
            for name, v in stats.items():
                acc[name] = max(acc.get(name, 0.0), float(v))
    return acc


def _quantize_site(kernel: torch.Tensor, bias: torch.Tensor,
                   a_absmax) -> Dict:
    """One conv site's int8 tables: a scalar ``a_absmax`` (static
    calibration) gives the UNet path's record; a per-step array gives
    ``{w_int8, a_scale (T,), w_scale (Co,), bias}``, the dequant factor
    being ``a_scale[step] * w_scale``."""
    a = np.asarray(a_absmax, np.float32)
    rec = _quantize_conv(kernel, bias, float(a.max()))
    if a.ndim == 0:
        return rec
    return {
        "w_int8": rec["w_int8"],
        "a_scale": torch.from_numpy(np.maximum(a, 1e-12) / 127.0),
        "w_scale": (rec["scale"] / rec["a_scale"]).float(),
        "bias": rec["bias"],
    }


def bf16_params(tree: Dict) -> Dict:
    """The param tree on the CPU, float32 leaves cast to bfloat16 (the
    serving copy bundles carry)."""
    if isinstance(tree, dict):
        return {k: bf16_params(v) for k, v in tree.items()}
    a = tree.detach().cpu()
    return a.to(torch.bfloat16) if a.dtype == torch.float32 else a


def quantize_fastddpm(variables: Dict, calib: Dict, only=None) -> Dict:
    """Float params + calibration -> the int8 serving tree (CPU):
    ``{"params": bf16 copy of the whole tree, "int8": {site: tables},
    ["timesteps": (T,) int32]}``.  ``only``: quantize just these sites
    (e.g. :data:`DEEP_SITES`); the forward runs the rest in float."""
    params = variables["params"]
    sites: Dict[str, Dict] = {}
    only_set = None if only is None else set(only)

    def grab(name, sub):
        if only_set is not None and name not in only_set:
            return
        if name not in calib:
            raise KeyError(
                f"calibration is missing conv site {name!r}: calibrate "
                "with calibrate_fastddpm on the same topology")
        sites[name] = _quantize_site(sub["kernel"], sub["bias"], calib[name])

    grab("init_conv", params["init_conv"])
    for blk in DIFFUSION_BLOCKS:
        for conv in ("conv1", "conv2", "skip"):
            if conv in params[blk]:
                grab(f"{blk}/{conv}", params[blk][conv])
    for up in UPCONVS:
        grab(up, params[up])
    grab("final_conv", params["final_conv"])

    out = {"params": bf16_params(params), "int8": sites}
    timesteps = calib.get("__timesteps__")
    if timesteps is not None:
        out["timesteps"] = torch.as_tensor(np.asarray(timesteps, np.int32))
    return out
