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
  float ``dtype``; ``quantize_fastddpm(only=deep_sites(params))``
  quantizes the sites at <= 128^2 (``int8_deep``): the notebook net's 16
  (:data:`DEEP_SITES`), the DDPM UNet's 99 (its stride-2 downsamples
  stay float, with the full-size level), ADM's every conv whose input,
  after any pool or repeat, is at 128^2 or less; DiT's 112 block linears
  (every block's ``qkv``, ``proj``, ``fc1`` and ``fc2``: dense layers of
  the tree, whose int8 tables are 1x1 conv tables that kernel A runs over
  the token map).

Three networks: the notebook's FastDDPMUNet, the DDPM UNet that Fast-DDPM
publishes (``models/ddpm_unet.py``: 32 GroupNorm groups, self-attention at
16^2 and 8^2, stride-2 downsampling convs, nearest-2x upsampling) and ADM's
UNet (``models/adm_unet.py``: the time projection as a scale and shift
after a ResBlock's second GroupNorm, resampling inside the ResBlocks,
multi-head attention at 32^2, 16^2 and 8^2, two outputs, of which the
sampler reads the first) and DiT-XL/8 (``models/dit.py``: a transformer
over 8 x 8 patches, adaLN-Zero blocks with a token-wise LayerNorm,
modulation and gated residuals).  One forward, :class:`FastDDPMForward`,
serves each tree.

The forward works on the flax-layout param tree (the bundle's), keeps
activations NHWC (channels_last for the float convs) and runs every int8
conv site through kernel A (``ops/conv_int8.py``, float epilogue
``acc * a_scale[row] * w_scale + bias``), the int8 upconv3/upconv2 through
kernel B's float mode (``ops/upconv.py``), and, with ``gn_impl='fused'``,
every GroupNorm + SiLU through K3 (``ops/groupnorm.py``): K3 emits what the
next conv reads, the int8 codes where that conv is quantized, else the
forward's float ``dtype``; at a residual block's norm2 it also adds the
block's time projection (and a float conv1's bias) to its input, in
float32, as it reads it (the chain adds them in ``dtype`` first: cuDNN's
bias add and a broadcast add, each through device memory).  K3 rounds
once, after SiLU (``bf16(silu(y))``); the chain ('chain', the JAX
package's 'xla') rounds the normalized value before SiLU too
(``silu(bf16(y))``).  Both take float32 statistics and hand the conv its
input in ``dtype``; in bf16 they differ by about one bf16 rounding an
element, K3 as a rule the nearer to the float32 forward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.models import adm_unet, dit
from mrisr_tpu_torch.models.ddpm_unet import CH_MULT, NUM_RES_BLOCKS
from mrisr_tpu_torch.models.ddpm_unet import GN_EPS as DDPM_GN_EPS
from mrisr_tpu_torch.models.ddpm_unet import GN_GROUPS as DDPM_GN_GROUPS
from mrisr_tpu_torch.models.ddpm_unet import attention
from mrisr_tpu_torch.models.diffusion import (
    GN_EPS,
    DiffusionSchedule,
    num_groups,
    timestep_embedding,
)
from mrisr_tpu_torch.ops.bias_residual import (
    MAX_C,
    bias_residual,
    bias_residual_plain,
    gated_residual,
    gated_residual_plain,
)
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv2d_int8_plain,
    pack_conv,
)
from mrisr_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_plain
from mrisr_tpu_torch.ops.layernorm import (
    layernorm_modulate,
    layernorm_modulate_plain,
)
from mrisr_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain
from mrisr_tpu_torch.ops.upconv import (
    pack_upconv,
    upconv2x2_int8,
    upconv2x2_int8_plain,
)
from mrisr_tpu_torch.serve.quant import (
    _abs_percentile,
    _quantize_conv,
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
                  groups: int, dtype: torch.dtype, eps: float = GN_EPS,
                  silu: bool = True,
                  scale_shift: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``flax.linen.GroupNorm`` then SiLU, on NHWC: float32 statistics with
    the biased variance E[x^2] - E[x]^2 (clamped at 0), the normalized
    value cast to ``dtype``, SiLU in ``dtype`` (``silu=False``: none).  The
    JAX package's 'xla' path.  ``scale_shift`` ``(B, 2 C)``: ADM's ``y (1 +
    scale) + shift`` between the cast and SiLU, in ``dtype``, as
    guided-diffusion applies it to its GroupNorm32's output.  A row's
    statistics, and so its output, do not depend on the rows beside it
    (:func:`_group_sums`): a data-parallel replica answers as the single
    engine does."""
    b, hh, ww, c = h.shape
    xf = h.reshape(b, hh * ww, c).float()
    n = hh * ww * (c // groups)
    mean = _group_sums(xf, groups) / n
    var = torch.clamp_min(_group_sums(xf * xf, groups) / n - mean * mean,
                          0.0)
    xf = xf.reshape(b, hh * ww, groups, c // groups)
    mul = torch.rsqrt(var + eps)[..., None] * gamma.reshape(groups, -1)
    y = (xf - mean[:, None, :, None]) * mul[:, None] + beta.reshape(groups, -1)
    y = y.to(dtype).reshape(b, hh, ww, c)
    if scale_shift is not None:
        scale, shift = scale_shift.to(dtype)[:, None, None, :].chunk(2, -1)
        y = y * (1 + scale) + shift
    return F.silu(y) if silu else y


def _nchw(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 3, 1, 2)


def _nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1)


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    n, hh, ww, c = h.shape
    return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _avg_pool(h: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of NHWC (``models/adm_unet.py:avg_pool_2x2``), in
    h's type (a float32 sum)."""
    return _nhwc(adm_unet.avg_pool_2x2(_nchw(h)))


def _absmax(a: torch.Tensor) -> torch.Tensor:
    return a.abs().amax().float()


class _PreQuant(NamedTuple):
    """An activation K3 already emitted as int8 codes."""

    q: torch.Tensor


class _QSite:
    """One int8 site's tables on the device: per-step rows (R = steps) or
    one row (a static calibration)."""

    def __init__(self, lq: Dict, per_step: bool, upconv: bool, device):
        a = lq["a_scale"].float()
        if per_step:
            s = a[:, None] * lq["w_scale"].float()[None, :]
        else:
            a, s = a.reshape(1), lq["scale"].float().reshape(1, -1)
        bias = lq["bias"].float()
        self.per_step = per_step
        self.a = a.to(device)
        if upconv:
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


def _layers(tree: Dict, path: Tuple[str, ...] = ()):
    """Every layer of a flax-layout param tree as ('/'-joined name, leaves):
    a conv, upconv or dense layer holds a ``kernel``, a GroupNorm a
    ``scale``."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if "kernel" in v or "scale" in v:
            yield "/".join(path + (k,)), v
        else:
            yield from _layers(v, path + (k,))


def _up2(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NHWC (``F.interpolate(scale_factor=2)``),
    contiguous (from a 1x1 map the reshape alone is a view)."""
    b, hh, ww, c = h.shape
    return h[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c).reshape(
        b, 2 * hh, 2 * ww, c).contiguous()


class Network(NamedTuple):
    """What the port reads of one Fast-DDPM network beyond its tree's
    layers (:func:`network` says which network a tree is): the time MLP's
    two dense layers and whether a swish follows; a residual block's time
    projection and shortcut leaves; the first conv; GroupNorm's eps and
    groups at ``c`` channels; the ConvTranspose upconvs; whether a stride-1
    conv site is ``int8_deep``'s (:func:`deep_sites`); the forward's walk;
    the time sinusoids' variant (``models/diffusion.py:timestep_embedding``);
    the conv sites kernel A does not run, stride 2 or more (``strided``:
    they stay float in every int8 tree); whether A runs the network's deep
    dense layers as 1x1 convs over its token map (``dense_on_a``: DiT's
    block linears); what the forward prepares beyond the layers
    (``prepare``: DiT's adaLN GEMM and position table).

    DiT (:data:`DIT`) has no GroupNorm, no residual-block shortcut and no
    upconv: its ``gn_eps`` is its LayerNorms' eps, ``groups`` and ``skip``
    mean nothing, and ``temb`` names its blocks' adaLN linear."""

    time_mlp: Tuple[str, str]
    time_swish: bool
    temb: str
    skip: str
    first_conv: str
    gn_eps: float
    groups: Callable[[int], int]
    upconvs: Tuple[str, ...]
    deep: Callable[[str], bool]
    walk: Callable
    t_embed: str = "ddpm"
    strided: Callable[[str], bool] = lambda site: site.endswith(
        "downsample/conv")
    dense_on_a: bool = False
    prepare: Callable = lambda fwd, params: None

    def time_dim(self, params: Dict) -> int:
        """The width of the time MLP's output."""
        layer = dict(_layers(params))[self.time_mlp[1]]
        return int(layer["kernel"].shape[-1])

    def base_features(self, params: Dict) -> int:
        """The first conv's output channels."""
        layer = dict(_layers(params))[self.first_conv]
        return int(layer["kernel"].shape[-1])


def _ddpm_level(site: str) -> int:
    """The level of the maps a DDPM UNet conv site reads (0: full size):
    an upsample's conv reads the level above its own; the middle, the
    deepest."""
    parts = site.split("/")
    if parts[0] == "mid":
        return len(CH_MULT) - 1
    if parts[0] in ("down", "up"):
        return int(parts[1]) - (parts[2] == "upsample")
    return 0  # conv_in, conv_out


_ADM_LEVELS = adm_unet.conv_levels()


def _dit_linear(site: str) -> bool:
    """Whether a layer is one of DiT's block linears (``blocks/<i>/attn/qkv``,
    ``.../attn/proj``, ``.../mlp/fc1``, ``.../mlp/fc2``)."""
    parts = site.split("/")
    return (len(parts) == 4 and parts[0] == "blocks"
            and f"{parts[2]}.{parts[3]}" in dit.BLOCK_LINEARS)


def _a_site(net: "Network", name: str, layer: Dict) -> bool:
    """Whether kernel A can run layer ``name``: a stride-1 conv or upconv,
    or a deep dense layer of a network that runs those on A (a 1x1 conv
    of the token map)."""
    k = layer.get("kernel")
    if k is None:
        return False
    return (k.dim() == 4 and not net.strided(name)
            or k.dim() == 2 and net.dense_on_a and net.deep(name))


def deep_sites(params: Dict) -> Tuple[str, ...]:
    """The conv sites ``int8_deep`` quantizes, in the tree's order.  The
    notebook net: :data:`DEEP_SITES`.  The DDPM UNet: every stride-1 conv
    whose input is below the full-size level (at or under 128^2 of a 256^2
    input; the 1x1 attention projections and shortcuts too, and an
    upsample's conv by the size of its own, upsampled, input); the
    full-size level, conv_in, conv_out and the stride-2 downsamples stay
    float.  ADM: every conv whose input, after a down-ResBlock's pool or an
    up-ResBlock's repeat, is below the full-size level (the 1x1 ``qkv``,
    ``proj_out`` and skips too).  DiT: its 112 block linears (the patch
    embedding, the time MLP, the adaLN linears and the final layer stay
    float)."""
    net = network(params)
    return tuple(name for name, p in _layers(params)
                 if _a_site(net, name, p) and net.deep(name))


class FastDDPMForward:
    """The Fast-DDPM denoiser forward of a flax-layout param tree, prepared
    once for ``device``: ``(B, H, W, 3) + (B,) t -> (B, H, W, 1)`` float32.
    The tree is a network the port serves: the notebook's FastDDPMUNet
    (``models/diffusion.py``), the DDPM UNet that Fast-DDPM publishes
    (``models/ddpm_unet.py``), ADM's UNet (``models/adm_unet.py``) or
    DiT-XL/8 (``models/dit.py``); one set of layers (:meth:`_conv`,
    :meth:`_act`, :meth:`_block`, :meth:`_record`, the per-step scale
    rows) runs them, reading the tree's :class:`Network` (:func:`network`),
    whose walk (:meth:`_notebook`, :meth:`_ddpm`, :meth:`_adm` or
    :meth:`_dit`) goes through the network.  A call
    returns every output channel: the noise estimate first (ADM's second
    is its learned variance, which the samplers do not read).

    ``sites`` (``quantize_fastddpm``'s ``int8`` tables) makes those sites
    int8, with ``timesteps`` for per-step tables; without them it is the
    float forward in ``dtype``; the sinusoids' width comes from the tree.
    ``gn_impl``: 'chain' or 'fused' (:func:`default_gn_impl` when None).
    A residual block's time projection goes to its norm2: 'chain' adds
    it to conv1's output in ``dtype``, 'fused' passes it to K3 as the
    input shift of that norm, with a float conv1's bias (:meth:`_block`).
    'fused' on the card runs every other float conv of ``C % 8 == 0``
    channels without its bias, which kernel E (``ops/bias_residual.py``)
    adds in one pass, with a residual block's closing add and its float
    shortcut's bias where the conv is the block's conv2
    (:meth:`_residual`): torch's own roundings, the same bits.
    ``plain=True`` runs the kernels' plain versions even on the card (the
    reference the kernels are held against).

    Spans (``utils/profiling.py:span``): ``ddpm.gn_chain`` around each
    GroupNorm + SiLU that feeds a float conv (a float site), whatever
    implements it, with its device time; host-only, ``ddpm.k3`` around
    each K3 call (inside the ``ddpm.gn_chain`` at a float site),
    ``ddpm.quant`` around each quantizer call (the codes of an int8 conv's
    input that K3 does not emit), ``ddpm.conv_int8`` (kernel A) and
    ``ddpm.conv_float`` (cuDNN) around each conv, ``ddpm.upconv`` around
    each upconv.  The DDPM UNet adds ``ddpm.attn`` around each attention
    block and ``ddpm.level`` (id ``res``, the maps' height) around the
    work of each level, both with device time, and, host-only,
    ``ddpm.attn_bmm`` around the attention core (two batched matmuls and
    a float32 softmax: the path that runs).  ADM records ``ddpm.attn`` and
    ``ddpm.level`` as the DDPM UNet does (a level's span holds the ResBlock
    that resamples into it), and ``ddpm.updown`` (device time, id ``dir``:
    'down' or 'up') around each resampling ResBlock; its attention core
    counts its path in ``adm_unet.qkv_attention.calls_fused`` or
    ``.calls_float``.

    DiT (:meth:`_dit`) reads no ``gn_impl``: kernel L (``ops/layernorm.py``,
    its LayerNorm and modulation, int8 codes where the next linear is
    int8), kernel A's GELU form (``fc1`` emitting ``fc2``'s codes) and
    kernel E's gated form (``ops/bias_residual.py:gated_residual``) run as
    kernels on the card and as their plain versions on the CPU (or with
    ``plain``); it runs :data:`dit.HEADS` heads (the tree does not say how
    many).  Its spans: ``ddpm.attn`` (device time) around each block's
    attention half, from L to the gated residual; ``dit.mlp`` (device
    time) around each MLP half; ``dit.modulate`` (device time) around each
    L launch and each gated residual."""

    def __init__(self, params: Dict, sites: Optional[Dict] = None,
                 timesteps=None, *, dtype=torch.bfloat16,
                 gn_impl: Optional[str] = None, device: DeviceLike = None,
                 plain: bool = False):
        device = resolve_device(device)
        gn_impl = default_gn_impl(device) if gn_impl is None else gn_impl
        if gn_impl not in GN_IMPLS:
            raise ValueError(f"gn_impl must be one of {GN_IMPLS}, got "
                             f"{gn_impl!r}")
        self.device, self.dtype = device, dtype
        self.fused = gn_impl == "fused"
        self._conv8 = conv2d_int8_plain if plain else conv2d_int8
        self._up8 = upconv2x2_int8_plain if plain else upconv2x2_int8
        self._gn8 = groupnorm_silu_plain if plain else groupnorm_silu
        self._q8 = quantize_int8_plain if plain else quantize_int8
        self._bias = bias_residual_plain if plain else bias_residual
        self._ln8 = layernorm_modulate_plain if plain else layernorm_modulate
        self._gate8 = gated_residual_plain if plain else gated_residual
        # cuDNN runs a conv without its bias and torch adds it after, in a
        # broadcast add of its own; 'fused' on the card leaves it out and
        # kernel E adds it (with the block's residual, :meth:`_residual`).
        # The CPU's conv folds the bias into its sum (one rounding), so
        # there the convs keep it.
        self._e = self.fused and device.type == "cuda"
        self.net = net = network(params)
        sites = sites or {}
        per_step = any(lq["a_scale"].dim() for lq in sites.values())
        if per_step and timesteps is None:
            raise ValueError(
                "per-step a_scale tables need the 'timesteps' lookup row in "
                "the qtree (quantize_fastddpm keeps it when the calibration "
                "came from calibrate_fastddpm)")
        self.timesteps = (None if timesteps is None else torch.as_tensor(
            timesteps).to(device=device, dtype=torch.int64))
        for name in sites:
            if net.strided(name):
                raise ValueError(f"{name}: kernel A runs stride 1 only; the "
                                 "strided convs stay float")
            block, _, leaf = name.rpartition("/")
            if leaf in ("q", "k", "v") and "attn" in block:
                self._check_shared_scale(block, sites)
        self.q = {name: _QSite(lq, lq["a_scale"].dim() > 0,
                               name in net.upconvs, device)
                  for name, lq in sites.items()}

        def f(v, dt=dtype):
            return v.to(device=device, dtype=dt)

        self.dense, self.norms, self.convs, self.upconvs = {}, {}, {}, {}
        for name, p in _layers(params):
            if "scale" in p:  # GroupNorm: float32 statistics and affine
                self.norms[name] = (f(p["scale"], torch.float32),
                                    f(p["bias"], torch.float32))
            elif p["kernel"].dim() == 2:
                if name not in self.q:
                    self.dense[name] = (f(p["kernel"]).t(), f(p["bias"]))
            elif name in net.upconvs:
                if name not in self.q:
                    k = p["kernel"]
                    self.upconvs[name] = (
                        f(k.flip(0, 1).permute(2, 3, 0, 1)).contiguous(),
                        f(p["bias"]))
            elif name not in self.q:
                w = f(p["kernel"].permute(3, 2, 0, 1)).contiguous(
                    memory_format=torch.channels_last)
                self.convs[name] = (w, f(p["bias"]), w.shape[-1] // 2)
        # the sinusoids' width
        self.emb_dim = int(self.dense[net.time_mlp[0]][0].shape[1])
        net.prepare(self, params)

    @staticmethod
    def _check_shared_scale(block: str, sites: Dict) -> None:
        """q, k and v read one GroupNorm output, which K3 quantizes once:
        their per-step activation scales must be one (a calibration sees
        the same tensor at all three)."""
        a = [sites.get(f"{block}/{p}") for p in ("q", "k", "v")]
        if any(lq is None for lq in a) or not all(
                torch.equal(lq["a_scale"], a[0]["a_scale"]) for lq in a):
            raise ValueError(f"{block}: q, k and v must be int8 together, "
                             "with one activation scale")

    # ------------------------------------------------------------- layers
    def _record(self, st: _Step, name: str, h) -> None:
        if st.stats is not None:
            v = st.stat_fn(h)
            st.stats[name] = (torch.maximum(st.stats[name], v)
                              if name in st.stats else v)

    def _e_bias(self, name: str) -> Optional[torch.Tensor]:
        """The bias of float conv or upconv ``name`` where kernel E adds
        it (:attr:`_e`, and its ``C`` a multiple of 8 up to E's
        ``MAX_C``), else None (int8 sites, the 1- and 2-channel output
        convs, 'chain', the CPU)."""
        layer = self.convs.get(name) or self.upconvs.get(name)
        if not self._e or layer is None:
            return None
        c = layer[1].numel()
        return layer[1] if c % 8 == 0 and c <= MAX_C else None

    def _add_bias(self, y: torch.Tensor, b: Optional[torch.Tensor],
                  r: Optional[torch.Tensor] = None,
                  rb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y`` (a bias-less float conv's output) plus its bias ``b`` by
        kernel E, and ``r`` (plus its bias ``rb``) where given; ``b`` None:
        y as it is (its conv took its bias)."""
        if b is None:
            return y
        return self._bias(y.contiguous(), b,
                          None if r is None else r.contiguous(), rb)

    def _conv(self, st: _Step, name: str, h, bias: bool = True,
              keep_float: bool = False, gelu_to: Optional[str] = None):
        """Conv ``name`` of ``h`` (or of K3's codes): kernel A where the
        site is int8, else cuDNN in ``dtype`` (its bias added by kernel E
        where :meth:`_e_bias` gives it); ``bias=False`` leaves a float
        conv's bias out (its caller adds it).  A network's dense site (a
        DiT block linear) that is not int8 is ``F.linear`` in ``dtype``.
        ``keep_float``: A's float32 output as it is (else cast to
        ``dtype``); ``gelu_to`` (an int8 site): A's GELU form, the codes of
        that site's input."""
        lq = self.q.get(name)
        if isinstance(h, _PreQuant):  # K3 (or _upsample) emitted the codes
            self._record(st, name, h.q)
            q = h.q
            s = lq.scales(st.row, st.zero)[1]
        else:
            self._record(st, name, h)
            if lq is None:  # not quantized: a float conv in dtype
                if name in self.dense:  # a token linear of DiT's
                    w, b = self.dense[name]
                    return F.linear(h.to(self.dtype), w, b)
                w, b, pad = self.convs[name]
                e = self._e_bias(name) if bias else None
                b = b if bias and e is None else None
                with span("ddpm.conv_float"):
                    x = _nchw(h.to(self.dtype))
                    if self.net.strided(name):  # TF's "SAME"
                        y = F.conv2d(F.pad(x, (0, 1, 0, 1)), w, b, stride=2)
                    else:
                        y = F.conv2d(x, w, b, padding=pad)
                    return self._add_bias(_nhwc(y), e)
            a, s = lq.scales(st.row, st.zero)
            q = self._quant(h, a)
        with span("ddpm.conv_int8"):
            if gelu_to is not None:
                a = self.q[gelu_to].scales(st.row, st.zero)[0]
                return _PreQuant(self._conv8(q.contiguous(), lq.w, s, lq.b,
                                             relu=False, gelu_scale=a))
            y = self._conv8(q.contiguous(), lq.w, s, lq.b, relu=False,
                            out_float=True)
            return y if keep_float else y.to(self.dtype)

    def _quant(self, h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """The int8 codes of an int8 conv's input that no K3 emitted."""
        with span("ddpm.quant"):
            return self._q8(h, a)

    def _upconv(self, st: _Step, name: str, h: torch.Tensor) -> torch.Tensor:
        self._record(st, name, h)
        lq = self.q.get(name)
        with span("ddpm.upconv"):
            if lq is None:
                w, b = self.upconvs[name]
                e = self._e_bias(name)
                y = F.conv_transpose2d(_nchw(h.to(self.dtype)), w,
                                       b if e is None else None, stride=2)
                return self._add_bias(_nhwc(y), e)
            a, s = lq.scales(st.row, st.zero)
            y = self._up8(self._quant(h, a).contiguous(), lq.w, s, lq.b,
                          out_float=True)
            return y.to(self.dtype)

    def _act(self, st: _Step, site: str, norm: str, h: torch.Tensor,
             silu: bool = True, shift: Optional[torch.Tensor] = None,
             scale_shift: Optional[torch.Tensor] = None, codes: bool = True):
        """GroupNorm + SiLU (``silu=False``: GroupNorm alone) feeding conv
        ``site``.  'fused': K3 at every site, emitting what that conv
        reads: int8 codes (its per-step activation scale) where it is
        quantized and ``codes``, else ``dtype``, rounded once after SiLU;
        ``shift`` ``(B, C)`` (a residual block's time projection, 'fused'
        only) is added to ``h`` by K3 as it reads it, in float32
        (:meth:`_block`); ``scale_shift`` ``(B, 2 C)`` (an ADM ResBlock's
        time projection) scales and shifts the GroupNorm's output before
        SiLU (:meth:`_adm_block`).  'chain': :func:`gn_silu_chain`, which
        rounds to ``dtype`` before SiLU too; the quantizer of an int8 conv
        follows in :meth:`_conv`."""
        gamma, beta = self.norms[norm]
        groups, eps = self.net.groups(h.shape[-1]), self.net.gn_eps
        lq = self.q.get(site)
        with (span("ddpm.gn_chain", device_time=True) if lq is None
              else contextlib.nullcontext()):  # a float site
            if not self.fused:
                return gn_silu_chain(h, gamma, beta, groups, self.dtype, eps,
                                     silu, scale_shift)
            gn = dict(num_groups=groups, eps=eps, silu=silu)
            if shift is not None:
                gn["shift"] = shift
            if scale_shift is not None:
                gn["scale_shift"] = scale_shift
            if lq is None or not codes:
                gn["out_dtype"] = self.dtype
            else:
                gn["quant_scale"] = lq.scales(st.row, st.zero)[0]
            with span("ddpm.k3"):
                y = self._gn8(h.contiguous(), gamma, beta, **gn)
            return _PreQuant(y) if "quant_scale" in gn else y

    def _block(self, st: _Step, name: str, x: torch.Tensor) -> torch.Tensor:
        """A residual block: GroupNorm, SiLU, conv1, plus the time
        projection (``Network.temb``), GroupNorm, SiLU, conv2, plus ``x`` or
        its 1x1 shortcut conv (``Network.skip``).  The projection ``(B, C)``
        in ``dtype``: 'chain' adds it to conv1's output in ``dtype`` (a
        broadcast add), 'fused' hands it to norm2's K3, which adds it in
        float32 as it reads that output; where conv1 is a float conv, its
        bias rides that shift too (``t + bias`` in float32) instead of
        cuDNN's own broadcast add."""
        h = self._act(st, f"{name}/conv1", f"{name}/norm1", x)
        w, b = self.dense[f"{name}/{self.net.temb}"]
        t = F.linear(st.t_emb, w, b)
        conv1 = f"{name}/conv1"
        if self.fused:
            float_conv = conv1 in self.convs
            h = self._conv(st, conv1, h, bias=not float_conv)
            if float_conv:
                t = t.float() + self.convs[conv1][1].float()
            h = self._act(st, f"{name}/conv2", f"{name}/norm2", h, shift=t)
        else:
            h = self._conv(st, conv1, h)
            h = self._act(st, f"{name}/conv2", f"{name}/norm2",
                          h + t[:, None, None, :])
        return self._residual(st, f"{name}/conv2",
                              f"{name}/{self.net.skip}", h, x)

    def _residual(self, st: _Step, conv2: str, skip: str, h, x
                  ) -> torch.Tensor:
        """A residual block's close: conv ``conv2`` of ``h`` plus ``x`` or
        the 1x1 shortcut conv ``skip`` of x where the tree has one.  Where
        kernel E takes conv2's bias, the add is E's pass too: conv2 and a
        float shortcut run without their biases, and E adds both biases and
        the residual at once; else ``h + x`` as torch adds it."""
        b = self._e_bias(conv2)
        h = self._conv(st, conv2, h, bias=b is None)
        rb = None if b is None else self._e_bias(skip)
        if skip in self.q or skip in self.convs:
            x = self._conv(st, skip, x, bias=rb is None)
        return h + x if b is None else self._add_bias(h, b, x, rb)

    def _attn(self, st: _Step, name: str, x: torch.Tensor) -> torch.Tensor:
        """The DDPM UNet's AttnBlock: GroupNorm (no SiLU) read by the 1x1
        q, k and v convs, single-head attention over the pixels
        (``models/ddpm_unet.py:attention``: bf16 operands, float32 scores
        and softmax), 1x1 proj_out, residual."""
        with span("ddpm.attn", device_time=True):
            b, hh, ww, c = x.shape
            h = self._act(st, f"{name}/q", f"{name}/norm", x, silu=False)
            q, k, v = (self._conv(st, f"{name}/{p}", h).reshape(b, hh * ww, c)
                       for p in ("q", "k", "v"))
            with span("ddpm.attn_bmm"):
                h = attention(q, k, v).reshape(b, hh, ww, c)
            return x + self._conv(st, f"{name}/proj_out", h)

    def _adm_block(self, st: _Step, name: str, x: torch.Tensor,
                   resample: Optional[str] = None) -> torch.Tensor:
        """An ADM ResBlock: GroupNorm, SiLU, (with ``resample`` 'down' or
        'up': the 2x2 average pool or nearest-2x repeat of h and of x),
        conv, then GroupNorm, ``(1 + scale)`` and ``shift`` from the time
        projection (``Network.temb``, ``(B, 2 C)``), SiLU, conv, plus x or
        its 1x1 skip.  Going down, K3 emits ``dtype`` where the conv is
        int8 (the mean of codes is not the code of the mean): the pooled
        maps go through the quantizer.  Coming up, the codes are repeated
        (the same codes).  A resampling block is one ``ddpm.updown`` span
        (device time, id ``dir``)."""
        with (span("ddpm.updown", device_time=True, dir=resample)
              if resample else contextlib.nullcontext()):
            conv1, conv2 = f"{name}/in_layers/2", f"{name}/out_layers/3"
            w, b = self.dense[f"{name}/{self.net.temb}"]
            scale_shift = F.linear(st.t_emb, w, b)
            h = self._act(st, conv1, f"{name}/in_layers/0", x,
                          codes=resample != "down")
            if resample == "down":
                h, x = _avg_pool(h), _avg_pool(x)
            elif resample == "up":
                h = (_PreQuant(_up2(h.q)) if isinstance(h, _PreQuant)
                     else _up2(h))
                x = _up2(x)
            h = self._conv(st, conv1, h)
            h = self._act(st, conv2, f"{name}/out_layers/0", h,
                          scale_shift=scale_shift)
            return self._residual(st, conv2, f"{name}/{self.net.skip}", h,
                                  x)

    def _adm_attn(self, st: _Step, name: str, x: torch.Tensor
                  ) -> torch.Tensor:
        """ADM's AttentionBlock: GroupNorm (no SiLU) read by the 1x1
        ``qkv`` conv, guided-diffusion's legacy multi-head attention over
        the pixels (``adm_unet.qkv_attention``, heads of
        ``adm_unet.HEAD_CHANNELS``), 1x1 ``proj_out``, residual."""
        with span("ddpm.attn", device_time=True):
            b, hh, ww, c = x.shape
            h = self._act(st, f"{name}/qkv", f"{name}/norm", x, silu=False)
            qkv = self._conv(st, f"{name}/qkv", h).reshape(b, hh * ww, 3 * c)
            h = adm_unet.qkv_attention(qkv, c // adm_unet.HEAD_CHANNELS)
            return x + self._conv(st, f"{name}/proj_out",
                                  h.reshape(b, hh, ww, c))

    def _upsample(self, st: _Step, name: str, h: torch.Tensor
                  ) -> torch.Tensor:
        """Nearest 2x, then the 3x3 conv ``name``; where that conv is int8
        the codes are taken before the repeat (4x fewer elements, the same
        codes)."""
        lq = self.q.get(name)
        if lq is None:
            return self._conv(st, name, _up2(h))
        return self._conv(st, name, _PreQuant(_up2(self._quant(
            h, lq.scales(st.row, st.zero)[0]))))

    @torch.no_grad()
    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """The time MLP's output for ``(B,)`` timesteps, in ``dtype`` (the
        DDPM UNet's after the swish that every block applies)."""
        emb = timestep_embedding(t.to(self.device), self.emb_dim,
                                 self.net.t_embed)
        (w0, b0), (w1, b1) = (self.dense[n] for n in self.net.time_mlp)
        out = F.linear(F.silu(F.linear(emb.to(self.dtype), w0, b0)), w1, b1)
        return F.silu(out) if self.net.time_swish else out

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
        return self.net.walk(self, st, x).float()

    def _notebook(self, st: _Step, x: torch.Tensor) -> torch.Tensor:
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
        return self._conv(st, "final_conv", h)

    def _ddpm(self, st: _Step, x: torch.Tensor) -> torch.Tensor:
        """The DDIM code's ``Model.forward``; each level's work (its
        blocks, and the conv that writes its maps: conv_in, a downsample,
        an upsample) inside one ``ddpm.level`` span."""
        last = len(CH_MULT) - 1
        res = x.shape[1]

        def level(i):
            return span("ddpm.level", device_time=True, res=res >> i)

        hs = []
        for i in range(last + 1):
            with level(i):
                hs.append(self._conv(st, "conv_in", x) if i == 0 else
                          self._conv(st, f"down/{i - 1}/downsample/conv",
                                     hs[-1]))
                for j in range(NUM_RES_BLOCKS):
                    h = self._block(st, f"down/{i}/block/{j}", hs[-1])
                    if f"down/{i}/attn/{j}/norm" in self.norms:
                        h = self._attn(st, f"down/{i}/attn/{j}", h)
                    hs.append(h)
        with level(last):
            h = self._block(st, "mid/block_1", hs[-1])
            h = self._attn(st, "mid/attn_1", h)
            h = self._block(st, "mid/block_2", h)
        for i in reversed(range(last + 1)):
            with level(i):
                if i != last:
                    h = self._upsample(st, f"up/{i + 1}/upsample/conv", h)
                for j in range(NUM_RES_BLOCKS + 1):
                    h = self._block(st, f"up/{i}/block/{j}",
                                    torch.cat([h, hs.pop()], dim=-1))
                    if f"up/{i}/attn/{j}/norm" in self.norms:
                        h = self._attn(st, f"up/{i}/attn/{j}", h)
                if i == 0:
                    h = self._act(st, "conv_out", "norm_out", h)
                    h = self._conv(st, "conv_out", h)
        return h


    def _adm(self, st: _Step, x: torch.Tensor) -> torch.Tensor:
        """guided-diffusion's ``UNetModel.forward``; each level's work (its
        blocks, and the first conv or the ResBlock that resamples into it)
        inside one ``ddpm.level`` span, as :meth:`_ddpm` does."""
        inputs, _, outputs = adm_unet.layout()
        last = len(adm_unet.CH_MULT) - 1
        res = x.shape[1]

        def level(i):
            return span("ddpm.level", device_time=True, res=res >> i)

        hs, h = [], x
        for i in range(last + 1):
            with level(i):
                for k, blk in enumerate(inputs):
                    name = f"input_blocks/{k}"
                    if blk.level != i:
                        continue
                    if blk.kind == "conv":
                        h = self._conv(st, f"{name}/0", x)
                    else:
                        h = self._adm_block(
                            st, f"{name}/0", h,
                            "down" if blk.kind == "down" else None)
                    if blk.attn:
                        h = self._adm_attn(st, f"{name}/1", h)
                    hs.append(h)
        with level(last):
            h = self._adm_block(st, "middle_block/0", h)
            h = self._adm_attn(st, "middle_block/1", h)
            h = self._adm_block(st, "middle_block/2", h)
        up = None  # an up-ResBlock, run in the span of the level it writes
        for i in reversed(range(last + 1)):
            with level(i):
                if up is not None:
                    h = self._adm_block(st, up, h, "up")
                for k, blk in enumerate(outputs):
                    name = f"output_blocks/{k}"
                    if blk.level != i:
                        continue
                    h = self._adm_block(st, f"{name}/0",
                                        torch.cat([h, hs.pop()], dim=-1))
                    if blk.attn:
                        h = self._adm_attn(st, f"{name}/1", h)
                    up = f"{name}/{1 + blk.attn}" if blk.up else None
                if i == 0:
                    h = self._act(st, "out/2", "out/0", h)
                    h = self._conv(st, "out/2", h)
        return h


    # ---------------------------------------------------------------- DiT
    def _dit_prepare(self, params: Dict) -> None:
        """DiT's serving constants: the 29 adaLN linears (every block's and
        the final layer's, which all read ``SiLU(c)``) as one GEMM's
        weights, and each one's column offset in its output; the fixed
        position table in float32; the patch and the heads."""
        names = [n for n in self.dense if n.endswith("adaLN_modulation/1")]
        ws, bs, self.ada_at, at = [], [], {}, 0
        for n in names:
            w, b = self.dense.pop(n)
            self.ada_at[n.rsplit("/", 2)[0]] = at
            at += w.shape[0]
            ws.append(w)
            bs.append(b)
        self.ada = (torch.cat(ws).contiguous(), torch.cat(bs))
        pos = params.get("pos_embed")
        self.pos = (None if pos is None else pos.to(
            device=self.device, dtype=torch.float32).reshape(
                -1, pos.shape[-1]))
        self.patch = int(self.convs["x_embedder/proj"][0].shape[-1])
        self.heads = dit.HEADS
        self.depth = sum(1 for n in self.ada_at if n.startswith("blocks/"))

    def _dit(self, st: _Step, x: torch.Tensor) -> torch.Tensor:
        """DiT's ``forward`` on NHWC maps of tokens (``(B, H / p, W / p,
        C)``, row-major: DiT's token order): the patch embedding and the
        position table, the adaLN rows of every block in one GEMM, the
        blocks (:meth:`_dit_block`), the final layer and the unpatchify."""
        w, b, _ = self.convs["x_embedder/proj"]
        h = _nhwc(F.conv2d(_nchw(x.to(self.dtype)), w, b, stride=self.patch))
        _, gh, gw, c = h.shape
        pos = (self.pos if self.pos is not None and self.pos.shape[0] ==
               gh * gw else dit.pos_embed_table(c, gh).to(self.device))
        h = (h.float() + pos.reshape(gh, gw, c)).to(self.dtype)
        mods = F.linear(st.t_emb, *self.ada).float()
        for i in range(self.depth):
            h = self._dit_block(st, f"blocks/{i}", h, mods,
                                self.ada_at[f"blocks/{i}"])
        o = self.ada_at["final_layer"]
        h = self._modulate(st, "final_layer/linear", h, mods[:, o:o + 2 * c])
        h = F.linear(h, *self.dense["final_layer/linear"])
        return dit.unpatchify(h.reshape(h.shape[0], gh * gw, -1), gh, gw,
                              self.patch)

    def _dit_block(self, st: _Step, name: str, x: torch.Tensor,
                   mods: torch.Tensor, o: int) -> torch.Tensor:
        """One adaLN-Zero block.  ``mods[:, o:o + 6 C]`` is its (shift1,
        scale1, gate1, shift2, scale2, gate2), float32.  Attention: L (codes
        at ``qkv``'s scale), ``qkv`` (A, float32 out, cast to ``dtype``),
        fused SDPA on timm's qkv order, ``proj`` (A's codes from the
        quantizer; float32 out), E's gated residual into x.  MLP: L (codes
        at ``fc1``'s), ``fc1`` (A's GELU form: ``fc2``'s codes), ``fc2``
        (float32 out), E's gated residual."""
        b, gh, gw, c = x.shape
        with span("ddpm.attn", device_time=True):
            h = self._modulate(st, f"{name}/attn/qkv", x, mods[:, o:o + 2 * c])
            qkv = self._conv(st, f"{name}/attn/qkv", h)
            a = adm_unet.qkv_attention(qkv.reshape(b, gh * gw, 3 * c),
                                       self.heads, "timm")
            y = self._conv(st, f"{name}/attn/proj", a.reshape(b, gh, gw, c),
                           keep_float=True)
            x = self._gated(x, mods[:, o + 2 * c:o + 3 * c], y)
        with span("dit.mlp", device_time=True):
            fc1, fc2 = f"{name}/mlp/fc1", f"{name}/mlp/fc2"
            h = self._modulate(st, fc1, x, mods[:, o + 3 * c:o + 5 * c])
            if fc1 in self.q and fc2 in self.q:
                h = self._conv(st, fc1, h, gelu_to=fc2)
            else:
                h = F.gelu(self._conv(st, fc1, h), approximate="tanh")
            y = self._conv(st, fc2, h, keep_float=True)
            return self._gated(x, mods[:, o + 5 * c:o + 6 * c], y)

    def _modulate(self, st: _Step, site: str, x: torch.Tensor,
                  shift_scale: torch.Tensor):
        """Kernel L before ``site``: LayerNorm, then ``(1 + scale) +
        shift``; the int8 codes of ``site``'s input where it is int8, else
        x's type."""
        lq = self.q.get(site)
        kw = {} if lq is None else {
            "quant_scale": lq.scales(st.row, st.zero)[0]}
        with span("dit.modulate", device_time=True):
            y = self._ln8(x, shift_scale, eps=self.net.gn_eps, **kw)
        return y if lq is None else _PreQuant(y)

    def _gated(self, x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor
               ) -> torch.Tensor:
        """Kernel E's gated residual, ``x + gate * y`` in place into x."""
        with span("dit.modulate", device_time=True):
            return self._gate8(x, gate, y.float())


NOTEBOOK = Network(
    time_mlp=("time_emb/Dense_0", "time_emb/Dense_1"), time_swish=False,
    temb="time_fc", skip="skip", first_conv="init_conv", gn_eps=GN_EPS,
    groups=num_groups, upconvs=UPCONVS, deep=lambda site: site in DEEP_SITES,
    walk=FastDDPMForward._notebook)
DDPM = Network(
    time_mlp=("temb/dense/0", "temb/dense/1"), time_swish=True,
    temb="temb_proj", skip="nin_shortcut", first_conv="conv_in",
    gn_eps=DDPM_GN_EPS, groups=lambda c: DDPM_GN_GROUPS, upconvs=(),
    deep=lambda site: _ddpm_level(site) > 0, walk=FastDDPMForward._ddpm)
ADM = Network(
    time_mlp=("time_embed/0", "time_embed/2"), time_swish=True,
    temb="emb_layers/1", skip="skip_connection",
    first_conv="input_blocks/0/0", gn_eps=adm_unet.GN_EPS,
    groups=lambda c: adm_unet.GN_GROUPS, upconvs=(),
    deep=lambda site: _ADM_LEVELS[site] > 0, walk=FastDDPMForward._adm,
    t_embed="adm")
DIT = Network(
    time_mlp=("t_embedder/mlp/0", "t_embedder/mlp/2"), time_swish=True,
    temb="adaLN_modulation/1", skip="", first_conv="x_embedder/proj",
    gn_eps=dit.LN_EPS, groups=lambda c: 1, upconvs=(), deep=_dit_linear,
    walk=FastDDPMForward._dit, t_embed="adm",
    strided=lambda site: site == "x_embedder/proj", dense_on_a=True,
    prepare=FastDDPMForward._dit_prepare)


def network(params: Dict) -> Network:
    """The network of a flax-layout tree: :data:`DIT`, DiT's
    (``models/dit.py``), :data:`ADM`, ADM's UNet's
    (``models/adm_unet.py``), :data:`DDPM`, the DDPM UNet's
    (``models/ddpm_unet.py``), or :data:`NOTEBOOK`, the notebook
    FastDDPMUNet's (``models/diffusion.py``)."""
    if "x_embedder" in params:
        return DIT
    if "input_blocks" in params:
        return ADM
    return DDPM if "conv_in" in params else NOTEBOOK


def int8_forward(qtree: Dict, **kwargs) -> FastDDPMForward:
    """:class:`FastDDPMForward` of a ``quantize_fastddpm`` tree."""
    return FastDDPMForward(qtree["params"], qtree["int8"],
                           qtree.get("timesteps"), **kwargs)


def fastddpm_float_apply(params: Dict, x: torch.Tensor, t: torch.Tensor,
                         dtype=torch.float32,
                         stats: Optional[Dict] = None,
                         stat_fn=None) -> torch.Tensor:
    """Float forward on the flax-layout param tree, on ``x.device``, with
    optional per-conv-input statistics (:class:`FastDDPMForward`)."""
    fwd = FastDDPMForward(params, dtype=dtype, device=x.device)
    return fwd(x, t, stats=stats, stat_fn=stat_fn)


def fastddpm_int8_apply(qtree: Dict, x: torch.Tensor, t: torch.Tensor,
                        dtype=torch.bfloat16,
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
    return int8_forward(qtree, dtype=dtype, gn_impl=gn_impl,
                        device=x.device)(x, t)


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
    fwd = FastDDPMForward(params, dtype=dtype, device=device)
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
                          stats=stats, stat_fn=stat_fn)[..., :1]
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
                              dtype=torch.bfloat16) -> Dict[str, float]:
    """Per-conv-input absmax over given ``(x_in (B, H, W, 3), t (B,))``
    forward inputs (e.g. q_sample states), on the params' device."""
    params = variables["params"]
    device = _tree_device(params)
    fwd = FastDDPMForward(params, dtype=dtype, device=device)
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
    (:func:`deep_sites`: ``int8_deep``); None: every conv kernel A runs
    (``int8``: all but the DDPM UNet's stride-2 downsamples and DiT's
    patch embedding; DiT's block linears).  A dense site's tables are a
    1x1 conv's.  The forward runs the rest in float."""
    params = variables["params"]
    net = network(params)
    sites: Dict[str, Dict] = {}
    only_set = None if only is None else set(only)

    def grab(name, sub):
        if only_set is not None and name not in only_set:
            return
        if name not in calib:
            raise KeyError(
                f"calibration is missing conv site {name!r}: calibrate "
                "with calibrate_fastddpm on the same topology")
        kernel = sub["kernel"]
        if kernel.dim() == 2:  # a dense site: a 1x1 conv's (1, 1, I, O)
            kernel = kernel[None, None]
        sites[name] = _quantize_site(kernel, sub["bias"], calib[name])

    for name, sub in _layers(params):
        k = sub.get("kernel")
        if k is None:
            continue
        if k.dim() == 4 and (only_set is not None or not net.strided(name)):
            grab(name, sub)  # a conv, an upconv
        elif k.dim() == 2 and _a_site(net, name, sub):
            grab(name, sub)

    out = {"params": bf16_params(params), "int8": sites}
    timesteps = calib.get("__timesteps__")
    if timesteps is not None:
        out["timesteps"] = torch.as_tensor(np.asarray(timesteps, np.int32))
    return out
