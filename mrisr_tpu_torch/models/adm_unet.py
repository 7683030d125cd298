"""ADM's diffusion UNet (Dhariwal & Nichol 2021, "Diffusion Models Beat
GANs on Image Synthesis", arXiv:2105.05233): github.com/openai/guided-
diffusion ``guided_diffusion/unet.py:UNetModel`` at its 256^2 settings
(``script_util.py``'s ``channel_mult`` (1, 1, 2, 2, 4, 4) and the
README's flags of the 256x256 unconditional model: ``--num_channels 256
--num_res_blocks 2 --attention_resolutions 32,16,8 --num_head_channels 64
--resblock_updown True --use_scale_shift_norm True --learn_sigma True``).

- :class:`ADMUNet`: ``base_features`` 256 and :data:`CH_MULT`, so six
  levels at 256^2 to 8^2; :data:`NUM_RES_BLOCKS` ResBlocks a level going
  down, one more coming up, a down-ResBlock between levels going down and
  an up-ResBlock coming up (:class:`ResBlock` with ``down`` / ``up``: the
  resampling of h and x between the first SiLU and the first conv); an
  :class:`AttentionBlock` after every ResBlock at
  :data:`ATTENTION_RESOLUTIONS` of :data:`RESOLUTION` and one in the
  middle, with ``C / 64`` heads (:data:`HEAD_CHANNELS`); GroupNorm of :data:`GN_GROUPS` groups and eps :data:`GN_EPS` (GroupNorm32: float32
  statistics); a time embedding of ``base_features`` sinusoids
  (``timestep_embedding(..., 'adm')``), Linear ``time_dim``, SiLU, Linear
  ``time_dim``; in every ResBlock SiLU and a Linear to ``2 C`` split into
  (scale, shift), applied after its second GroupNorm as ``GN(h) (1 +
  scale) + shift``.  552,804,866 parameters at 3 channels in and 2 out
  (:func:`num_parameters`); 552,814,086 at the released model's 3 in and
  6 out.
- Module and state-dict names are guided-diffusion's (``time_embed.0``,
  ``input_blocks.1.0.in_layers.2``, ``input_blocks.3.0.emb_layers.1``,
  ``input_blocks.10.1.qkv``, ``middle_block.1.proj_out``,
  ``output_blocks.2.1``, ``out.2``), shapes included (the attention's
  1x1 ``qkv`` and ``proj_out`` are ``Conv1d``), so a checkpoint of that
  code loads with ``load_state_dict(strict=True)``.
- The input is NHWC ``[pre, post, x_t]``, the output NHWC with
  ``out_channels`` channels (2: the noise estimate, then the learned
  variance's interpolation, ``learn_sigma``).  Dropout is identity.

The level pattern, attention resolutions and GroupNorm are the class's
published constants; a config chooses ``base_features`` and ``time_dim``,
and the constructor the head width (small test models need a narrower
one than the published 64).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    GroupNorm,
    Linear,
    SiLU,
    set_compute_dtype,
    silu,
)
from mrisr_tpu_torch.models.conv import Conv2d
from mrisr_tpu_torch.models.ddpm_unet import attention
from mrisr_tpu_torch.models.diffusion import (
    timestep_embedding,
    upsample_nearest_2x,
)

CH_MULT = (1, 1, 2, 2, 4, 4)
NUM_RES_BLOCKS = 2
ATTENTION_RESOLUTIONS = (32, 16, 8)
RESOLUTION = 256
HEAD_CHANNELS = 64
GN_GROUPS = 32
GN_EPS = 1e-5


def attn_levels() -> Tuple[int, ...]:
    """The levels whose ResBlocks an attention block follows: those at
    :data:`ATTENTION_RESOLUTIONS` of the published :data:`RESOLUTION`."""
    return tuple(i for i in range(len(CH_MULT))
                 if RESOLUTION >> i in ATTENTION_RESOLUTIONS)


class InputBlock(NamedTuple):
    """``input_blocks.k``: ``kind`` 'conv' (the first conv), 'res' or
    'down' (a down-ResBlock); ``level`` the level of the maps it writes;
    ``attn`` whether an AttentionBlock follows at ``.1``."""

    level: int
    kind: str
    ci: int
    co: int
    attn: bool


class OutputBlock(NamedTuple):
    """``output_blocks.k``: a ResBlock at ``level`` on the concatenation
    (``ci`` counts the popped skip), an AttentionBlock if ``attn``, then an
    up-ResBlock into level ``level - 1`` if ``up`` (at ``.2`` after an
    attention block, else ``.1``)."""

    level: int
    ci: int
    co: int
    attn: bool
    up: bool


def layout(ch: int = 256) -> Tuple[List[InputBlock], int, List[OutputBlock]]:
    """guided-diffusion's ``input_blocks``, the middle's width and its
    ``output_blocks``, in order."""
    last, levels = len(CH_MULT) - 1, attn_levels()
    inputs = [InputBlock(0, "conv", 0, ch, False)]
    chans, c = [ch], ch  # input_block_chans
    for i, m in enumerate(CH_MULT):
        for _ in range(NUM_RES_BLOCKS):
            inputs.append(InputBlock(i, "res", c, ch * m, i in levels))
            c = ch * m
            chans.append(c)
        if i != last:
            inputs.append(InputBlock(i + 1, "down", c, c, False))
            chans.append(c)
    mid, outputs = c, []
    for i in reversed(range(last + 1)):
        for j in range(NUM_RES_BLOCKS + 1):
            co = ch * CH_MULT[i]
            outputs.append(OutputBlock(i, c + chans.pop(), co, i in levels,
                                       i > 0 and j == NUM_RES_BLOCKS))
            c = co
    return inputs, mid, outputs


def param_shapes(ch: int = 256, time_dim: Optional[int] = None,
                 in_channels: int = 3, out_channels: int = 2
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by its guided-diffusion name, without
    building the model."""
    d = 4 * ch if time_dim is None else time_dim
    shapes: Dict[str, Tuple[int, ...]] = {
        "time_embed.0.weight": (d, ch), "time_embed.0.bias": (d,),
        "time_embed.2.weight": (d, d), "time_embed.2.bias": (d,)}

    def conv(name, ci, co, *k):
        shapes[f"{name}.weight"] = (co, ci, *k)
        shapes[f"{name}.bias"] = (co,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    def res(name, ci, co):
        norm(f"{name}.in_layers.0", ci)
        conv(f"{name}.in_layers.2", ci, co, 3, 3)
        shapes[f"{name}.emb_layers.1.weight"] = (2 * co, d)
        shapes[f"{name}.emb_layers.1.bias"] = (2 * co,)
        norm(f"{name}.out_layers.0", co)
        conv(f"{name}.out_layers.3", co, co, 3, 3)
        if ci != co:
            conv(f"{name}.skip_connection", ci, co, 1, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        conv(f"{name}.qkv", c, 3 * c, 1)
        conv(f"{name}.proj_out", c, c, 1)

    inputs, mid, outputs = layout(ch)
    for k, blk in enumerate(inputs):
        if blk.kind == "conv":
            conv("input_blocks.0.0", in_channels, ch, 3, 3)
        else:
            res(f"input_blocks.{k}.0", blk.ci, blk.co)
        if blk.attn:
            attn(f"input_blocks.{k}.1", blk.co)
    res("middle_block.0", mid, mid)
    attn("middle_block.1", mid)
    res("middle_block.2", mid, mid)
    for k, blk in enumerate(outputs):
        res(f"output_blocks.{k}.0", blk.ci, blk.co)
        if blk.attn:
            attn(f"output_blocks.{k}.1", blk.co)
        if blk.up:
            res(f"output_blocks.{k}.{1 + blk.attn}", blk.co, blk.co)
    norm("out.0", ch)
    conv("out.2", ch, out_channels, 3, 3)
    return shapes


def num_parameters(ch: int = 256, time_dim: Optional[int] = None,
                   in_channels: int = 3, out_channels: int = 2) -> int:
    """552,804,866 at the published widths (3 in, 2 out)."""
    return sum(math.prod(s) for s in param_shapes(
        ch, time_dim, in_channels, out_channels).values())


def conv_levels(ch: int = 256) -> Dict[str, int]:
    """The level of the maps each conv reads (0: full size), by its
    '/'-joined name: a down-ResBlock's convs read the pooled maps, an
    up-ResBlock's the repeated ones."""
    out: Dict[str, int] = {}

    def res(name, lvl_in, lvl_out, ci, co):
        out[f"{name}/in_layers/2"] = lvl_out
        out[f"{name}/out_layers/3"] = lvl_out
        if ci != co:
            out[f"{name}/skip_connection"] = lvl_in

    def attn(name, lvl):
        out[f"{name}/qkv"] = out[f"{name}/proj_out"] = lvl

    inputs, mid, outputs = layout(ch)
    last = len(CH_MULT) - 1
    for k, blk in enumerate(inputs):
        if blk.kind == "conv":
            out["input_blocks/0/0"] = 0
            continue
        lvl_in = blk.level - (blk.kind == "down")
        res(f"input_blocks/{k}/0", lvl_in, blk.level, blk.ci, blk.co)
        if blk.attn:
            attn(f"input_blocks/{k}/1", blk.level)
    for j in (0, 2):
        res(f"middle_block/{j}", last, last, mid, mid)
    attn("middle_block/1", last)
    for k, blk in enumerate(outputs):
        res(f"output_blocks/{k}/0", blk.level, blk.level, blk.ci, blk.co)
        if blk.attn:
            attn(f"output_blocks/{k}/1", blk.level)
        if blk.up:
            res(f"output_blocks/{k}/{1 + blk.attn}", blk.level,
                blk.level - 1, blk.co, blk.co)
    out["out/2"] = 0
    return out


def fused_attention_takes(q: torch.Tensor) -> bool:
    """Whether torch's fused SDPA backends (flash, memory-efficient) take
    heads of ``q`` ``(B, heads, T, ch)``: on the card, in bf16 or float16,
    a head width a multiple of 8 up to 256."""
    return (q.is_cuda and q.dtype in (torch.bfloat16, torch.float16)
            and q.shape[-1] % 8 == 0 and q.shape[-1] <= 256)


def qkv_attention(qkv: torch.Tensor, heads: int,
                  order: str = "legacy") -> torch.Tensor:
    """guided-diffusion's ``QKVAttentionLegacy`` on tokens: ``qkv`` ``(B,
    T, 3 C)`` (the 1x1 ``qkv`` conv's channels in its order: head by head,
    each head's q, k and v of ``C / heads`` channels) -> ``(B, T, C)``,
    head by head.  ``order='timm'`` reads timm's ``Attention`` order (DiT's
    ``qkv`` Linear): every head's q, then every head's k, then v.  ``softmax(q k^T / sqrt(ch))`` over the keys (the legacy
    code scales q and k by ``ch^-1/4`` each), times v.  Through torch's
    fused SDPA where it takes the heads (:func:`fused_attention_takes`:
    float32 softmax inside, counted in ``calls_fused``), else the float32
    path of ``ddpm_unet.attention`` (float32 scores and softmax; counted
    in ``calls_float``)."""
    b, t, w = qkv.shape
    ch = w // (3 * heads)
    if order == "legacy":
        q, k, v = qkv.reshape(b, t, heads, 3, ch).permute(3, 0, 2, 1,
                                                          4).unbind(0)
    elif order == "timm":
        q, k, v = qkv.reshape(b, t, 3, heads, ch).permute(2, 0, 3, 1,
                                                          4).unbind(0)
    else:
        raise ValueError(f"qkv_attention: order must be 'legacy' or 'timm', "
                         f"got {order!r}")
    if fused_attention_takes(q):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        qkv_attention.calls_fused += 1
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            a = F.scaled_dot_product_attention(q, k, v)
    else:
        qkv_attention.calls_float += 1

        def rows(z):
            return z.reshape(b * heads, t, ch)

        a = attention(rows(q), rows(k), rows(v)).reshape(b, heads, t, ch)
    return a.permute(0, 2, 1, 3).reshape(b, t, heads * ch)


qkv_attention.calls_fused = 0  # the attention cores run by fused SDPA
qkv_attention.calls_float = 0  # those run by the float32 bmm path


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """guided-diffusion's ``avg_pool_nd(2, 2, 2)`` on NCHW."""
    return F.avg_pool2d(x, 2)


def _norm(c: int) -> GroupNorm:
    return GroupNorm(GN_GROUPS, c, eps=GN_EPS)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` (guided-diffusion's ``conv_nd(1, ...)``, the
    attention's 1x1 projections) that runs in ``compute_dtype`` when one
    is set, as :class:`models.conv.Conv2d` does."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        y = self._conv_forward(x.to(cd), self.weight.to(cd), None)
        return y + self.bias.to(cd)[:, None]


class ResBlock(nn.Module):
    """in_layers (GroupNorm, SiLU, 3x3 conv; with ``up`` / ``down`` the
    nearest-2x repeat / 2x2 average pool of h and of x between the SiLU and
    the conv), emb_layers (SiLU, Linear to ``2 C``: scale, shift),
    out_layers (``GN(h) (1 + scale) + shift``, SiLU, dropout, 3x3 conv),
    plus x or its 1x1 ``skip_connection``; NCHW."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.in_layers = nn.Sequential(
            _norm(channels), SiLU(),
            Conv2d(channels, out_channels, 3, padding=1))
        self.updown = (upsample_nearest_2x if up else
                       avg_pool_2x2 if down else None)
        self.emb_layers = nn.Sequential(
            SiLU(), Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(
            _norm(out_channels), SiLU(), nn.Identity(),  # dropout
            Conv2d(out_channels, out_channels, 3, padding=1))
        if out_channels != channels:
            self.skip_connection = Conv2d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm, act, conv = self.in_layers
        h = act(norm(x))
        if self.updown is not None:
            h, x = self.updown(h), self.updown(x)
        h = conv(h)
        scale, shift = self.emb_layers(emb).to(h.dtype)[:, :, None,
                                                        None].chunk(2, dim=1)
        norm, act, _, conv = self.out_layers
        h = conv(act(norm(h) * (1 + scale) + shift))
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return x + h


class AttentionBlock(nn.Module):
    """GroupNorm, 1x1 ``qkv`` to ``3 C``, :func:`qkv_attention` with
    ``C /`` :data:`HEAD_CHANNELS` heads, 1x1 ``proj_out``, residual; NCHW."""

    def __init__(self, channels: int):
        super().__init__()
        if channels % HEAD_CHANNELS:
            raise ValueError(f"{channels} channels do not split into heads "
                             f"of {HEAD_CHANNELS}")
        self.heads = channels // HEAD_CHANNELS
        self.norm = _norm(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        x = x.reshape(b, c, hh * ww)
        qkv = self.qkv(self.norm(x)).transpose(1, 2)
        h = qkv_attention(qkv, self.heads).transpose(1, 2)
        return (x + self.proj_out(h)).reshape(b, c, hh, ww)


class TimestepEmbedSequential(nn.Sequential):
    """Layers in order, the ResBlocks given the embedding too."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ADMUNet(nn.Module):
    """``(B, H, W, 3) + (B,) t -> (B, H, W, out_channels)``, NHWC at the
    interface; H and W multiples of 32."""

    def __init__(self, in_channels: int = 3, out_channels: int = 2,
                 base_features: int = 256, time_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = base_features
        d = 4 * ch if time_dim is None else time_dim
        self.base_features, self.time_dim = ch, d
        self.time_embed = nn.Sequential(Linear(ch, d), SiLU(), Linear(d, d))
        inputs, mid, outputs = layout(ch)
        self.input_blocks = nn.ModuleList()
        for blk in inputs:
            if blk.kind == "conv":
                layers = [Conv2d(in_channels, ch, 3, padding=1)]
            else:
                layers = [ResBlock(blk.ci, d, blk.co,
                                   down=blk.kind == "down")]
            if blk.attn:
                layers.append(AttentionBlock(blk.co))
            self.input_blocks.append(TimestepEmbedSequential(*layers))
        self.middle_block = TimestepEmbedSequential(
            ResBlock(mid, d, mid), AttentionBlock(mid),
            ResBlock(mid, d, mid))
        self.output_blocks = nn.ModuleList()
        for blk in outputs:
            layers = [ResBlock(blk.ci, d, blk.co)]
            if blk.attn:
                layers.append(AttentionBlock(blk.co))
            if blk.up:
                layers.append(ResBlock(blk.co, d, blk.co, up=True))
            self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(_norm(ch), SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1))
        set_compute_dtype(self, dtype)
        for m in self.modules():
            if isinstance(m, Conv1d):
                m.compute_dtype = (torch.bfloat16 if dtype == torch.bfloat16
                                   else None)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        fc0, _, fc1 = self.time_embed
        emb = timestep_embedding(t, self.base_features, "adm")
        emb = fc1(silu(fc0(emb.to(fc0.weight.dtype))))
        h, hs = x.permute(0, 3, 1, 2), []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out(h).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))
