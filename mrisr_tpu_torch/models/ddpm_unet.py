"""The DDPM UNet that Fast-DDPM (Jiang et al. 2024, arXiv:2405.14802)
publishes for its PMUB task: github.com/mirthAI/Fast-DDPM runs the
denoiser of the DDIM code (github.com/ermongroup/ddim
``models/diffusion.py:Model``; Ho et al. 2020, arXiv:2006.11239) at its
256^2 widths.

- :class:`DDPMUNet`: ``ch`` 128 and :data:`CH_MULT` (1, 1, 2, 2, 4, 4), so
  six levels at 256^2 to 8^2; :data:`NUM_RES_BLOCKS` ResnetBlocks a level
  going down and one more coming up; a single-head :class:`AttnBlock`
  after every ResnetBlock at 16^2 (:data:`ATTN_RESOLUTIONS` at the
  published :data:`RESOLUTION`) and one in the middle; GroupNorm with
  :data:`GN_GROUPS` groups and eps :data:`GN_EPS`; a time embedding of
  ``ch`` sinusoids, Dense ``time_dim``, swish, Dense ``time_dim``,
  projected into every block after a swish; 1x1 ``nin_shortcut``s where
  the width changes; stride-2 3x3 downsampling convs after a (0, 1, 0, 1)
  pad; nearest-2x upsampling and a 3x3 conv.  113,670,913 parameters at 3
  channels in and 1 out (:func:`num_parameters`).
- Module and state-dict names are the DDIM code's (``temb.dense.0``,
  ``down.1.block.0.conv1``, ``down.4.attn.0.q``, ``mid.attn_1``,
  ``up.3.upsample.conv``, ``norm_out``, ``conv_out``), so that code's
  checkpoint loads with ``load_state_dict(strict=True)``.
- The input is NHWC ``[pre, post, x_t]``, as Fast-DDPM's PMUB sampler
  concatenates it (and as :class:`models.diffusion.FastDDPMUNet` takes
  it), the output NHWC, one channel.  Dropout is identity (the published
  PMUB configuration trains without it).

The level pattern is the class's published constants; a config chooses
``ch`` (``base_features``) and ``time_dim`` only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    GroupNorm,
    Linear,
    set_compute_dtype,
    silu,
)
from mrisr_tpu_torch.models.conv import Conv2d
from mrisr_tpu_torch.models.diffusion import (
    timestep_embedding,
    upsample_nearest_2x,
)

CH_MULT = (1, 1, 2, 2, 4, 4)
NUM_RES_BLOCKS = 2
ATTN_RESOLUTIONS = (16,)
RESOLUTION = 256
GN_GROUPS = 32
GN_EPS = 1e-6


def attn_levels() -> Tuple[int, ...]:
    """The levels whose blocks an attention block follows: those at
    :data:`ATTN_RESOLUTIONS` of the published :data:`RESOLUTION`."""
    return tuple(i for i in range(len(CH_MULT))
                 if RESOLUTION >> i in ATTN_RESOLUTIONS)


def level_plan(ch: int) -> Dict[str, List]:
    """The network's ResnetBlocks in the DDIM code's order: ``down`` and
    ``up`` as (level, block, in channels, out channels), an up block's in
    channels counting the down path's output it concatenates
    (``hs.pop()``); ``mid`` the middle's width."""
    last = len(CH_MULT) - 1
    down, widths = [], [ch]  # widths: channels of each output pushed on hs
    block_in = ch
    for i, m in enumerate(CH_MULT):
        for j in range(NUM_RES_BLOCKS):
            down.append((i, j, block_in, ch * m))
            block_in = ch * m
            widths.append(block_in)
        if i != last:
            widths.append(block_in)  # the downsample's
    mid, up = block_in, []
    for i in reversed(range(len(CH_MULT))):
        for j in range(NUM_RES_BLOCKS + 1):
            up.append((i, j, block_in + widths.pop(), ch * CH_MULT[i]))
            block_in = ch * CH_MULT[i]
    return {"down": down, "up": up, "mid": mid}


def param_shapes(ch: int = 128, time_dim: Optional[int] = None,
                 in_channels: int = 3, out_channels: int = 1
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by its DDIM name, without building the
    model."""
    d = 4 * ch if time_dim is None else time_dim
    shapes: Dict[str, Tuple[int, ...]] = {
        "temb.dense.0.weight": (d, ch), "temb.dense.0.bias": (d,),
        "temb.dense.1.weight": (d, d), "temb.dense.1.bias": (d,),
        "conv_in.weight": (ch, in_channels, 3, 3), "conv_in.bias": (ch,)}

    def conv(name, ci, co, k):
        shapes[f"{name}.weight"] = (co, ci, k, k)
        shapes[f"{name}.bias"] = (co,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    def block(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co, 3)
        shapes[f"{name}.temb_proj.weight"] = (co, d)
        shapes[f"{name}.temb_proj.bias"] = (co,)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co, 3)
        if ci != co:
            conv(f"{name}.nin_shortcut", ci, co, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        for p in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{p}", c, c, 1)

    plan = level_plan(ch)
    levels = attn_levels()
    last = len(CH_MULT) - 1
    for i, j, ci, co in plan["down"]:
        block(f"down.{i}.block.{j}", ci, co)
        if i in levels:
            attn(f"down.{i}.attn.{j}", co)
        if j == NUM_RES_BLOCKS - 1 and i != last:
            conv(f"down.{i}.downsample.conv", co, co, 3)
    c = plan["mid"]
    block("mid.block_1", c, c)
    attn("mid.attn_1", c)
    block("mid.block_2", c, c)
    for i, j, ci, co in plan["up"]:
        block(f"up.{i}.block.{j}", ci, co)
        if i in levels:
            attn(f"up.{i}.attn.{j}", co)
        if j == NUM_RES_BLOCKS and i != 0:
            conv(f"up.{i}.upsample.conv", co, co, 3)
    norm("norm_out", ch)
    conv("conv_out", ch, out_channels, 3)
    return shapes


def num_parameters(ch: int = 128, time_dim: Optional[int] = None,
                   in_channels: int = 3, out_channels: int = 1) -> int:
    """113,670,913 at the published widths (3 in, 1 out)."""
    total = 0
    for shape in param_shapes(ch, time_dim, in_channels,
                              out_channels).values():
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def _norm(c: int) -> GroupNorm:
    return GroupNorm(GN_GROUPS, c, eps=GN_EPS)


class ResnetBlock(nn.Module):
    """norm1, swish, conv1, ``+ temb_proj(swish(temb))``, norm2, swish,
    (dropout), conv2, plus ``x`` or ``nin_shortcut(x)``; NCHW."""

    def __init__(self, in_channels: int, out_channels: int, temb: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = Linear(temb, out_channels)
        self.norm2 = _norm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(silu(self.norm1(x)))
        h = h + self.temb_proj(silu(temb))[:, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Single-head attention of ``(B, L, C)`` tokens: ``softmax(q k^T
    C^-1/2)`` over the keys in float32 (the scores from q and k as given,
    accumulated in float32), times ``v`` in ``v``'s type."""
    w = torch.bmm(q.float(), k.float().transpose(1, 2)) * q.shape[-1] ** -0.5
    w = torch.softmax(w, dim=-1)
    return torch.bmm(w.to(v.dtype), v)


class AttnBlock(nn.Module):
    """norm, 1x1 q, k, v, :func:`attention` over the pixels, 1x1
    proj_out, residual; NCHW."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        b, c, hh, ww = x.shape

        def tokens(t):
            return t.reshape(b, c, hh * ww).transpose(1, 2)

        h = attention(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)))
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    """pad (0, 1, 0, 1), then a 3x3 conv at stride 2 (TF's "SAME")."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest_2x(x))


class _Level(nn.Module):
    """One level's ``block`` and ``attn`` lists (and its resampler)."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Temb(nn.Module):
    def __init__(self, ch: int, d: int):
        super().__init__()
        self.dense = nn.ModuleList([Linear(ch, d), Linear(d, d)])


class DDPMUNet(nn.Module):
    """``(B, H, W, 3) + (B,) t -> (B, H, W, 1)`` noise prediction, NHWC at
    the interface; H and W multiples of 32."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 base_features: int = 128, time_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = base_features
        d = 4 * ch if time_dim is None else time_dim
        self.base_features, self.time_dim = ch, d
        self.temb = _Temb(ch, d)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        plan = level_plan(ch)
        levels = attn_levels()
        last = len(CH_MULT) - 1
        self.down = nn.ModuleList(_Level() for _ in CH_MULT)
        for i, j, ci, co in plan["down"]:
            self.down[i].block.append(ResnetBlock(ci, co, d))
            if i in levels:
                self.down[i].attn.append(AttnBlock(co))
            if j == NUM_RES_BLOCKS - 1 and i != last:
                self.down[i].downsample = Downsample(co)
        c = plan["mid"]
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(c, c, d)
        self.mid.attn_1 = AttnBlock(c)
        self.mid.block_2 = ResnetBlock(c, c, d)
        self.up = nn.ModuleList(_Level() for _ in CH_MULT)
        for i, j, ci, co in plan["up"]:
            self.up[i].block.append(ResnetBlock(ci, co, d))
            if i in levels:
                self.up[i].attn.append(AttnBlock(co))
            if j == NUM_RES_BLOCKS and i != 0:
                self.up[i].upsample = Upsample(co)
        self.norm_out = _norm(ch)
        self.conv_out = Conv2d(ch, out_channels, 3, padding=1)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dense = self.temb.dense
        emb = timestep_embedding(t, self.base_features, "ddpm")
        temb = dense[1](silu(dense[0](emb.to(dense[0].weight.dtype))))
        hs = [self.conv_in(x.permute(0, 3, 1, 2))]
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)),
                             temb)
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(silu(self.norm_out(h))).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))
