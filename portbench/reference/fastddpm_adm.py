"""Plain reference of ADM's diffusion UNet (Dhariwal & Nichol 2021,
arXiv:2105.05233; github.com/openai/guided-diffusion
``guided_diffusion/unet.py:UNetModel``) at its 256^2 settings, in plain
float32 torch.

The denoiser: ``[pre, post, x_t]`` (NHWC) and ``t`` in, two channels out
(the noise estimate, then the learned variance's interpolation,
``learn_sigma``).  ``timestep_embedding(t, ch)`` (``[cos, sin]``,
``exp(-ln(1e4) i / half)``), Linear(ch, 4ch), SiLU, Linear(4ch, 4ch); a 3x3
first conv to ``ch``; six levels of ``ch`` x (1, 1, 2, 2, 4, 4) channels,
two ResBlocks a level going down and three coming up on ``cat([h,
hs.pop()])``, a down-ResBlock between levels going down (a 2x2 average
pool of h and x after its first SiLU) and an up-ResBlock coming up (a
nearest 2x repeat there); a middle of ResBlock, attention, ResBlock.
ResBlock: GroupNorm (32 groups, eps 1e-5), SiLU, 3x3 conv; SiLU and a
Linear of the embedding to ``2 C``, (scale, shift); GroupNorm, ``* (1 +
scale) + shift``, SiLU, 3x3 conv; plus x or a 1x1 ``skip_connection``.
AttentionBlock after each ResBlock at 32^2, 16^2 and 8^2 and in the
middle: GroupNorm, a 1x1 ``qkv`` (Conv1d) to ``3 C``, ``QKVAttentionLegacy``
with ``C / 64`` heads (the channels split head by head into q, k, v;
``q`` and ``k`` scaled by ``ch^-1/4``, softmax over the keys, times v),
a 1x1 ``proj_out``, residual.  Then GroupNorm, SiLU and a 3x3 conv.
Parameter names and shapes are guided-diffusion's
(``input_blocks.1.0.in_layers.2.weight`` ...).

Departures from the published model, as the configuration's ``assumed``
lists them: 3 channels in (``[pre, post, x_t]``) where it takes RGB, and 2
out where it gives 6; the sampler is the one the other sampler cells serve
(:func:`sample`: the reference repository's Fixed-notebook ancestral step
over 10 timesteps of 'nonuniform-4060', from ``reference/fastddpm_pmub``)
with a fixed variance, so the variance channel is computed and not read,
where ADM samples with its learned range; dropout is identity.

A :class:`reference.unet.Quantizer` over :func:`deep_sites` (every conv
whose input, after any pool or repeat, is below the full-size level: the
1x1 ``qkv``, ``proj_out`` and skips too) serves those sites at its
``bits``, each input by a static scale a sampling step from the absmax
over the sampler's own trajectory on calibration conditions
(:func:`calibrated`), as ``int8_deep`` is made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.fastddpm_pmub import chain
from portbench.reference.unet import Quantizer

CH_MULT = (1, 1, 2, 2, 4, 4)
NUM_RES_BLOCKS = 2
ATTN_LEVELS = (3, 4, 5)  # 32^2, 16^2 and 8^2 of a 256^2 input
HEAD_CHANNELS = 64
GROUPS = 32
GN_EPS = 1e-5


def layout(ch: int = 256) -> Tuple[List, int, List]:
    """(input blocks, middle width, output blocks) in guided-diffusion's
    order: an input block ``(kind, level written, in, out)`` with kind
    'conv', 'res' or 'down'; an output block ``(level, in, out, up)``, in
    counting the concatenated skip, ``up`` an up-ResBlock after it."""
    last = len(CH_MULT) - 1
    inputs, chans, c = [("conv", 0, 0, ch)], [ch], ch
    for i, m in enumerate(CH_MULT):
        for _ in range(NUM_RES_BLOCKS):
            inputs.append(("res", i, c, ch * m))
            c = ch * m
            chans.append(c)
        if i < last:
            inputs.append(("down", i + 1, c, c))
            chans.append(c)
    mid, outputs = c, []
    for i in reversed(range(last + 1)):
        for j in range(NUM_RES_BLOCKS + 1):
            outputs.append((i, c + chans.pop(), ch * CH_MULT[i],
                            i > 0 and j == NUM_RES_BLOCKS))
            c = ch * CH_MULT[i]
    return inputs, mid, outputs


def _blocks(ch: int):
    """Every ResBlock and AttentionBlock as (kind, name, level read, level
    written, in, out): kind 'res', 'down', 'up' or 'attn'."""
    inputs, mid, outputs = layout(ch)
    out = []
    for k, (kind, lvl, ci, co) in enumerate(inputs):
        if kind == "conv":
            continue
        out.append((kind, f"input_blocks.{k}.0",
                    lvl - (kind == "down"), lvl, ci, co))
        if kind == "res" and lvl in ATTN_LEVELS:
            out.append(("attn", f"input_blocks.{k}.1", lvl, lvl, co, co))
    last = len(CH_MULT) - 1
    out += [("res", "middle_block.0", last, last, mid, mid),
            ("attn", "middle_block.1", last, last, mid, mid),
            ("res", "middle_block.2", last, last, mid, mid)]
    for k, (lvl, ci, co, up) in enumerate(outputs):
        out.append(("res", f"output_blocks.{k}.0", lvl, lvl, ci, co))
        attn = lvl in ATTN_LEVELS
        if attn:
            out.append(("attn", f"output_blocks.{k}.1", lvl, lvl, co, co))
        if up:
            out.append(("up", f"output_blocks.{k}.{1 + attn}", lvl, lvl - 1,
                        co, co))
    return out


def param_shapes(ch: int = 256, d: Optional[int] = None, cin: int = 3,
                 cout: int = 2) -> Dict[str, Tuple[int, ...]]:
    d = 4 * ch if d is None else d
    s: Dict[str, Tuple[int, ...]] = {
        "time_embed.0.weight": (d, ch), "time_embed.0.bias": (d,),
        "time_embed.2.weight": (d, d), "time_embed.2.bias": (d,),
        "input_blocks.0.0.weight": (ch, cin, 3, 3),
        "input_blocks.0.0.bias": (ch,)}
    for kind, name, _, _, ci, co in _blocks(ch):
        if kind == "attn":
            s[f"{name}.norm.weight"] = s[f"{name}.norm.bias"] = (co,)
            s[f"{name}.qkv.weight"], s[f"{name}.qkv.bias"] = \
                (3 * co, co, 1), (3 * co,)
            s[f"{name}.proj_out.weight"], s[f"{name}.proj_out.bias"] = \
                (co, co, 1), (co,)
            continue
        s[f"{name}.in_layers.0.weight"] = s[f"{name}.in_layers.0.bias"] = \
            (ci,)
        s[f"{name}.in_layers.2.weight"] = (co, ci, 3, 3)
        s[f"{name}.in_layers.2.bias"] = (co,)
        s[f"{name}.emb_layers.1.weight"] = (2 * co, d)
        s[f"{name}.emb_layers.1.bias"] = (2 * co,)
        s[f"{name}.out_layers.0.weight"] = s[f"{name}.out_layers.0.bias"] = \
            (co,)
        s[f"{name}.out_layers.3.weight"] = (co, co, 3, 3)
        s[f"{name}.out_layers.3.bias"] = (co,)
        if ci != co:
            s[f"{name}.skip_connection.weight"] = (co, ci, 1, 1)
            s[f"{name}.skip_connection.bias"] = (co,)
    s["out.0.weight"] = s["out.0.bias"] = (ch,)
    s["out.2.weight"], s["out.2.bias"] = (cout, ch, 3, 3), (cout,)
    return s


def num_parameters(ch: int = 256, d: Optional[int] = None, cin: int = 3,
                   cout: int = 2) -> int:
    """552,804,866 at ``ch`` 256, 3 in and 2 out (552,814,086 at the
    released model's 3 in and 6 out)."""
    return sum(math.prod(v) for v in param_shapes(ch, d, cin, cout).values())


def conv_levels(ch: int = 256) -> Dict[str, int]:
    """The level of the maps each conv reads (0: full size), after a
    down-ResBlock's pool or an up-ResBlock's repeat."""
    out = {"input_blocks.0.0": 0, "out.2": 0}
    for kind, name, lvl_in, lvl_out, ci, co in _blocks(ch):
        if kind == "attn":
            out[f"{name}.qkv"] = out[f"{name}.proj_out"] = lvl_in
            continue
        out[f"{name}.in_layers.2"] = out[f"{name}.out_layers.3"] = lvl_out
        if ci != co:
            out[f"{name}.skip_connection"] = lvl_in
    return out


def deep_sites(ch: int = 256) -> Tuple[str, ...]:
    """The convs ``int8_deep`` serves in int8: input below the full-size
    level."""
    return tuple(n for n, lvl in conv_levels(ch).items() if lvl > 0)


def embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """guided-diffusion's ``timestep_embedding``: ``[cos, sin]`` of ``t``
    times ``exp(-ln(1e4) i / half)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def denoiser(w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
             quant: Optional[Quantizer] = None) -> torch.Tensor:
    """``(B, H, W, 3)``, ``(B,)`` -> ``(B, H, W, 2)`` in the weights'
    type; ``quant`` takes its sites' inputs and weights."""
    dt = w["input_blocks.0.0.weight"].dtype
    ch = w["input_blocks.0.0.weight"].shape[0]

    def conv(h, name):
        wt = w[f"{name}.weight"]
        if quant is not None:
            h, wt = quant.act(name, h), quant.weight(name, wt)
        if wt.dim() == 3:
            return F.conv1d(h, wt, w[f"{name}.bias"])
        return F.conv2d(h, wt, w[f"{name}.bias"], padding=wt.shape[-1] // 2)

    def norm(h, name):
        return F.group_norm(h, GROUPS, w[f"{name}.weight"], w[f"{name}.bias"],
                            GN_EPS)

    emb = embedding(t, ch).to(dt)
    emb = F.linear(F.silu(F.linear(emb, w["time_embed.0.weight"],
                                   w["time_embed.0.bias"])),
                   w["time_embed.2.weight"], w["time_embed.2.bias"])

    def res(name, h, resample=None):
        y = F.silu(norm(h, f"{name}.in_layers.0"))
        if resample == "down":
            y, h = F.avg_pool2d(y, 2), F.avg_pool2d(h, 2)
        elif resample == "up":
            y = F.interpolate(y, scale_factor=2.0, mode="nearest")
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
        y = conv(y, f"{name}.in_layers.2")
        e = F.linear(F.silu(emb), w[f"{name}.emb_layers.1.weight"],
                     w[f"{name}.emb_layers.1.bias"])[:, :, None, None]
        scale, shift = e.chunk(2, dim=1)
        y = norm(y, f"{name}.out_layers.0") * (1 + scale) + shift
        y = conv(F.silu(y), f"{name}.out_layers.3")
        if f"{name}.skip_connection.weight" in w:
            h = conv(h, f"{name}.skip_connection")
        return h + y

    def attn(name, h):
        b, c, hh, ww = h.shape
        x3 = h.reshape(b, c, hh * ww)
        qkv = conv(norm(x3, f"{name}.norm"), f"{name}.qkv")
        heads = c // HEAD_CHANNELS
        q, k, v = qkv.reshape(b * heads, 3 * HEAD_CHANNELS, -1).split(
            HEAD_CHANNELS, dim=1)
        scale = 1 / math.sqrt(math.sqrt(HEAD_CHANNELS))
        weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).to(weight.dtype)
        a = torch.einsum("bts,bcs->bct", weight, v).reshape(b, c, -1)
        return (x3 + conv(a, f"{name}.proj_out")).reshape(b, c, hh, ww)

    h = conv(x.permute(0, 3, 1, 2).to(dt), "input_blocks.0.0")
    hs = [h]
    inputs, _, outputs = layout(ch)
    for k, (kind, lvl, _, _) in enumerate(inputs):
        if kind == "conv":
            continue
        h = res(f"input_blocks.{k}.0", h, "down" if kind == "down" else None)
        if kind == "res" and lvl in ATTN_LEVELS:
            h = attn(f"input_blocks.{k}.1", h)
        hs.append(h)
    h = res("middle_block.0", h)
    h = attn("middle_block.1", h)
    h = res("middle_block.2", h)
    for k, (lvl, _, _, up) in enumerate(outputs):
        h = res(f"output_blocks.{k}.0", torch.cat([h, hs.pop()], dim=1))
        if lvl in ATTN_LEVELS:
            h = attn(f"output_blocks.{k}.1", h)
        if up:
            h = res(f"output_blocks.{k}.{1 + (lvl in ATTN_LEVELS)}", h, "up")
    h = conv(F.silu(norm(h, "out.0")), "out.2")
    return h.permute(0, 2, 3, 1)


def sample(w: Dict[str, torch.Tensor], cond: torch.Tensor,
           x_t: torch.Tensor, zs: Sequence[torch.Tensor],
           quant: Optional[Quantizer] = None, num_timesteps: int = 1000
           ) -> torch.Tensor:
    """The ancestral chain from ``x_t`` with the given ``zs`` (one a step
    but the last), reading the denoiser's first channel (the noise):
    ``(B, H, W, 2)`` conditions -> ``(B, H, W, 1)``; ``quant`` sees the
    step index in its ``step``."""
    steps = chain(num_timesteps, len(zs) + 1)
    dt = w["input_blocks.0.0.weight"].dtype
    cond, x = cond.to(dt), x_t.to(dt)
    for k, (t, c1, c2, sigma) in enumerate(steps):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        if quant is not None:
            quant.step = k
        eps = denoiser(w, torch.cat([cond, x], dim=-1), tb, quant)[..., :1]
        x = c1 * (x - c2 * eps)
        if k < len(steps) - 1:
            x = x + sigma * zs[k].to(dt)
    return x


def calibrated(w: Dict[str, torch.Tensor], conds, bits: int, device,
               steps: int = 10, num_timesteps: int = 1000,
               sites=None) -> Quantizer:
    """A :class:`Quantizer` at ``bits`` over ``sites`` (None:
    :func:`deep_sites`), each site's scale a step from the absmax over the
    float sampler's trajectories on the condition batches ``conds`` (noise
    from one generator seeded 0, drawn batch after batch)."""
    ch = w["input_blocks.0.0.weight"].shape[0]
    quant = Quantizer(bits, deep_sites(ch) if sites is None else sites)
    g = torch.Generator(device=device).manual_seed(0)
    for c in conds:
        c = torch.as_tensor(c).to(device)
        shape = (*c.shape[:-1], 1)

        def draw():
            return torch.randn(shape, generator=g, device=device)

        x_t = draw()
        sample(w, c, x_t, [draw() for _ in range(steps - 1)], quant,
               num_timesteps)
    quant.recording = False
    return quant
