"""Plain reference of the DDPM UNet that Fast-DDPM publishes for its PMUB
task (Jiang et al. 2024, arXiv:2405.14802; github.com/mirthAI/Fast-DDPM,
whose network is github.com/ermongroup/ddim ``models/diffusion.py:Model``,
Ho et al. 2020, arXiv:2006.11239), in plain float32 torch.

The denoiser: ``[pre, post, x_t]`` (NHWC) and ``t`` in, the noise
estimate out.  ``get_timestep_embedding(t, ch)`` (sin then cos,
``exp(-ln(1e4) i / (half - 1))``), Dense(ch, 4ch), swish, Dense(4ch, 4ch);
a 3x3 ``conv_in`` to ``ch``; six levels of ``ch`` x (1, 1, 2, 2, 4, 4)
channels, each of two ResnetBlocks (GroupNorm 32 groups eps 1e-6, swish,
3x3 conv, plus ``temb_proj(swish(temb))``, GroupNorm, swish, 3x3 conv,
plus ``x`` or a 1x1 ``nin_shortcut``) with an AttnBlock after each at
16^2, and a stride-2 3x3 conv after a (0, 1, 0, 1) pad between levels; a
middle of block, attention, block; coming up, three blocks a level on
``cat([h, hs.pop()])`` (attention after each at 16^2), nearest 2x and a
3x3 conv between levels; GroupNorm, swish and a 3x3 ``conv_out`` to one
channel.  AttnBlock: GroupNorm, 1x1 q, k, v, ``softmax(q^T k C^-1/2)``
over the keys, v times the weights, 1x1 proj_out, residual.  Parameter
names are the DDIM code's (``down.1.block.0.conv1.weight`` ...).

Departures from the published description, as the configuration's
``assumed`` lists them: the sampler is the one the ``fastddpm`` cell
serves (the reference repository's Fixed-notebook ancestral step over the
10 timesteps of 'nonuniform-4060', :func:`chain`) where Fast-DDPM's own
code samples with DDIM-style generalized steps; the input order is
``[pre, post, x_t]``; dropout is identity (inference).

The sampler: linear betas 1e-4 to 0.02 over 1000 steps (Fast-DDPM's and
DDPM's), and ``x = (x - sqrt(1 - abar) eps) / sqrt(abar) + sigma z``
with ``sigma = sqrt(max((1 - abar_prev) / (1 - abar) beta, 1e-20))`` (no z
at the last step).  The noise is given.

A :class:`reference.unet.Quantizer` over :func:`deep_sites` (every
stride-1 conv below the full-size level, the 1x1 attention projections
and shortcuts too; an upsample's conv by its own, upsampled, input) serves
those sites at its ``bits``: weights per output channel, each input by a
static scale a sampling step, from the absmax over the sampler's own
trajectory on calibration conditions (:func:`calibrated`), as
``int8_deep`` is made.  With the sites ``<attn>.core.q`` (``.k``, ``.v``,
``.p``) it also quantizes the attention core's operands (the tests).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.fastddpm import embedding, nonuniform_4060
from portbench.reference.unet import Quantizer

CH_MULT = (1, 1, 2, 2, 4, 4)
NUM_RES_BLOCKS = 2
ATTN_LEVEL = 4  # 16^2 of a 256^2 input
GROUPS = 32
GN_EPS = 1e-6


def layout(ch: int = 128) -> Tuple[List, int, List]:
    """(down blocks, middle width, up blocks) in the DDIM code's order:
    down ``(level, block, in, out)``, up ``(level, block, in, out)`` with
    ``in`` counting the concatenated skip."""
    down, hs, c = [], [ch], ch
    for i, m in enumerate(CH_MULT):
        for j in range(NUM_RES_BLOCKS):
            down.append((i, j, c, ch * m))
            c = ch * m
            hs.append(c)
        if i < len(CH_MULT) - 1:
            hs.append(c)
    mid, up = c, []
    for i in reversed(range(len(CH_MULT))):
        for j in range(NUM_RES_BLOCKS + 1):
            up.append((i, j, c + hs.pop(), ch * CH_MULT[i]))
            c = ch * CH_MULT[i]
    return down, mid, up


def param_shapes(ch: int = 128, d: Optional[int] = None, cin: int = 3,
                 cout: int = 1) -> Dict[str, Tuple[int, ...]]:
    d = 4 * ch if d is None else d
    s: Dict[str, Tuple[int, ...]] = {
        "temb.dense.0.weight": (d, ch), "temb.dense.0.bias": (d,),
        "temb.dense.1.weight": (d, d), "temb.dense.1.bias": (d,)}

    def conv(name, ci, co, k):
        s[f"{name}.weight"], s[f"{name}.bias"] = (co, ci, k, k), (co,)

    def norm(name, c):
        s[f"{name}.weight"], s[f"{name}.bias"] = (c,), (c,)

    def block(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co, 3)
        s[f"{name}.temb_proj.weight"], s[f"{name}.temb_proj.bias"] = \
            (co, d), (co,)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co, 3)
        if ci != co:
            conv(f"{name}.nin_shortcut", ci, co, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        for p in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{p}", c, c, 1)

    conv("conv_in", cin, ch, 3)
    down, mid, up = layout(ch)
    for i, j, ci, co in down:
        block(f"down.{i}.block.{j}", ci, co)
        if i == ATTN_LEVEL:
            attn(f"down.{i}.attn.{j}", co)
        if j == NUM_RES_BLOCKS - 1 and i < len(CH_MULT) - 1:
            conv(f"down.{i}.downsample.conv", co, co, 3)
    block("mid.block_1", mid, mid)
    attn("mid.attn_1", mid)
    block("mid.block_2", mid, mid)
    for i, j, ci, co in up:
        block(f"up.{i}.block.{j}", ci, co)
        if i == ATTN_LEVEL:
            attn(f"up.{i}.attn.{j}", co)
        if j == NUM_RES_BLOCKS and i > 0:
            conv(f"up.{i}.upsample.conv", co, co, 3)
    norm("norm_out", ch)
    conv("conv_out", ch, cout, 3)
    return s


def num_parameters(ch: int = 128, d: Optional[int] = None, cin: int = 3,
                   cout: int = 1) -> int:
    """113,670,913 at ``ch`` 128, 3 in and 1 out."""
    return sum(int(np.prod(v)) for v in param_shapes(ch, d, cin,
                                                     cout).values())


def deep_sites(ch: int = 128) -> Tuple[str, ...]:
    """The convs ``int8_deep`` serves in int8: stride 1, input below the
    full-size level."""
    out = []
    for name, shape in param_shapes(ch).items():
        if len(shape) != 4 or ".downsample." in name:
            continue
        base = name[:-len(".weight")]
        parts = base.split(".")
        if parts[0] == "mid":
            out.append(base)
        elif parts[0] in ("down", "up"):
            if int(parts[1]) - (parts[2] == "upsample") > 0:
                out.append(base)
    return tuple(out)


def denoiser(w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
             quant: Optional[Quantizer] = None) -> torch.Tensor:
    """``(B, H, W, 3)``, ``(B,)`` -> ``(B, H, W, 1)`` in the weights'
    type; ``quant`` takes its sites' inputs and weights."""
    dt = w["conv_in.weight"].dtype
    ch = w["conv_in.weight"].shape[0]

    def q_act(name, h):
        return quant.act(name, h) if quant is not None else h

    def conv(h, name, stride=1):
        wt = w[f"{name}.weight"]
        if quant is not None:
            h, wt = quant.act(name, h), quant.weight(name, wt)
        pad = wt.shape[-1] // 2 if stride == 1 else 0
        return F.conv2d(h, wt, w[f"{name}.bias"], stride=stride, padding=pad)

    def norm(h, name):
        return F.group_norm(h, GROUPS, w[f"{name}.weight"], w[f"{name}.bias"],
                            GN_EPS)

    emb = embedding(t, ch).to(dt)
    temb = F.linear(F.silu(F.linear(emb, w["temb.dense.0.weight"],
                                    w["temb.dense.0.bias"])),
                    w["temb.dense.1.weight"], w["temb.dense.1.bias"])

    def block(name, h):
        y = conv(F.silu(norm(h, f"{name}.norm1")), f"{name}.conv1")
        y = y + F.linear(F.silu(temb), w[f"{name}.temb_proj.weight"],
                         w[f"{name}.temb_proj.bias"])[:, :, None, None]
        y = conv(F.silu(norm(y, f"{name}.norm2")), f"{name}.conv2")
        if f"{name}.nin_shortcut.weight" in w:
            h = conv(h, f"{name}.nin_shortcut")
        return h + y

    def attn(name, h):
        y = norm(h, f"{name}.norm")
        b, c, hh, ww = h.shape
        q = q_act(f"{name}.core.q", conv(y, f"{name}.q")).reshape(b, c, -1)
        k = q_act(f"{name}.core.k", conv(y, f"{name}.k")).reshape(b, c, -1)
        v = q_act(f"{name}.core.v", conv(y, f"{name}.v")).reshape(b, c, -1)
        p = torch.softmax(torch.bmm(q.transpose(1, 2), k) * c ** -0.5, dim=2)
        p = q_act(f"{name}.core.p", p)
        y = torch.bmm(v, p.transpose(1, 2)).reshape(b, c, hh, ww)
        return h + conv(y, f"{name}.proj_out")

    down, _, up = layout(ch)
    last = len(CH_MULT) - 1
    hs = [conv(x.permute(0, 3, 1, 2).to(dt), "conv_in")]
    for i, j, _, _ in down:
        h = block(f"down.{i}.block.{j}", hs[-1])
        if i == ATTN_LEVEL:
            h = attn(f"down.{i}.attn.{j}", h)
        hs.append(h)
        if j == NUM_RES_BLOCKS - 1 and i < last:
            hs.append(conv(F.pad(hs[-1], (0, 1, 0, 1)),
                           f"down.{i}.downsample.conv", stride=2))
    h = block("mid.block_1", hs[-1])
    h = attn("mid.attn_1", h)
    h = block("mid.block_2", h)
    for i, j, _, _ in up:
        h = block(f"up.{i}.block.{j}", torch.cat([h, hs.pop()], dim=1))
        if i == ATTN_LEVEL:
            h = attn(f"up.{i}.attn.{j}", h)
        if j == NUM_RES_BLOCKS and i > 0:
            h = conv(F.interpolate(h, scale_factor=2.0, mode="nearest"),
                     f"up.{i}.upsample.conv")
    h = conv(F.silu(norm(h, "norm_out")), "conv_out")
    return h.permute(0, 2, 3, 1)


def linear_betas(num_timesteps: int = 1000) -> np.ndarray:
    return np.linspace(1e-4, 0.02, num_timesteps, dtype=np.float64)


def chain(num_timesteps: int = 1000, steps: int = 10
          ) -> List[Tuple[int, float, float, float]]:
    """(t, 1/sqrt(abar), sqrt(1 - abar), sigma) in sampling order."""
    betas = linear_betas(num_timesteps)
    abar = np.cumprod(1.0 - betas)
    ts = nonuniform_4060(num_timesteps, steps)
    out = []
    for k in range(len(ts) - 1, -1, -1):
        t = int(ts[k])
        sigma = 0.0
        if k > 0:
            prev = abar[int(ts[k - 1])]
            sigma = math.sqrt(max((1 - prev) / (1 - abar[t]) * betas[t],
                                  1e-20))
        out.append((t, 1.0 / math.sqrt(abar[t]), math.sqrt(1.0 - abar[t]),
                    sigma))
    return out


def sample(w: Dict[str, torch.Tensor], cond: torch.Tensor,
           x_t: torch.Tensor, zs: Sequence[torch.Tensor],
           quant: Optional[Quantizer] = None, num_timesteps: int = 1000
           ) -> torch.Tensor:
    """The ancestral chain from ``x_t`` with the given ``zs`` (one a step
    but the last): ``(B, H, W, 2)`` conditions -> ``(B, H, W, 1)``;
    ``quant`` sees the step index in its ``step``."""
    steps = chain(num_timesteps, len(zs) + 1)
    dt = w["conv_in.weight"].dtype
    cond, x = cond.to(dt), x_t.to(dt)
    for k, (t, c1, c2, sigma) in enumerate(steps):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        if quant is not None:
            quant.step = k
        eps = denoiser(w, torch.cat([cond, x], dim=-1), tb, quant)
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
    ch = w["conv_in.weight"].shape[0]
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
