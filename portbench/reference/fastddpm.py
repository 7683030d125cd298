"""Plain reference of Fast-DDPM (arXiv:2405.14802), the reference
repository's ``notebooks/FastDDPM_Training_Fixed.ipynb:cell7`` (SURVEY.md
§2.2 M11).

The denoiser: ``[pre, post, x_t]`` (NHWC) and ``t`` in, the noise
estimate out.  A sinusoidal embedding of ``t`` (``exp(-ln(1e4) i /
(half - 1))``, sin then cos) through Linear(d, 2d), SiLU, Linear(2d, d);
a 3x3 ``init_conv`` to ``b`` channels; residual blocks of GroupNorm
(group size 4, eps 1e-5), SiLU, 3x3 conv, plus a Linear projection of the
embedding, GroupNorm, SiLU, 3x3 conv, plus a 1x1 skip where the width
changes; encoder 2b, 4b, 8b with 2x2 max-pool before the last two and the
bottleneck 8b; decoder ConvTranspose(2, 2), skip concat and a block, to
4b, 2b, b; GroupNorm, SiLU and a 3x3 conv to one channel.

The sampler: cosine betas over 1000 steps, the 10 timesteps of
'nonuniform-4060', and the Fixed notebook's ancestral step
``x = (x - sqrt(1 - abar) eps) / sqrt(abar) + sigma z`` with
``sigma = sqrt(max((1 - abar_prev) / (1 - abar) beta, 1e-20))`` (no z at
the last step).  The noise is given.

A :class:`reference.unet.Quantizer` over :data:`DEEP_SITES` (the convs at
128^2 and below and the upconvs into them) serves those sites at its
``bits``: weights per output channel, each input by a static scale a
sampling step, from the absmax over the sampler's own trajectory on
calibration conditions (:func:`calibrated`), as ``int8_deep`` is made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.unet import Quantizer

GN_EPS = 1e-5
DEEP_SITES = (
    "enc2.conv1", "enc2.conv2", "enc2.skip",
    "enc3.conv1", "enc3.conv2", "enc3.skip",
    "bottleneck.conv1", "bottleneck.conv2",
    "upconv3", "dec3.conv1", "dec3.conv2", "dec3.skip",
    "upconv2", "dec2.conv1", "dec2.conv2", "dec2.skip",
)


def blocks(b: int = 64) -> List[Tuple[str, int, int]]:
    """(name, in channels, out channels) of the seven residual blocks."""
    return [("enc1", b, 2 * b), ("enc2", 2 * b, 4 * b), ("enc3", 4 * b, 8 * b),
            ("bottleneck", 8 * b, 8 * b), ("dec3", 12 * b, 4 * b),
            ("dec2", 6 * b, 2 * b), ("dec1", 3 * b, b)]


def upconvs(b: int = 64) -> List[Tuple[str, int, int]]:
    return [("upconv3", 8 * b, 4 * b), ("upconv2", 4 * b, 2 * b),
            ("upconv1", 2 * b, b)]


def param_shapes(b: int = 64, d: int = 128, cin: int = 3
                 ) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {
        "time_emb.fc.0.weight": (2 * d, d), "time_emb.fc.0.bias": (2 * d,),
        "time_emb.fc.2.weight": (d, 2 * d), "time_emb.fc.2.bias": (d,),
        "init_conv.weight": (b, cin, 3, 3), "init_conv.bias": (b,),
    }
    for name, ci, co in blocks(b):
        shapes.update({
            f"{name}.norm1.weight": (ci,), f"{name}.norm1.bias": (ci,),
            f"{name}.conv1.weight": (co, ci, 3, 3), f"{name}.conv1.bias": (co,),
            f"{name}.time_fc.weight": (co, d), f"{name}.time_fc.bias": (co,),
            f"{name}.norm2.weight": (co,), f"{name}.norm2.bias": (co,),
            f"{name}.conv2.weight": (co, co, 3, 3), f"{name}.conv2.bias": (co,),
        })
        if ci != co:
            shapes[f"{name}.skip.weight"] = (co, ci, 1, 1)
            shapes[f"{name}.skip.bias"] = (co,)
    for name, ci, co in upconvs(b):
        shapes[f"{name}.weight"] = (ci, co, 2, 2)
        shapes[f"{name}.bias"] = (co,)
    shapes.update({"final.0.weight": (b,), "final.0.bias": (b,),
                   "final.2.weight": (1, b, 3, 3), "final.2.bias": (1,)})
    return shapes


def num_parameters(b: int = 64, d: int = 128, cin: int = 3) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(b, d, cin).values())


def embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    i = torch.arange(half, dtype=torch.float64, device=t.device)
    args = t.double()[:, None] * torch.exp(-math.log(10000.0) * i
                                           / (half - 1))[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def denoiser(w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
             quant: Optional[Quantizer] = None) -> torch.Tensor:
    """``(B, H, W, 3)``, ``(B,)`` -> ``(B, H, W, 1)`` in the weights'
    type; ``quant`` takes every conv's and upconv's input and weights."""
    dt = w["init_conv.weight"].dtype

    def conv(h, name, pad):
        wt = w[f"{name}.weight"]
        if quant is not None:
            h, wt = quant.act(name, h), quant.weight(name, wt)
        return F.conv2d(h, wt, w[f"{name}.bias"], padding=pad)

    def up(h, name):
        wt = w[f"{name}.weight"]
        if quant is not None:
            h, wt = quant.act(name, h), quant.weight(name, wt, 1)
        return F.conv_transpose2d(h, wt, w[f"{name}.bias"], stride=2)

    def norm_silu(h, name):
        c = h.shape[1]
        return F.silu(F.group_norm(h, max(1, c // 4), w[f"{name}.weight"],
                                   w[f"{name}.bias"], GN_EPS))

    emb = embedding(t, w["time_emb.fc.2.weight"].shape[0]).to(dt)
    emb = F.linear(F.silu(F.linear(emb, w["time_emb.fc.0.weight"],
                                   w["time_emb.fc.0.bias"])),
                   w["time_emb.fc.2.weight"], w["time_emb.fc.2.bias"])

    def block(name, h):
        y = conv(norm_silu(h, f"{name}.norm1"), f"{name}.conv1", 1)
        y = y + F.linear(emb, w[f"{name}.time_fc.weight"],
                         w[f"{name}.time_fc.bias"])[:, :, None, None]
        y = conv(norm_silu(y, f"{name}.norm2"), f"{name}.conv2", 1)
        skip = conv(h, f"{name}.skip", 0) if f"{name}.skip.weight" in w else h
        return y + skip

    h = conv(x.permute(0, 3, 1, 2).to(dt), "init_conv", 1)
    e1 = block("enc1", h)
    e2 = block("enc2", F.max_pool2d(e1, 2, 2))
    e3 = block("enc3", F.max_pool2d(e2, 2, 2))
    h = block("bottleneck", F.max_pool2d(e3, 2, 2))
    h = block("dec3", torch.cat([up(h, "upconv3"), e3], dim=1))
    h = block("dec2", torch.cat([up(h, "upconv2"), e2], dim=1))
    h = block("dec1", torch.cat([up(h, "upconv1"), e1], dim=1))
    h = conv(norm_silu(h, "final.0"), "final.2", 1)
    return h.permute(0, 2, 3, 1)


def cosine_betas(num_timesteps: int = 1000) -> np.ndarray:
    s = 0.008
    steps = np.arange(num_timesteps + 1, dtype=np.float64)
    abar = np.cos(((steps / num_timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    abar = abar / abar[0]
    return np.clip(1.0 - abar[1:] / abar[:-1], 0.0001, 0.9999)


def nonuniform_4060(num_timesteps: int = 1000, steps: int = 10) -> np.ndarray:
    """40 % of the steps over [0, 699], 60 % over [699, T - 1], ceil'd."""
    n1, n2 = int(steps * 0.4), int(steps * 0.6)
    first = (np.ceil(np.linspace(0, 699, n1 + 1)[:-1]) if n1 > 0
             else np.zeros(0))
    second = np.ceil(np.linspace(699, num_timesteps - 1, n2 + 1)[:-1])
    return np.concatenate([first, second]).astype(np.int64)


def chain(num_timesteps: int = 1000, steps: int = 10
          ) -> List[Tuple[int, float, float, float]]:
    """(t, 1/sqrt(abar), sqrt(1 - abar), sigma) in sampling order."""
    betas = cosine_betas(num_timesteps)
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
    dt = w["init_conv.weight"].dtype
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
               steps: int = 10, num_timesteps: int = 1000) -> Quantizer:
    """A :class:`Quantizer` at ``bits`` over :data:`DEEP_SITES`, each
    site's scale a step from the absmax over the float sampler's
    trajectories on the condition batches ``conds`` (noise from one
    generator seeded 0, drawn batch after batch)."""
    quant = Quantizer(bits, DEEP_SITES)
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
