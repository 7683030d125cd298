"""Fast-DDPM: conditional diffusion for slice interpolation (counterpart:
``mrisr_tpu/models/diffusion.py``).

- :class:`FastDDPMUNet`, the trained lineage (M11): a time-conditioned
  GroupNorm/SiLU ResBlock UNet, ``[pre, post, x_noisy]`` in, the noise
  estimate out.  13,899,905 parameters at base 64.  Module and state-dict
  names are the reference's (``time_emb.fc.0``, ``enc1.norm1``,
  ``upconv3``, ``final.0`` ...), so a reference ``fastddpm_best.pt`` loads
  with ``load_state_dict(strict=True)``.
- :class:`DiffusionSchedule`: the 1000-step linear or cosine beta table and
  the inference-step selections, computed in numpy float64 and stored as
  float32, as the JAX package does.
- :func:`sample_ancestral`: the Fixed notebook's sampler with its FIX#2
  posterior (abar in the posterior mean), as a Python loop over the steps.
  Noise comes from a ``torch.Generator``, or from ``noise`` (the tests feed
  the JAX package's draws: ``jax.random`` streams cannot be reproduced in
  torch).

- :class:`SimpleDiffusionUNet`, the ModelLoader "Simple" lineage (M10): a
  2-level UNet with the 256-dim time embedding broadcast as input
  channels, ``[x_noisy, pre, post]`` in.  2,162,177 parameters at base 64.
- :class:`FastNoiseSchedule`: the compressed-T schedule of that lineage
  (the 1000-step linear beta table subsampled to T entries; the model sees
  the compressed indices 0..T-1), and :func:`sample_ddim`, its
  deterministic sampler (x first, a final clamp to [-1, 1]).

Both UNets take flax's compute dtype (``dtype=torch.bfloat16``,
``models/blocks.py``): GroupNorm statistics in float32, the time
embedding's dense layers, SiLU and the additive projection in bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.blocks import (
    GroupNorm,
    Linear,
    SiLU,
    UpConv2x2,
    max_pool_2x2,
    set_compute_dtype,
    silu,
)
from mrisr_tpu_torch.models.conv import Conv2d
from mrisr_tpu_torch.utils.profiling import span

GN_EPS = 1e-5


def timestep_embedding(t: torch.Tensor, dim: int,
                       variant: str = "ddpm") -> torch.Tensor:
    """Sinusoidal timestep embedding, ``(B,) -> (B, dim)`` float32.

    'ddpm':   freq = exp(-log(1e4) i / (half - 1))  (Fixed notebook);
    'simple': freq = exp(-log(1e4) i / half)        (ModelLoader)."""
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=t.device)
    if variant == "ddpm":
        freqs = torch.exp(-math.log(10000.0) * i / (half - 1))
    elif variant == "simple":
        freqs = torch.exp(-math.log(10000.0) * i / half)
    else:
        raise ValueError(variant)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimeEmbedding(nn.Module):
    """sinusoidal -> Linear(d, 2d) -> SiLU -> Linear(2d, d)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.fc = nn.Sequential(Linear(dim, 2 * dim), SiLU(),
                                Linear(2 * dim, dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.dim, "ddpm")
        return self.fc(emb.to(self.fc[0].weight.dtype))


def num_groups(channels: int) -> int:
    """GroupNorm groups of every DiffResBlock site: group size 4."""
    return max(1, channels // 4)


class DiffResBlock(nn.Module):
    """GroupNorm/SiLU residual block with an additive time projection, on
    NCHW.  The 1x1 ``skip`` exists only where the width changes."""

    def __init__(self, in_channels: int, features: int, time_dim: int):
        super().__init__()
        self.norm1 = GroupNorm(num_groups(in_channels), in_channels,
                               eps=GN_EPS)
        self.conv1 = Conv2d(in_channels, features, 3, padding=1)
        self.time_fc = Linear(time_dim, features)
        self.norm2 = GroupNorm(num_groups(features), features, eps=GN_EPS)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.skip = (Conv2d(in_channels, features, 1)
                     if in_channels != features else nn.Identity())

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(silu(self.norm1(x)))
        h = h + self.time_fc(t_emb)[:, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        return h + self.skip(x)


class FastDDPMUNet(nn.Module):
    """``(B, H, W, 3) + (B,) t -> (B, H, W, 1)`` noise prediction, NHWC at
    the interface (NCHW views of channels_last memory inside)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 base_features: int = 64, time_dim: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = base_features
        self.base_features = b
        self.time_dim = time_dim
        self.time_emb = TimeEmbedding(time_dim)
        self.init_conv = Conv2d(in_channels, b, 3, padding=1)
        self.enc1 = DiffResBlock(b, 2 * b, time_dim)
        self.enc2 = DiffResBlock(2 * b, 4 * b, time_dim)
        self.enc3 = DiffResBlock(4 * b, 8 * b, time_dim)
        self.bottleneck = DiffResBlock(8 * b, 8 * b, time_dim)
        self.upconv3 = UpConv2x2(8 * b, 4 * b)
        self.dec3 = DiffResBlock(12 * b, 4 * b, time_dim)
        self.upconv2 = UpConv2x2(4 * b, 2 * b)
        self.dec2 = DiffResBlock(6 * b, 2 * b, time_dim)
        self.upconv1 = UpConv2x2(2 * b, b)
        self.dec1 = DiffResBlock(3 * b, b, time_dim)
        self.final = nn.Sequential(
            GroupNorm(num_groups(b), b, eps=GN_EPS), SiLU(),
            Conv2d(b, out_channels, 3, padding=1))
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_emb = self.time_emb(t)
        h = self.init_conv(x.permute(0, 3, 1, 2))
        e1 = self.enc1(h, t_emb)
        e2 = self.enc2(max_pool_2x2(e1), t_emb)
        e3 = self.enc3(max_pool_2x2(e2), t_emb)
        h = self.bottleneck(max_pool_2x2(e3), t_emb)
        h = self.dec3(torch.cat([self.upconv3(h), e3], dim=1), t_emb)
        h = self.dec2(torch.cat([self.upconv2(h), e2], dim=1), t_emb)
        h = self.dec1(torch.cat([self.upconv1(h), e1], dim=1), t_emb)
        h = self.final(h).permute(0, 2, 3, 1)
        return h.to(torch.promote_types(h.dtype, torch.float32))


# --------------------------------------------------------------------------
# the "Simple" UNet2D of the ModelLoader lineage (M10)
# --------------------------------------------------------------------------


class _Block(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 -> ReLU as ``block.{0,2}``, the
    reference's DoubleConv names."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv2d(in_channels, features, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(features, features, 3, padding=1), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NCHW, as ``F.interpolate(scale_factor=2)``
    (the JAX package's ``_upsample_nearest_2x`` on NHWC)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SimpleDiffusionUNet(nn.Module):
    """``(B, H, W, 3) + (B,) t -> (B, H, W, 1)``: the time embedding
    ('simple' sinusoid -> Linear -> ReLU -> Linear) broadcast over the
    image and concatenated as ``time_dim`` input channels, then a 2-level
    UNet (max-pool down, nearest-2x up, skip concat), a 1x1 ``outc``.
    State-dict keys ``time_mlp.{0,2}``, ``inc.block.{0,2}`` ... ``outc``;
    the reference's files wrap them in ``unet.``, which
    ``ckpt/torch_ckpt.py`` strips."""

    def __init__(self, in_channels: int = 3, base_features: int = 64,
                 time_dim: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = base_features
        self.time_dim = time_dim
        self.time_mlp = nn.Sequential(Linear(time_dim, time_dim),
                                      nn.ReLU(inplace=True),
                                      Linear(time_dim, time_dim))
        self.inc = _Block(in_channels + time_dim, b)
        self.down1 = _Block(b, 2 * b)
        self.down2 = _Block(2 * b, 4 * b)
        self.up2 = _Block(6 * b, 2 * b)
        self.up1 = _Block(3 * b, b)
        self.outc = Conv2d(b, 1, 1)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        emb = timestep_embedding(t, self.time_dim, "simple")
        t_emb = self.time_mlp(emb.to(self.time_mlp[0].weight.dtype))
        t_map = t_emb.to(x.dtype)[:, :, None, None].expand(n, self.time_dim,
                                                          h, w)
        c1 = self.inc(torch.cat([x.permute(0, 3, 1, 2), t_map], dim=1))
        c2 = self.down1(max_pool_2x2(c1))
        c3 = self.down2(max_pool_2x2(c2))
        u2 = self.up2(torch.cat([upsample_nearest_2x(c3), c2], dim=1))
        u1 = self.up1(torch.cat([upsample_nearest_2x(u2), c1], dim=1))
        out = self.outc(u1).permute(0, 2, 3, 1)
        return out.to(torch.promote_types(out.dtype, torch.float32))


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------


def _beta_table(num_timesteps: int, beta_schedule: str) -> np.ndarray:
    if beta_schedule == "cosine":
        s = 0.008
        steps = np.arange(num_timesteps + 1, dtype=np.float64)
        abar = np.cos(((steps / num_timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        abar = abar / abar[0]
        betas = 1.0 - (abar[1:] / abar[:-1])
        return np.clip(betas, 0.0001, 0.9999)
    elif beta_schedule == "linear":
        return np.linspace(0.0001, 0.02, num_timesteps)
    raise ValueError(beta_schedule)


def _select_timesteps(num_timesteps: int, num_inference_steps: int,
                      selection: str) -> np.ndarray:
    """Inference timesteps, ascending: 'uniform', 'nonuniform-4060' (40 %
    over [0, 699], 60 % over [699, 999], ceil-based: the trained config),
    'linspace' or 'paper10'."""
    t, s = num_timesteps, num_inference_steps
    if selection == "uniform":
        skip = t // s
        return np.arange(0, t, skip, dtype=np.int64)[:s]
    if selection == "linspace":
        return np.linspace(0, t - 1, s).astype(np.int64)
    if selection == "paper10":
        assert t == 1000 and s == 10
        return np.array([0, 199, 399, 599, 699, 799, 849, 899, 949, 999])
    if selection == "nonuniform-4060":
        n1 = int(s * 0.4)
        n2 = int(s * 0.6)
        stage1 = (
            np.ceil(np.linspace(0, 699, n1 + 1)[:-1]).astype(np.int64)
            if n1 > 0
            else np.zeros(0, np.int64)
        )
        stage2 = np.ceil(np.linspace(699, t - 1, n2 + 1)[:-1]).astype(np.int64)
        return np.concatenate([stage1, stage2])
    raise ValueError(selection)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Full-table schedule; the model sees ORIGINAL timestep values.  CPU
    tensors: float32 tables, int32 ``timesteps`` (ascending)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    timesteps: torch.Tensor

    @staticmethod
    def create(num_timesteps: int = 1000, num_inference_steps: int = 10,
               beta_schedule: str = "linear",
               selection: str = "nonuniform-4060") -> "DiffusionSchedule":
        betas = _beta_table(num_timesteps, beta_schedule)
        alphas = 1.0 - betas
        abar = np.cumprod(alphas)
        ts = _select_timesteps(num_timesteps, num_inference_steps, selection)
        return DiffusionSchedule(
            betas=torch.tensor(betas, dtype=torch.float32),
            alphas=torch.tensor(alphas, dtype=torch.float32),
            alphas_cumprod=torch.tensor(abar, dtype=torch.float32),
            timesteps=torch.tensor(ts, dtype=torch.int32),
        )

    @property
    def num_inference_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def add_noise(self, x0: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise, t the
        ORIGINAL timestep value."""
        return q_sample(self.alphas_cumprod, x0, t, noise)


@dataclass(frozen=True)
class FastNoiseSchedule:
    """Compressed-T schedule (ModelLoader's FastNoiseScheduler): the
    1000-step linear beta table subsampled to T indices, 40 % over
    [0, 699] and 60 % over [699, 999] by truncating ``linspace``; the
    model is conditioned on the compressed indices 0..T-1.  float32 CPU
    tables, computed in numpy float64 as the JAX package computes them."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @staticmethod
    def create(T: int = 10) -> "FastNoiseSchedule":
        betas = np.linspace(1e-4, 0.02, 1000)
        alphas = 1.0 - betas
        abar = np.cumprod(alphas)
        late = int(T * 0.6)
        early = T - late
        idxs = np.sort(np.concatenate([
            np.linspace(0, 699, early).astype(np.int64),
            np.linspace(699, 999, late).astype(np.int64)]))
        return FastNoiseSchedule(
            betas=torch.tensor(betas[idxs], dtype=torch.float32),
            alphas=torch.tensor(alphas[idxs], dtype=torch.float32),
            alphas_cumprod=torch.tensor(abar[idxs], dtype=torch.float32))

    @property
    def T(self) -> int:
        return int(self.betas.shape[0])

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """sqrt(abar_t) x0 + sqrt(1 - abar_t) noise, t the compressed
        index."""
        return q_sample(self.alphas_cumprod, x0, t, noise)


def q_sample(alphas_cumprod: torch.Tensor, x0: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """sqrt(abar[t]) x0 + sqrt(1 - abar[t]) noise, one t a sample."""
    abar = alphas_cumprod.to(x0.device)[t.long()].to(x0.dtype)
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (abar.sqrt().reshape(shape) * x0
            + (1.0 - abar).sqrt().reshape(shape) * noise)


def ancestral_steps(schedule: DiffusionSchedule) -> List[Tuple[int, float,
                                                               float, float]]:
    """Per-step constants of the ancestral chain, in iteration order
    (descending t): ``(t, 1/sqrt(abar), (1-abar)/sqrt(1-abar), sigma)``,
    each evaluated in float32 as the JAX sampler's traced arithmetic does.
    sigma = sqrt(max((1 - abar_prev)/(1 - abar) beta, 1e-20)), 0 at the
    last step."""
    one = np.float32(1.0)
    ts = schedule.timesteps.numpy()
    abar_all = schedule.alphas_cumprod.numpy()
    alphas = schedule.alphas.numpy()
    out = []
    for k in range(len(ts) - 1, -1, -1):
        t = int(ts[k])
        abar = abar_all[t]
        c1 = one / np.sqrt(abar)
        c2 = (one - abar) / np.sqrt(one - abar)
        sigma = np.float32(0.0)
        if k > 0:
            abar_prev = abar_all[int(ts[k - 1])]
            pvar = np.maximum((one - abar_prev) / (one - abar)
                              * (one - alphas[t]), np.float32(1e-20))
            sigma = np.sqrt(pvar)
        out.append((t, float(c1), float(c2), float(sigma)))
    return out


Noise = Tuple[torch.Tensor, Sequence[torch.Tensor]]


def sample_ancestral(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cond: torch.Tensor,
    generator: Optional[torch.Generator],
    schedule: DiffusionSchedule,
    num_samples: int = 3,
    combine: str = "first",
    noise=None,
) -> torch.Tensor:
    """Ancestral sampler of the Fixed notebook, FIX#2 semantics: the
    posterior mean uses abar_t where vanilla DDPM uses alpha_t; the
    posterior variance uses beta_t = 1 - alpha_t, clamped at 1e-20.

    eps_fn(x_in (B, H, W, 3), t (B,) int32) -> (B, H, W, 1); cond
    ``(B, H, W, 2) = [pre, post]`` on the device the chain runs on.
    Returns ``(B, H, W, 1)`` float32.

    combine='first' (or 'last') runs one chain; 'mean' averages
    ``num_samples`` chains.  ``generator`` draws x_T and one z per step
    but the last (``None``: seeded 0 on cond's device).  ``noise`` replaces
    the draws: ``(x_T, zs)`` with ``len(zs) == steps - 1`` in iteration
    order, or, for 'mean', a sequence of ``num_samples`` such pairs.  The
    loop never waits on the host: the constants are Python floats and t
    is filled on the device.  Each step is a span, ``sampler.step`` with
    its device time (``utils/profiling.py:span``)."""
    b, h, w, _ = cond.shape
    device = cond.device
    steps = ancestral_steps(schedule)
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def draw():
        return torch.randn((b, h, w, 1), generator=generator, device=device,
                           dtype=torch.float32)

    def one_chain(chain_noise: Optional[Noise]) -> torch.Tensor:
        x = (draw() if chain_noise is None
             else torch.as_tensor(chain_noise[0], dtype=torch.float32,
                                  device=device))
        for k, (t, c1, c2, sigma) in enumerate(steps):
            with span("sampler.step", device_time=True, step=k):
                t_batch = torch.full((b,), t, dtype=torch.int32,
                                     device=device)
                eps = eps_fn(torch.cat([cond, x], dim=-1), t_batch)
                x = c1 * (x - c2 * eps)
                if k < len(steps) - 1:
                    z = (draw() if chain_noise is None
                         else torch.as_tensor(chain_noise[1][k],
                                              dtype=torch.float32,
                                              device=device))
                    x = x + sigma * z
        return x

    if combine in ("first", "last"):
        return one_chain(noise)
    if combine == "mean":
        chains = [one_chain(None if noise is None else noise[i])
                  for i in range(num_samples)]
        return torch.stack(chains).mean(dim=0)
    raise ValueError(combine)


def sample_ddim(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cond: torch.Tensor,
    generator: Optional[torch.Generator],
    schedule: FastNoiseSchedule,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic DDIM-style sampler over the compressed schedule
    (ModelLoader's ``sample``): from x_T ~ N(0, 1), for i = T-1 .. 0,
    ``x0 = (x - sqrt(1 - abar_i) eps) / sqrt(abar_i)`` and
    ``x = sqrt(abar_{i-1}) x0 + sqrt(1 - abar_{i-1}) eps`` (abar_{-1} = 1),
    then a clamp to [-1, 1].  The model sees ``[x, cond]``: x FIRST.

    cond ``(B, H, W, 2)``; ``generator`` draws x_T (``None``: seeded 0 on
    cond's device), or ``noise`` gives it (the tests pass the JAX
    package's draw).  The constants are float32 values, as the JAX
    sampler's traced arithmetic computes them."""
    b, h, w, _ = cond.shape
    device = cond.device
    if noise is not None:
        x = torch.as_tensor(noise, dtype=torch.float32, device=device)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((b, h, w, 1), generator=generator, device=device,
                        dtype=torch.float32)
    one = np.float32(1.0)
    abar_all = schedule.alphas_cumprod.numpy()
    for i in range(schedule.T - 1, -1, -1):
        abar = abar_all[i]
        abar_prev = abar_all[i - 1] if i > 0 else one
        t_batch = torch.full((b,), i, dtype=torch.int32, device=device)
        eps = eps_fn(torch.cat([x, cond], dim=-1), t_batch)
        x0 = (x - float(np.sqrt(one - abar)) * eps) / float(np.sqrt(abar))
        x = (float(np.sqrt(abar_prev)) * x0
             + float(np.sqrt(one - abar_prev)) * eps)
    return x.clamp(-1.0, 1.0)
