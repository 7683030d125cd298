"""Plain reference of DiT-XL/8 (Peebles & Xie 2023, "Scalable Diffusion
Models with Transformers", arXiv:2212.09748; github.com/facebookresearch/
DiT ``models.py``: ``DiT``, ``DiTBlock``, ``FinalLayer``,
``TimestepEmbedder``, ``get_2d_sincos_pos_embed``, ``DiT_XL_8``) as a
pixel-space slice denoiser, in plain float32 torch, run with TF32 off
(the family's ``compare`` runs it inside ``core.fp32()``).

The denoiser: ``[pre, post, x_t]`` (NHWC) and ``t`` in, two channels out
(the noise estimate, then the ``learn_sigma`` variance).  ``x =
PatchEmbed(img) + pos_embed``: a ``p x p`` stride-``p`` conv, its tokens
row-major, plus DiT's fixed 2D sin-cos table (:func:`pos_embed`).  ``c =
TimestepEmbedder(t)``: 256 sinusoids ``[cos, sin]`` with frequencies
``exp(-ln(1e4) i / 128)``, Linear(256, C), SiLU, Linear(C, C).  Each of the
blocks: ``(shift1, scale1, gate1, shift2, scale2, gate2) = Linear(C,
6 C)(SiLU(c))``; ``x = x + gate1 Attn(LN(x) (1 + scale1) + shift1)``; ``x =
x + gate2 MLP(LN(x) (1 + scale2) + shift2)``; LN over each token's C
channels, no affine, eps 1e-6; timm's ``Attention``: ``qkv`` Linear(C,
3 C) in (3, heads, ch) order, ``softmax(q k^T ch^-1/2) v``, ``proj``; the
MLP Linear(C, 4 C), GELU (tanh form), Linear(4 C, C).  ``FinalLayer``:
``(shift, scale) = Linear(C, 2 C)(SiLU(c))``, Linear(C, p^2 out) of ``LN(x)
(1 + scale) + shift``, then the unpatchify (``nhwpqc -> nchpwq``).
Parameter names and shapes are DiT's (``blocks.3.attn.qkv.weight`` ...).

Departures from ``models.py``, as the configuration's ``assumed`` lists
them: the input is a 256^2 MRI slice triple in pixel space with patch 8
(1024 tokens), where the published models denoise VAE latents; 3 channels
in and 2 out, where they take 4 and give 8; no class embedder (``y_embedder``
is left out: the conditions enter as input channels, and ``c`` is the
timestep embedding alone); the variance channel is computed and not read
(:func:`sample` is the ancestral chain the other sampler cells serve,
from ``reference/fastddpm_pmub``, with a fixed variance); dropout is
identity; the weights are the caller's (the benchmark seeds them, the
adaLN linears and the final layer non-zero, where DiT's init zeroes them).

A :class:`reference.unet.Quantizer` over :func:`deep_sites` (every block's
``qkv``, ``proj``, ``fc1`` and ``fc2``) serves those linears at its
``bits``: each input by a static scale a sampling step from the absmax over
the sampler's own trajectory on calibration conditions (:func:`calibrated`),
each weight per output row, as ``int8_deep`` is made.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.fastddpm_pmub import chain
from portbench.reference.unet import Quantizer

HIDDEN = 1152
DEPTH = 28
HEADS = 16
PATCH = 8
MLP_RATIO = 4
FREQ = 256
LN_EPS = 1e-6
LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def param_shapes(hidden: int = HIDDEN, depth: int = DEPTH,
                 patch: int = PATCH, cin: int = 3, cout: int = 2
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every trainable parameter's shape by its DiT name (the fixed
    ``pos_embed`` table is not one)."""
    c = hidden
    s: Dict[str, Tuple[int, ...]] = {
        "x_embedder.proj.weight": (c, cin, patch, patch),
        "x_embedder.proj.bias": (c,),
        "t_embedder.mlp.0.weight": (c, FREQ), "t_embedder.mlp.0.bias": (c,),
        "t_embedder.mlp.2.weight": (c, c), "t_embedder.mlp.2.bias": (c,)}
    for i in range(depth):
        for name, o, k in (("attn.qkv", 3 * c, c), ("attn.proj", c, c),
                           ("mlp.fc1", MLP_RATIO * c, c),
                           ("mlp.fc2", c, MLP_RATIO * c),
                           ("adaLN_modulation.1", 6 * c, c)):
            s[f"blocks.{i}.{name}.weight"] = (o, k)
            s[f"blocks.{i}.{name}.bias"] = (o,)
    s["final_layer.linear.weight"] = (patch * patch * cout, c)
    s["final_layer.linear.bias"] = (patch * patch * cout,)
    s["final_layer.adaLN_modulation.1.weight"] = (2 * c, c)
    s["final_layer.adaLN_modulation.1.bias"] = (2 * c,)
    return s


def num_parameters(hidden: int = HIDDEN, depth: int = DEPTH,
                   patch: int = PATCH, cin: int = 3, cout: int = 2) -> int:
    """673,995,008 trainable at DiT-XL/8's widths, 3 in and 2 out; the
    fixed ``pos_embed`` (1,179,648 entries at 1024 tokens) apart."""
    return sum(math.prod(v) for v in param_shapes(hidden, depth, patch, cin,
                                                  cout).values())


def pos_embed(dim: int, grid: int) -> torch.Tensor:
    """DiT's ``get_2d_sincos_pos_embed(dim, grid)`` as ``(1, grid^2, dim)``
    float32: ``np.meshgrid(grid_w, grid_h)``, so ``grid[0]`` (which the
    code names ``emb_h``) holds each token's column and fills the first
    half of the channels, the row the second; each half ``[sin(pos w),
    cos(pos w)]``, ``w = 1 / 10000^(i / (dim / 4))``, in float64."""
    gw, gh = torch.meshgrid(torch.arange(grid, dtype=torch.float64),
                            torch.arange(grid, dtype=torch.float64),
                            indexing="xy")
    omega = torch.arange(dim // 4, dtype=torch.float64) / (dim / 4.0)
    omega = 1.0 / 10000.0 ** omega

    def one_d(pos):
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one_d(gw), one_d(gh)], dim=1).float()[None]


def deep_sites(depth: int = DEPTH) -> Tuple[str, ...]:
    """The linears ``int8_deep`` serves in int8: every block's ``qkv``,
    ``proj``, ``fc1`` and ``fc2``."""
    return tuple(f"blocks.{i}.{n}" for i in range(depth) for n in LINEARS)


def embedding(t: torch.Tensor, dim: int = FREQ) -> torch.Tensor:
    """DiT's ``TimestepEmbedder.timestep_embedding``: ``[cos, sin]`` of
    ``t`` times ``exp(-ln(1e4) i / half)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def denoiser(w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor,
             quant: Optional[Quantizer] = None, heads: int = HEADS
             ) -> torch.Tensor:
    """``(B, H, W, 3)``, ``(B,)`` -> ``(B, H, W, 2)`` in the weights'
    type; ``quant`` takes its sites' inputs and weights."""
    wp = w["x_embedder.proj.weight"]
    dt, c, p = wp.dtype, wp.shape[0], wp.shape[-1]
    depth = sum(1 for k in w if k.endswith(".attn.qkv.weight"))

    def linear(h, name):
        wt = w[f"{name}.weight"]
        if quant is not None:
            h, wt = quant.act(name, h), quant.weight(name, wt)
        return F.linear(h, wt, w[f"{name}.bias"])

    def modulate(h, shift, scale):
        h = F.layer_norm(h, (c,), eps=LN_EPS)
        return h * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)

    def attn(name, h):
        b, n, _ = h.shape
        qkv = linear(h, f"{name}.qkv").reshape(b, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        a = torch.softmax((q @ k.transpose(-2, -1)) * (c // heads) ** -0.5,
                          dim=-1)
        return linear((a @ v).transpose(1, 2).reshape(b, n, c),
                      f"{name}.proj")

    def mlp(name, h):
        return linear(F.gelu(linear(h, f"{name}.fc1"), approximate="tanh"),
                      f"{name}.fc2")

    h = F.conv2d(x.permute(0, 3, 1, 2).to(dt), wp, w["x_embedder.proj.bias"],
                 stride=p)
    b, _, gh, gw = h.shape
    pos = w.get("pos_embed")
    if pos is None or pos.shape[1] != gh * gw:
        pos = pos_embed(c, gh).to(h.device)
    h = h.flatten(2).transpose(1, 2) + pos.to(dt)
    cond = F.silu(linear(F.silu(linear(embedding(t).to(dt),
                                       "t_embedder.mlp.0")),
                         "t_embedder.mlp.2"))
    for i in range(depth):
        name = f"blocks.{i}"
        s1, c1, g1, s2, c2, g2 = linear(
            cond, f"{name}.adaLN_modulation.1").chunk(6, dim=1)
        h = h + g1.unsqueeze(1) * attn(f"{name}.attn", modulate(h, s1, c1))
        h = h + g2.unsqueeze(1) * mlp(f"{name}.mlp", modulate(h, s2, c2))
    shift, scale = linear(cond, "final_layer.adaLN_modulation.1").chunk(2,
                                                                         dim=1)
    h = linear(modulate(h, shift, scale), "final_layer.linear")
    out = h.shape[-1] // (p * p)
    h = torch.einsum("nhwpqc->nchpwq", h.reshape(b, gh, gw, p, p, out))
    return h.reshape(b, out, gh * p, gw * p).permute(0, 2, 3, 1)


def sample(w: Dict[str, torch.Tensor], cond: torch.Tensor,
           x_t: torch.Tensor, zs: Sequence[torch.Tensor],
           quant: Optional[Quantizer] = None, num_timesteps: int = 1000,
           heads: int = HEADS) -> torch.Tensor:
    """The ancestral chain from ``x_t`` with the given ``zs`` (one a step
    but the last), reading the denoiser's first channel (the noise):
    ``(B, H, W, 2)`` conditions -> ``(B, H, W, 1)``; ``quant`` sees the
    step index in its ``step``."""
    steps = chain(num_timesteps, len(zs) + 1)
    dt = w["x_embedder.proj.weight"].dtype
    cond, x = cond.to(dt), x_t.to(dt)
    for k, (t, c1, c2, sigma) in enumerate(steps):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        if quant is not None:
            quant.step = k
        eps = denoiser(w, torch.cat([cond, x], dim=-1), tb, quant,
                       heads)[..., :1]
        x = c1 * (x - c2 * eps)
        if k < len(steps) - 1:
            x = x + sigma * zs[k].to(dt)
    return x


def calibrated(w: Dict[str, torch.Tensor], conds, bits: int, device,
               steps: int = 10, num_timesteps: int = 1000,
               heads: int = HEADS, sites=None) -> Quantizer:
    """A :class:`Quantizer` at ``bits`` over ``sites`` (None:
    :func:`deep_sites`), each site's scale a step from the absmax over the
    float sampler's trajectories on the condition batches ``conds`` (noise
    from one generator seeded 0, drawn batch after batch)."""
    depth = sum(1 for k in w if k.endswith(".attn.qkv.weight"))
    quant = Quantizer(bits, deep_sites(depth) if sites is None else sites)
    g = torch.Generator(device=device).manual_seed(0)
    for c in conds:
        c = torch.as_tensor(c).to(device)
        shape = (*c.shape[:-1], 1)

        def draw():
            return torch.randn(shape, generator=g, device=device)

        x_t = draw()
        sample(w, c, x_t, [draw() for _ in range(steps - 1)], quant,
               num_timesteps, heads)
    quant.recording = False
    return quant
