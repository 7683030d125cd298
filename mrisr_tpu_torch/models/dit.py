"""The Diffusion Transformer, DiT-XL/8 (Peebles & Xie 2023, "Scalable
Diffusion Models with Transformers", arXiv:2212.09748;
github.com/facebookresearch/DiT ``models.py``: ``DiT``, ``DiTBlock``,
``FinalLayer``, ``TimestepEmbedder``, ``get_2d_sincos_pos_embed`` and the
named configuration ``DiT_XL_8``), as a pixel-space slice denoiser.

- :class:`DiT`: a ``p x p`` stride-``p`` patch embedding (``x_embedder.
  proj``, row-major tokens) plus DiT's fixed 2D sin-cos table
  (``pos_embed``, :func:`pos_embed_table`, a buffer: not trained); the
  timestep embedding ``c`` (256 sinusoids ``[cos, sin]``, the port's
  ``timestep_embedding(..., 'adm')``, then Linear, SiLU, Linear);
  :data:`DEPTH` :class:`DiTBlock` s (adaLN-Zero: ``(shift1, scale1, gate1,
  shift2, scale2, gate2)`` from ``Linear(SiLU(c))``, ``x + gate1 Attn(LN(x)
  (1 + scale1) + shift1)``, ``x + gate2 MLP(LN(x) (1 + scale2) + shift2)``,
  LN without affine and eps :data:`LN_EPS`, timm's attention with
  :data:`HEADS` heads and its ``(3, heads, ch)`` qkv order, an MLP of
  :data:`MLP_RATIO` times the width with GELU's tanh form); the
  :class:`FinalLayer` (``(shift, scale)`` from ``Linear(SiLU(c))``, a
  Linear of the modulated LN to ``p^2 out`` channels) and the unpatchify.
  DiT-XL/8: hidden 1152, 28 blocks, 16 heads of 72, MLP 4608, patch 8;
  673,995,008 trainable parameters at 3 channels in and 2 out
  (:func:`num_parameters`), and the 1,179,648 entries of ``pos_embed``
  at 256^2 (1024 tokens).
- Module and state-dict names are DiT's (``x_embedder.proj``,
  ``t_embedder.mlp.0``, ``blocks.3.attn.qkv``, ``blocks.3.mlp.fc2``,
  ``blocks.3.adaLN_modulation.1``, ``final_layer.linear``, ``pos_embed``),
  shapes included, so a checkpoint of that code without its class
  embedder loads with ``load_state_dict(strict=True)``.
- The input is NHWC ``[pre, post, x_t]``; the output NHWC with
  ``out_channels`` channels (2: the noise, then the ``learn_sigma``
  variance).  The conditions enter as input channels, as in the other
  sampler networks, so there is no class embedder: ``c`` is the timestep
  embedding alone.  Dropout is identity.

Depth, heads, patch, MLP ratio and the input size that ``pos_embed`` is
built for are the module's published constants, read at construction
(tests set them to their small sizes); a config chooses the width
(``base_features``).  An input of another grid than :data:`INPUT_SIZE`
takes DiT's table for its own grid.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mrisr_tpu_torch.models.adm_unet import qkv_attention
from mrisr_tpu_torch.models.blocks import Linear, SiLU, set_compute_dtype, silu
from mrisr_tpu_torch.models.conv import Conv2d
from mrisr_tpu_torch.models.diffusion import timestep_embedding

DEPTH = 28
HEADS = 16
PATCH = 8
MLP_RATIO = 4
HIDDEN = 1152
FREQ_DIM = 256  # TimestepEmbedder's frequency_embedding_size
LN_EPS = 1e-6
INPUT_SIZE = 256
# the block linears kernel A serves in int8 (``int8_deep``), by their
# names inside a block
BLOCK_LINEARS = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def pos_embed_table(dim: int, grid: int) -> torch.Tensor:
    """DiT's ``get_2d_sincos_pos_embed(dim, grid)`` (MAE's code) as a
    ``(grid^2, dim)`` float32 tensor, tokens row-major: the first half of
    the channels encodes a token's column (``np.meshgrid(grid_w, grid_h)``
    puts w first), the second its row, each half ``[sin(pos w_i), cos(pos
    w_i)]`` with ``w_i = 10000^(-i / (dim / 4))``, in float64 and then
    rounded, as the numpy code is copied into the float32 parameter."""
    if dim % 4:
        raise ValueError(f"pos_embed_table: {dim} channels do not split into "
                         "four quarters")
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 4, dtype=torch.float64)
                              / (dim / 4.0))
    pos = torch.arange(grid, dtype=torch.float64)

    def half(coord):  # (grid^2,) -> (grid^2, dim / 2)
        out = coord[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    rows = pos.repeat_interleave(grid)  # token t = row * grid + col
    cols = pos.repeat(grid)
    return torch.cat([half(cols), half(rows)], dim=1).float()


def param_shapes(hidden: int = HIDDEN, depth: int = DEPTH,
                 patch: int = PATCH, in_channels: int = 3,
                 out_channels: int = 2) -> Dict[str, Tuple[int, ...]]:
    """Every trainable parameter's shape by its DiT name (``pos_embed``,
    a fixed table, is not one)."""
    c, m = hidden, MLP_RATIO * hidden
    shapes: Dict[str, Tuple[int, ...]] = {
        "x_embedder.proj.weight": (c, in_channels, patch, patch),
        "x_embedder.proj.bias": (c,),
        "t_embedder.mlp.0.weight": (c, FREQ_DIM),
        "t_embedder.mlp.0.bias": (c,),
        "t_embedder.mlp.2.weight": (c, c), "t_embedder.mlp.2.bias": (c,)}
    for i in range(depth):
        for name, o, k in (("attn.qkv", 3 * c, c), ("attn.proj", c, c),
                           ("mlp.fc1", m, c), ("mlp.fc2", c, m),
                           ("adaLN_modulation.1", 6 * c, c)):
            shapes[f"blocks.{i}.{name}.weight"] = (o, k)
            shapes[f"blocks.{i}.{name}.bias"] = (o,)
    po = patch * patch * out_channels
    shapes.update({
        "final_layer.linear.weight": (po, c),
        "final_layer.linear.bias": (po,),
        "final_layer.adaLN_modulation.1.weight": (2 * c, c),
        "final_layer.adaLN_modulation.1.bias": (2 * c,)})
    return shapes


def num_parameters(hidden: int = HIDDEN, depth: int = DEPTH,
                   patch: int = PATCH, in_channels: int = 3,
                   out_channels: int = 2) -> int:
    """673,995,008 at DiT-XL/8's widths, 3 in and 2 out."""
    return sum(math.prod(s) for s in param_shapes(
        hidden, depth, patch, in_channels, out_channels).values())


def layer_norm(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """``nn.LayerNorm(C, elementwise_affine=False)`` over the last axis; a
    bf16 input is normalized in float32 and the result rounded once."""
    if x.dtype == torch.bfloat16:
        return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """DiT's ``modulate``: ``x (1 + scale) + shift``, ``(B, C)`` rows over
    the tokens of ``x`` ``(B, T, C)``."""
    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def unpatchify(x: torch.Tensor, grid_h: int, grid_w: int, patch: int
               ) -> torch.Tensor:
    """DiT's ``unpatchify`` (``nhwpqc -> nchpwq``) into NHWC: ``(B, T, p^2
    out)`` tokens, each token's channels in (row, column, channel) order
    -> ``(B, grid_h p, grid_w p, out)``."""
    b, _, po = x.shape
    c = po // (patch * patch)
    return (x.reshape(b, grid_h, grid_w, patch, patch, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, grid_h * patch, grid_w * patch, c))


class Attention(nn.Module):
    """timm's ``Attention`` (qkv bias, no q/k norm): ``qkv`` to ``3 C`` in
    the order (q, k, v) x heads, softmax attention with scale
    ``ch^-1/2``, ``proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"{dim} channels do not split into {heads} heads")
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(qkv_attention(self.qkv(x), self.heads, "timm"))


class Mlp(nn.Module):
    """timm's ``Mlp``: ``fc1``, GELU (tanh form), ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN-Zero: LN, modulate, attention, gated residual; LN, modulate,
    MLP, gated residual."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        self.adaLN_modulation = nn.Sequential(SiLU(), Linear(dim, 6 * dim))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        mods = self.adaLN_modulation(c).to(x.dtype).chunk(6, dim=1)
        shift1, scale1, gate1, shift2, scale2, gate2 = mods
        x = x + gate1.unsqueeze(1) * self.attn(
            modulate(layer_norm(x), shift1, scale1))
        return x + gate2.unsqueeze(1) * self.mlp(
            modulate(layer_norm(x), shift2, scale2))


class FinalLayer(nn.Module):
    """LN, modulate by ``(shift, scale)``, ``linear`` to ``p^2 out``."""

    def __init__(self, dim: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = Linear(dim, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(SiLU(), Linear(dim, 2 * dim))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).to(x.dtype).chunk(2, dim=1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class DiT(nn.Module):
    """``(B, H, W, in_channels) + (B,) t -> (B, H, W, out_channels)``, NHWC
    at the interface; H and W multiples of the patch."""

    def __init__(self, in_channels: int = 3, out_channels: int = 2,
                 hidden: int = HIDDEN, dtype: Optional[torch.dtype] = None):
        super().__init__()
        # the module's constants, read at construction
        self.hidden, self.heads, self.patch = hidden, HEADS, PATCH
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(in_channels, hidden, PATCH,
                                      stride=PATCH)
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Sequential(
            Linear(FREQ_DIM, hidden), SiLU(), Linear(hidden, hidden))
        self.register_buffer("pos_embed", pos_embed_table(
            hidden, INPUT_SIZE // PATCH)[None])
        self.blocks = nn.ModuleList(DiTBlock(hidden, HEADS)
                                    for _ in range(DEPTH))
        self.final_layer = FinalLayer(hidden, PATCH, out_channels)
        set_compute_dtype(self, dtype)

    def positions(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """``(1, T, C)``: ``pos_embed``, or DiT's table for another
        (square) grid."""
        if grid_h * grid_w == self.pos_embed.shape[1]:
            return self.pos_embed
        if grid_h != grid_w:
            raise ValueError(f"DiT's table is square: grid {grid_h} x "
                             f"{grid_w}")
        return pos_embed_table(self.hidden, grid_h)[None].to(
            self.pos_embed.device)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, FREQ_DIM, "adm")
        fc0, _, fc1 = self.t_embedder.mlp
        c = fc1(silu(fc0(emb.to(fc0.weight.dtype))))
        h = self.x_embedder.proj(x.permute(0, 3, 1, 2))
        b, ch, gh, gw = h.shape
        h = h.flatten(2).transpose(1, 2)
        h = (h + self.positions(gh, gw)).to(h.dtype)
        for block in self.blocks:
            h = block(h, c)
        h = unpatchify(self.final_layer(h, c), gh, gw, self.patch)
        return h.to(torch.promote_types(h.dtype, torch.float32))
