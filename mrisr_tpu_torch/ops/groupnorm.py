"""Kernel K3: fused GroupNorm + SiLU (+ the int8 quantizer), NHWC.

Counterpart: the Pallas TPU kernel ``mrisr_tpu/ops/groupnorm_pallas.py``
(``groupnorm_silu_pallas``, launcher ``_gn_silu_call``).  The CUDA source
is ``csrc/groupnorm_silu.cu``: one cooperative launch a call, walking the
batch in passes of whole samples staged in the grid's shared memory, so x
is read from device memory once; it says what bounds the kernel on the
card: one read of x and one write of the output.  :func:`plan` is its
tiling, in Python so that the CPU tests can check it.

Semantics: ``flax.linen.GroupNorm(num_groups, epsilon)`` (float32
statistics, biased variance E[x^2] - E[x]^2) folded into one multiply-add
per element, then SiLU (``silu=False``: the identity, a GroupNorm with
nothing after it, as an attention block's), then, with ``quant_scale``,
the symmetric int8 quantizer ``clip(round(y * (1 / scale)), -127, 127)``
that the following int8 conv reads.

``shift`` ``(B, C)``: the GroupNorm reads ``x.float() + shift[:, None,
None, :]``, added in float32 as x is read (statistics and apply alike),
never rounded to x's dtype.  The Fast-DDPM forward hands a residual
block's time projection (plus a float conv1's bias) to its norm2 so
(``serve/quant_diffusion.py``): K3 takes the broadcast adds that would
otherwise write and read the sum once more through device memory.  On
the card a shift goes with SiLU, and emits int8 codes or x's own dtype
(what the forward emits there).

``scale_shift`` ``(B, 2 C)``: ADM's ``use_scale_shift_norm``, applied after
the GroupNorm: ``y (1 + scale[b, c]) + shift[b, c]`` with ``scale, shift
= scale_shift.chunk(2, dim=1)`` (a ResBlock's time projection, which the
Fast-DDPM forward hands to its out_layers norm), then SiLU.  The kernel
folds ``(1 + scale)`` and ``shift`` into each sample's per-channel
multiply-add, so it costs no pass over x; like a shift it comes with
SiLU, and emits int8 codes or x's own dtype.

Unlike the TPU kernel there is no eligibility rule: no block has to hold
a whole image, so every shape whose group size is a multiple of 4 (every
DiffResBlock site, and the DDPM UNet's 32 groups of 4 to 32 channels)
runs, 256^2 included, in the convs' own NHWC layout.  The kernel works on
quads of 4 channels, whatever the group size: a quad's sums are its
partials, and a group adds its quads' (``csrc/groupnorm_silu.cu``).

:func:`groupnorm_silu` launches the kernel for a CUDA tensor and runs
:func:`groupnorm_silu_plain` for a CPU tensor; it never falls back.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from mrisr_tpu_torch import _build
from mrisr_tpu_torch.device import sm_count

QUAD = 4         # channels of the kernel's unit; a group size is a multiple
THREADS = 1024   # threads a block (csrc/groupnorm_silu.cu)
SMEM_LIMIT = 232_448  # 227 KB: a block's shared memory on Hopper
_OUT_MODE = {torch.float32: 0, torch.bfloat16: 1}

Scale = Union[float, torch.Tensor, None]


def _scale_tensor(quant_scale, device) -> torch.Tensor:
    return torch.as_tensor(quant_scale, dtype=torch.float32,
                           device=device).reshape(-1)


def groupnorm_silu_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, *, num_groups: int,
                         eps: float = 1e-5, quant_scale: Scale = None,
                         out_dtype: torch.dtype = torch.bfloat16,
                         silu: bool = True,
                         shift: Optional[torch.Tensor] = None,
                         scale_shift: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of K3: the kernel's float32 chain with the group sums
    taken in float64, in plain torch ops.  x ``(B, H, W, C)``; returns int8
    codes with ``quant_scale``, else ``out_dtype``; ``silu=False`` leaves
    SiLU out; ``shift`` ``(B, C)`` is added to x in float32 first;
    ``scale_shift`` ``(B, 2 C)`` folds ``(1 + scale)`` and ``shift`` into
    each sample's multiply-add after the statistics, in float32, as the
    kernel does (``ga (1 + s)``, ``be (1 + s) + shift``, each rounded)."""
    b, h, w, c = x.shape
    gs = c // num_groups
    xf = x.to(torch.float32)
    if shift is not None:
        xf = xf + shift.to(torch.float32)[:, None, None, :]
    xg = xf.reshape(b, h * w, num_groups, gs)
    xd = xg.double()
    n = h * w * gs
    mean = (xd.sum(dim=(1, 3)) / n).float()
    ex2 = ((xd * xd).sum(dim=(1, 3)) / n).float()
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    ga = gamma.to(torch.float32).reshape(num_groups, gs) * inv[..., None]
    be = beta.to(torch.float32).reshape(num_groups, gs) - mean[..., None] * ga
    if scale_shift is not None:
        ss = scale_shift.to(torch.float32).reshape(b, 2, num_groups, gs)
        k = 1.0 + ss[:, 0]
        ga, be = ga * k, be * k + ss[:, 1]
    y = xg * ga[:, None] + be[:, None]
    if silu:
        y = y * torch.sigmoid(y)
    if quant_scale is not None:
        inv_a = 1.0 / _scale_tensor(quant_scale, x.device)
        q = torch.clamp(torch.round(y * inv_a), -127, 127).to(torch.int8)
        return q.reshape(b, h, w, c)
    return y.to(out_dtype).reshape(b, h, w, c)


class Plan(NamedTuple):
    """K3's tiling of an ``(n, hw, c)`` batch: ``passes`` passes of ``spp``
    whole samples, ``bs`` blocks a sample of ``px`` pixels each (the last
    block of a sample fewer), ``spp * bs`` co-resident blocks.  With
    ``one_read`` each block stages its pixels in shared memory and x is
    read once; else the statistics and the apply both read x."""

    spp: int
    bs: int
    px: int
    passes: int
    one_read: bool
    smem: int  # dynamic shared memory a block, bytes

    @property
    def grid(self) -> int:
        return self.spp * self.bs


def _reserve(c: int) -> int:
    """Shared memory a block needs besides x: the partial sums (double2,
    max(THREADS, groups)) and gamma, beta, ga, be (float32, C each)."""
    return 16 * max(THREADS, c // QUAD) + 16 * c


def _blocks(hw: int, spp: int, sms: int) -> Tuple[int, int]:
    """(blocks a sample, pixels a block) with ``spp`` samples on ``sms``
    blocks: pixels a multiple of 4 (16-byte aligned chunks)."""
    px = 4 * math.ceil(math.ceil(hw / max(1, sms // spp)) / 4)
    return math.ceil(hw / px), px


def plan(n: int, hw: int, c: int, itemsize: int, sms: int,
         smem_limit: int = SMEM_LIMIT) -> Plan:
    """The most samples a pass that the grid's shared memory holds (one
    block an SM, ``sms`` SMs), then as few passes as that allows, balanced;
    the two-read form, one sample a pass on every SM, where even one sample
    does not fit."""
    reserve, row = _reserve(c), c * itemsize

    def fits(spp):
        return reserve + _blocks(hw, spp, sms)[1] * row <= smem_limit

    spp = max((s for s in range(1, min(n, sms) + 1) if fits(s)), default=0)
    if spp == 0:
        bs, px = _blocks(hw, 1, sms)
        return Plan(1, bs, px, n, False, reserve)
    passes = math.ceil(n / spp)
    spp = math.ceil(n / passes)
    bs, px = _blocks(hw, spp, sms)
    return Plan(spp, bs, px, passes, True, reserve + px * row)


def groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   *, num_groups: int, eps: float = 1e-5,
                   quant_scale: Scale = None,
                   out_dtype: torch.dtype = torch.bfloat16,
                   silu: bool = True,
                   shift: Optional[torch.Tensor] = None,
                   scale_shift: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Fused GroupNorm + SiLU (+ int8 quantize) on NHWC.

    x ``(B, H, W, C)`` float32 or bfloat16; gamma/beta ``(C,)``.  With
    ``quant_scale`` (a float, or a one-element float32 tensor on x's device:
    the following conv's per-step activation scale, read by the kernel from
    device memory) returns int8 codes; without it, ``out_dtype`` (float32
    or bfloat16).  ``silu=False``: GroupNorm alone.  ``shift`` ``(B, C)``:
    normalize ``x + shift[:, None, None, :]``, the sum in float32 (cast
    once to a float32 copy on x's device; counted in ``launches_shift``
    too); on the card with SiLU, emitting int8 codes or x's dtype.
    ``scale_shift`` ``(B, 2 C)``: ``GN(x) (1 + scale) + shift`` before SiLU
    (ADM's scale-shift norm; counted in ``launches_scale_shift``), under
    the same conditions as a shift, and not with one.  On the card the
    group size must be a multiple of 4, and a grid that cannot be
    co-resident raises (it never falls back)."""
    if x.dim() != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"groupnorm_silu: x {tuple(x.shape)} does not split "
                         f"into {num_groups} groups")
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, gamma, beta, num_groups=num_groups,
                                    eps=eps, quant_scale=quant_scale,
                                    out_dtype=out_dtype, silu=silu,
                                    shift=shift, scale_shift=scale_shift)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    b, h, w, c = x.shape
    group = c // num_groups
    if group % QUAD:
        raise ValueError(f"groupnorm_silu: the kernel takes groups of a "
                         f"multiple of {QUAD} channels, got {group}")
    if x.dtype not in _OUT_MODE or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("groupnorm_silu: x must be a contiguous, 16-byte "
                         "aligned float32 or bfloat16 tensor")
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if gamma.numel() != c or beta.numel() != c:
        raise ValueError("groupnorm_silu: gamma and beta need C values")
    if shift is not None:
        shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
        if (tuple(shift.shape) != (b, c) or not silu or shift.data_ptr() % 16
                or (quant_scale is None and out_dtype != x.dtype)):
            raise ValueError(f"groupnorm_silu: a shift is ({b}, {c}), 16-byte "
                             "aligned, with SiLU, and the output int8 codes "
                             "or x's dtype")
    if scale_shift is not None:
        scale_shift = scale_shift.to(device=x.device,
                                     dtype=torch.float32).contiguous()
        if (tuple(scale_shift.shape) != (b, 2 * c) or not silu
                or shift is not None or scale_shift.data_ptr() % 16
                or (quant_scale is None and out_dtype != x.dtype)):
            raise ValueError(f"groupnorm_silu: a scale_shift is ({b}, "
                             f"{2 * c}), 16-byte aligned, with SiLU and no "
                             "shift, and the output int8 codes or x's dtype")
    if quant_scale is None:
        if out_dtype not in _OUT_MODE:
            raise ValueError(f"groupnorm_silu: out_dtype {out_dtype} is not "
                             "float32 or bfloat16")
        scale, mode, dtype = None, _OUT_MODE[out_dtype], out_dtype
    else:
        scale = _scale_tensor(quant_scale, x.device)
        if scale.numel() != 1 or scale.device != x.device:
            raise ValueError("groupnorm_silu: quant_scale must be one value "
                             f"on {x.device}")
        mode, dtype = 2, torch.int8
    out = torch.empty((b, h, w, c), device=x.device, dtype=dtype)
    if out.numel() == 0:
        return out
    p = plan(b, h * w, c, x.element_size(), sm_count(x.device))
    partial = torch.empty((p.passes, p.grid, c // QUAD, 2),
                          device=x.device, dtype=torch.float64)
    lib = _build.library("groupnorm_silu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.groupnorm_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), gamma.data_ptr(),
            beta.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            None if scale_shift is None else scale_shift.data_ptr(),
            partial.data_ptr(),
            out.data_ptr(), mode, b, h * w, c, group, int(silu), p.spp, p.bs,
            p.px, p.passes, int(p.one_read), p.smem, eps, stream,
        )
    _build.check(err, "groupnorm_silu")
    groupnorm_silu.launches += 1
    groupnorm_silu.launches_shift += int(shift is not None)
    groupnorm_silu.launches_scale_shift += int(scale_shift is not None)
    return out


groupnorm_silu.launches = 0
groupnorm_silu.launches_shift = 0  # the launches that took a shift
groupnorm_silu.launches_scale_shift = 0  # those that took a scale_shift
