"""Post-training int8 quantization of the UNet serving path
(counterpart: ``mrisr_tpu/serve/quant.py``).

Same scheme and the same table format as the reference, so tables (and the
bundles that carry them) move between the two packages:

- operates on the BN-folded UNet (``ckpt/fold_bn.py``);
- weights: per-output-channel symmetric int8 (absmax / 127), kept in the
  flax HWIO layout (``w_int8``), with ``scale = a_scale * w_scale``;
- activations: one static symmetric scale per conv input, from the absmax
  (or a percentile of |x|) over calibration batches;
- ``unet_int8_fused_apply``: int8-resident activations.  Every conv is
  kernel A (``ops/conv_int8.py``) with the requantizing epilogue fused;
  the four upconvs are kernel B (``ops/upconv.py``) with the decoder's
  concat fused; only the input and the final output are float.  Tables
  from a pre-r3 calibration (no upconv/final int8 entries) take the
  reference's fallback: the same int8 encoder, kernel A's float epilogue
  at the bottleneck and at each decoder block's second conv, the upconvs
  and the final 1x1 conv in bf16, and 'dual' skip emission.
- ``unet_int8_apply``: the plain int8 forward.  Each 3x3 conv quantizes
  its input with ``quant_input`` and runs kernel A with the float epilogue
  and ReLU; its output is cast to bf16, and max-pool, the upconvs and the
  final 1x1 conv run in bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from mrisr_tpu_torch.ckpt.from_jax import conv_kernel_hwio, convt_kernel_hwio
from mrisr_tpu_torch.device import DeviceLike, fp32_reference, resolve_device
from mrisr_tpu_torch.models.conv import lowp_bias
from mrisr_tpu_torch.models.unet import BLOCKS_DOWN, BLOCKS_UP, UNet
from mrisr_tpu_torch.ops.conv_int8 import (
    conv2d_int8,
    conv2d_int8_plain,
    pack_conv,
)
from mrisr_tpu_torch.ops.upconv import (
    pack_upconv,
    upconv2x2_int8,
    upconv2x2_int8_plain,
)
from mrisr_tpu_torch.utils.profiling import span

BLOCKS = (*BLOCKS_DOWN, "bottleneck", *BLOCKS_UP)
UPCONVS = ("upconv4", "upconv3", "upconv2", "upconv1")
CONVS = ("Conv_0", "Conv_1")


def _require_folded_unet(model, who: str) -> None:
    """Reject anything but a BN-folded port UNet: quantizing an unfolded
    one would silently drop BatchNorm and serve a wrong-but-finite
    forward."""
    if not isinstance(model, UNet):
        raise ValueError(f"{who} expects the port's UNet (enc*/dec*/"
                         f"bottleneck blocks); got {type(model).__name__}")
    if model.use_bn:
        raise ValueError(f"{who} expects a BN-FOLDED UNet (ckpt/fold_bn.py) "
                         "but this one still has BatchNorm layers: fold first")


def _abs_percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(|a|, q)`` (linear interpolation).  Two
    ``kthvalue`` calls instead of ``torch.quantile``, which refuses inputs
    past 2^24 elements (one full-width activation at batch 8 is 33 M)."""
    v = a.abs().float().reshape(-1)
    rank = q / 100.0 * (v.numel() - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, v.numel() - 1)
    v_lo = torch.kthvalue(v, lo + 1).values
    v_hi = torch.kthvalue(v, hi + 1).values
    return v_lo + (v_hi - v_lo) * (rank - lo)


def _unet_float_with_stats(model: UNet, x: torch.Tensor,
                           dtype=torch.bfloat16,
                           percentile: Optional[float] = None):
    """Forward of the folded UNet recording every conv input's range.

    x is NHWC; returns ``(y NHWC float32, stats)`` with 23 stats: both convs
    of the 9 double-conv blocks, the 4 upconv inputs and the final input.
    ``percentile=None`` records absmax, a value (e.g. 99.9) that percentile
    of |x|."""
    if percentile is None:
        def stat(a):
            return a.abs().amax().float()
    else:
        def stat(a):
            return _abs_percentile(a, percentile)
    stats: Dict[str, torch.Tensor] = {}

    def block(name, h):
        for cn, conv in zip(CONVS, getattr(model, name).convs()):
            stats[f"{name}/{cn}"] = stat(h)
            h = F.relu(F.conv2d(h.to(dtype), conv.weight.to(dtype),
                                conv.bias.to(dtype), padding=1))
        return h

    h = x.permute(0, 3, 1, 2)
    skips = []
    for name in BLOCKS_DOWN:
        h = block(name, h)
        skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    h = block("bottleneck", h)
    for name, skip in zip(BLOCKS_UP, reversed(skips)):
        up = getattr(model, f"upconv{name[-1]}")
        stats[f"upconv{name[-1]}"] = stat(h)
        h = F.conv_transpose2d(h.to(dtype), up.weight.to(dtype),
                               up.bias.to(dtype), stride=2)
        h = block(name, torch.cat([h, skip], dim=1))
    stats["final"] = stat(h)
    h = F.conv2d(h.to(dtype), model.final.weight.to(dtype),
                 model.final.bias.to(dtype))
    return h.permute(0, 2, 3, 1).float(), stats


@torch.no_grad()
def calibrate_unet(model: UNet, batches: List, dtype=torch.bfloat16,
                   percentile: Optional[float] = None) -> Dict[str, float]:
    """Per-conv-input absmax (or |x| percentile) over calibration batches.

    model: a BN-folded UNet (on the device the forward should run on).
    batches: ``(B, H, W, 2)`` numpy arrays or tensors."""
    _require_folded_unet(model, "calibrate_unet")
    device = next(model.parameters()).device
    acc: Dict[str, float] = {}
    with fp32_reference():
        for b in batches:
            x = torch.as_tensor(b, dtype=torch.float32).to(device)
            for k, v in _unet_float_with_stats(model, x, dtype,
                                               percentile)[1].items():
                acc[k] = max(acc.get(k, 0.0), float(v))
    return acc


def _quantize_conv(kernel: torch.Tensor, bias: torch.Tensor,
                   a_absmax: float) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel weight + per-layer activation tables."""
    w = kernel.float().cpu()                          # (..., I, O)
    w_scale = w.abs().amax(dim=tuple(range(w.ndim - 1))) / 127.0
    w_int8 = torch.clamp(torch.round(w / torch.clamp_min(w_scale, 1e-12)),
                         -127, 127).to(torch.int8)
    a_scale = torch.tensor(max(a_absmax, 1e-12) / 127.0, dtype=torch.float32)
    return {
        "w_int8": w_int8,
        "a_scale": a_scale,
        "scale": (a_scale * w_scale).float(),
        "bias": bias.detach().float().cpu(),
    }


@torch.no_grad()
def quantize_unet(model: UNet, calib: Dict[str, float]) -> Dict:
    """Folded UNet + calibration ranges -> int8 serving tables (CPU).

    The nested dict has the reference's keys and layouts: per block and
    conv ``{w_int8 (HWIO), a_scale, scale, bias}``; upconvN/final keep their
    bf16 ``kernel``/``bias`` and, when calibrated, int8 tables with an fp32
    ``qbias`` that the int8 epilogues read."""
    _require_folded_unet(model, "quantize_unet")
    out: Dict = {}
    for name in BLOCKS:
        out[name] = {
            cn: _quantize_conv(conv_kernel_hwio(conv.weight), conv.bias,
                               calib[f"{name}/{cn}"])
            for cn, conv in zip(CONVS, getattr(model, name).convs())
        }
    for name in (*UPCONVS, "final"):
        mod = getattr(model, name)
        kernel = (convt_kernel_hwio(mod.weight) if name != "final"
                  else conv_kernel_hwio(mod.weight)).cpu()
        bias = mod.bias.detach().cpu()
        ent = {"kernel": kernel.bfloat16(), "bias": bias.bfloat16()}
        if name in calib:
            ent.update(_quantize_conv(kernel, bias, calib[name]))
            ent["bias"] = bias.bfloat16()
            ent["qbias"] = bias.float()
        out[name] = ent
    return out


def _has_full_tables(qparams: Dict) -> bool:
    """Whether the decoder's upconv/final int8 tables exist (r3-format
    calibrations)."""
    return all("w_int8" in qparams[k] for k in (*UPCONVS, "final"))


def resolve_variants(qparams: Dict, skip_emit: Optional[str] = None) -> str:
    """The skip emission :func:`unet_int8_fused_apply` runs for these
    tables: 'shared' by default on full tables, as in the reference."""
    return skip_emit or ("shared" if _has_full_tables(qparams) else "dual")


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.float().cpu()


def max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool on NHWC int8 codes; it commutes with the monotonic
    quantizer, so pooling the codes equals quantizing the pooled floats."""
    n, h, w, c = x.shape
    return x.view(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def quant_input(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / a_scale), -127,
                       127).to(torch.int8)


def _float_upconv(ent: Dict, dtype: torch.dtype, device):
    """An upconv's float ``kernel``/``bias`` (the reference's bf16 copies)
    as a ConvTranspose2d weight ``(I, O, 2, 2)`` and bias in ``dtype``."""
    w = ent["kernel"].flip(0, 1).permute(2, 3, 0, 1)   # HWIO, flax flip
    return (w.to(device, dtype).contiguous(),
            ent["bias"].to(device, dtype))


def _float_final(ent: Dict, dtype: torch.dtype, device):
    """The final 1x1 conv's float ``kernel``/``bias`` as a Conv2d weight
    ``(O, I, 1, 1)`` and bias in ``dtype``."""
    return (ent["kernel"].permute(3, 2, 0, 1).to(device, dtype).contiguous(),
            ent["bias"].to(device, dtype))


def upconv_float(x: torch.Tensor, wb) -> torch.Tensor:
    """The reference's ``_upconv``: NHWC ConvTranspose(k=2, s=2) in the
    weights' type, rounded, then the bias added in that type."""
    w, b = wb
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(w.dtype), w, stride=2)
    return lowp_bias(y, b).permute(0, 2, 3, 1)


def final_float(x: torch.Tensor, wb) -> torch.Tensor:
    """The final 1x1 conv in the weights' type, bias added after the
    rounding, returned as float32 NHWC."""
    w, b = wb
    y = F.conv2d(x.permute(0, 3, 1, 2).to(w.dtype), w)
    return lowp_bias(y, b).permute(0, 2, 3, 1).float()


class _Site:
    """One kernel-A conv: packed weights and its fp32 epilogue vectors
    (``out_float``: float32 out, the reference's ``_float_epilogue``)."""

    def __init__(self, w_int8, s, b, device, relu=True, out_float=False):
        self.w = pack_conv(w_int8).to(device)
        self.s = s.contiguous().to(device)
        self.b = b.contiguous().to(device)
        self.relu = relu
        self.out_float = out_float


def _requant_site(lq: Dict, a_next, device, in_ratio=None) -> _Site:
    """The reference's ``_requant_epilogue`` factors, in its fp32 order:
    ``s = scale / a_next [* in_ratio]``, ``b = bias / a_next``."""
    s = _f32(lq["scale"]) / a_next
    if in_ratio is not None:
        s = s * in_ratio
    return _Site(lq["w_int8"], s, _f32(lq["bias"]) / a_next, device)


def _float_site(lq: Dict, device) -> _Site:
    """The reference's ``_float_epilogue``: ``acc * scale + bias``, ReLU,
    float32 out (the caller casts it to the compute dtype)."""
    return _Site(lq["w_int8"], _f32(lq["scale"]), _f32(lq["bias"]), device,
                 out_float=True)


class Int8FusedUNet:
    """``unet_int8_fused_apply`` with its tables packed once for a device.

    Full (r3) tables run the int8-resident forward; pre-r3 tables run the
    reference's fallback in ``dtype`` (bf16 upconvs and final conv, 'dual'
    emission; an explicit 'shared' raises, as in the reference).
    ``plain=True`` runs the kernels' plain versions even on the card (the
    reference the kernels are held against).

    Spans (``utils/profiling.py:span``): ``unet.forward`` around a call,
    ``unet.conv`` around each conv site (kernel A, and the final 1x1
    conv's kernel) and ``unet.upconv`` around each kernel-B call, with
    their device time; ``unet.pool`` around each int8 max-pool."""

    def __init__(self, qparams: Dict, skip_emit: Optional[str] = None,
                 device: DeviceLike = None, plain: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        device = resolve_device(device)
        self.full = _has_full_tables(qparams)
        skip_emit = resolve_variants(qparams, skip_emit)
        if skip_emit not in ("shared", "dual"):
            raise ValueError(f"skip_emit must be 'shared' or 'dual', got "
                             f"{skip_emit!r}")
        if skip_emit == "shared" and not self.full:
            raise ValueError(
                "skip_emit='shared' needs the full int8 tables (r3 "
                "calibration with upconv/final entries)")
        self.dtype = dtype
        self._conv = conv2d_int8_plain if plain else conv2d_int8
        self._upconv = upconv2x2_int8_plain if plain else upconv2x2_int8
        a = {f"{blk}/{cn}": _f32(qparams[blk][cn]["a_scale"])
             for blk in BLOCKS for cn in CONVS}
        shared = skip_emit == "shared"
        self.a_in = a["enc1/Conv_0"].to(device)

        # encoder: Conv_0, then Conv_1 emitted once at a scale shared by
        # both consumers (shared) or once per consumer (dual: skip, next)
        self.enc: List = []
        skip_scales = []
        in_ratio = None
        for i, name in enumerate(BLOCKS_DOWN):
            q = qparams[name]
            c0 = _requant_site(q["Conv_0"], a[f"{name}/Conv_1"], device,
                               in_ratio)
            nxt = BLOCKS_DOWN[i + 1] if i + 1 < len(BLOCKS_DOWN) else "bottleneck"
            a_dec, a_nxt = a[f"dec{i + 1}/Conv_0"], a[f"{nxt}/Conv_0"]
            if shared:
                s_sh = torch.maximum(a_dec, a_nxt)
                c1 = [_requant_site(q["Conv_1"], s_sh, device)]
                skip_scales.append(s_sh)
                in_ratio = s_sh / a_nxt
            else:
                c1 = [_requant_site(q["Conv_1"], a_dec, device),
                      _requant_site(q["Conv_1"], a_nxt, device)]
                skip_scales.append(a_dec)
                in_ratio = None
            self.enc.append((c0, c1))

        q = qparams["bottleneck"]
        c0 = _requant_site(q["Conv_0"], a["bottleneck/Conv_1"], device,
                           in_ratio)
        if not self.full:
            self._legacy_decoder(qparams, a, c0, device)
            return
        self.mid = (
            c0,
            _requant_site(q["Conv_1"], _f32(qparams["upconv4"]["a_scale"]),
                          device),
        )

        # decoder: each upconv emits at its skip's actual scale, so the
        # fused concat is uniformly scaled for Conv_0
        self.dec: List = []
        for name, s_sh in zip(BLOCKS_UP, reversed(skip_scales)):
            q = qparams[name]
            up = qparams[f"upconv{name[-1]}"]
            w2, s4, b4 = pack_upconv(up["w_int8"], _f32(up["scale"]) / s_sh,
                                     _f32(up["qbias"]) / s_sh)
            ratio0 = s_sh / a[f"{name}/Conv_0"] if shared else None
            nxt = ("final" if name == "dec1"
                   else f"upconv{int(name[-1]) - 1}")
            self.dec.append((
                (w2.t().to(device).t(), s4.to(device), b4.to(device)),
                _requant_site(q["Conv_0"], a[f"{name}/Conv_1"], device,
                              ratio0),
                _requant_site(q["Conv_1"], _f32(qparams[nxt]["a_scale"]),
                              device),
            ))
        f = qparams["final"]
        self.final = _Site(f["w_int8"], _f32(f["scale"]), _f32(f["qbias"]),
                           device, relu=False, out_float=True)

    def _legacy_decoder(self, qparams: Dict, a: Dict, c0: _Site,
                        device) -> None:
        """The pre-r3 fallback's bottleneck and decoder: the bottleneck's
        Conv_1 through the float epilogue, each decoder block a float
        upconv, ``quant_input`` at its Conv_0 scale, the int8 concat, a
        requantizing Conv_0 and a float Conv_1."""
        self.mid = (c0, _float_site(qparams["bottleneck"]["Conv_1"], device))
        self.dec = []
        for name in BLOCKS_UP:
            q = qparams[name]
            self.dec.append((
                _float_upconv(qparams[f"upconv{name[-1]}"], self.dtype,
                              device),
                a[f"{name}/Conv_0"].to(device),
                _requant_site(q["Conv_0"], a[f"{name}/Conv_1"], device),
                _float_site(q["Conv_1"], device),
            ))
        self.final = _float_final(qparams["final"], self.dtype, device)

    def _run(self, x: torch.Tensor, site: _Site) -> torch.Tensor:
        with span("unet.conv", device_time=True):
            return self._conv(x, site.w, site.s, site.b, relu=site.relu,
                              out_float=site.out_float)

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        with span("unet.pool"):
            return max_pool_int8(x)

    def _encode(self, x: torch.Tensor):
        """The int8 encoder: (the bottleneck's input codes, the skips)."""
        xi = quant_input(x, self.a_in)
        skips = []
        for c0, c1 in self.enc:
            xi = self._run(xi, c0)
            if len(c1) == 1:
                t = self._run(xi, c1[0])
                skips.append(t)
                xi = self._pool(t)
            else:
                skips.append(self._run(xi, c1[0]))
                xi = self._pool(self._run(xi, c1[1]))
        return xi, skips

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 2) float NHWC -> (B, H, W, 1) float32."""
        with span("unet.forward", device_time=True):
            if not self.full:
                return self._legacy(x)
            xi, skips = self._encode(x)
            xi = self._run(self._run(xi, self.mid[0]), self.mid[1])
            for ((w2, s4, b4), c0, c1), skip in zip(self.dec,
                                                    reversed(skips)):
                with span("unet.upconv", device_time=True):
                    xi = self._upconv(xi, w2, s4, b4, skip=skip)
                xi = self._run(self._run(xi, c0), c1)
            return self._run(xi, self.final)

    def _legacy(self, x: torch.Tensor) -> torch.Tensor:
        xi, skips = self._encode(x)
        xf = self._run(self._run(xi, self.mid[0]), self.mid[1]).to(self.dtype)
        for (up, a0, c0, c1), skip in zip(self.dec, reversed(skips)):
            xi = torch.cat([quant_input(upconv_float(xf, up), a0), skip],
                           dim=-1)
            xf = self._run(self._run(xi, c0), c1).to(self.dtype)
        return final_float(xf, self.final)


def unet_int8_fused_apply(qparams: Dict, x: torch.Tensor,
                          skip_emit: Optional[str] = None,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """int8 UNet forward with int8-resident activations on ``x.device``:
    ``(B, H, W, 2) -> (B, H, W, 1)`` (``dtype``: the float layers of the
    pre-r3 fallback).  Packs the tables on every call; a server builds
    :class:`Int8FusedUNet` once instead."""
    return Int8FusedUNet(qparams, skip_emit, device=x.device, dtype=dtype)(x)


class Int8UNet:
    """``unet_int8_apply`` with its tables packed once for a device: the
    plain int8 forward, each 3x3 conv's float output cast to ``dtype``
    (bf16 by default) between the convs.  ``plain=True`` runs kernel A's
    plain version even on the card."""

    def __init__(self, qparams: Dict, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, plain: bool = False):
        device = resolve_device(device)
        self.dtype = dtype
        self._conv = conv2d_int8_plain if plain else conv2d_int8
        self.blocks = {
            name: [(_f32(qparams[name][cn]["a_scale"]).to(device),
                    _float_site(qparams[name][cn], device)) for cn in CONVS]
            for name in BLOCKS}
        self.up = {name: _float_upconv(qparams[name], dtype, device)
                   for name in UPCONVS}
        self.final = _float_final(qparams["final"], dtype, device)

    def _block(self, name: str, h: torch.Tensor) -> torch.Tensor:
        for a, site in self.blocks[name]:
            h = self._conv(quant_input(h, a), site.w, site.s, site.b,
                           relu=True, out_float=True).to(self.dtype)
        return h

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 2) float NHWC -> (B, H, W, 1) float32."""
        h, skips = x, []
        for name in BLOCKS_DOWN:
            h = self._block(name, h)
            skips.append(h)
            h = max_pool_int8(h)
        h = self._block("bottleneck", h)
        for name, skip in zip(BLOCKS_UP, reversed(skips)):
            h = upconv_float(h, self.up[f"upconv{name[-1]}"])
            h = self._block(name, torch.cat([h, skip], dim=-1))
        return final_float(h, self.final)


def unet_int8_apply(qparams: Dict, x: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain int8 UNet forward on ``x.device``: ``(B, H, W, 2) ->
    (B, H, W, 1)``.  Packs the tables on every call; a server builds
    :class:`Int8UNet` once instead."""
    return Int8UNet(qparams, dtype, device=x.device)(x)
