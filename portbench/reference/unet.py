"""Plain reference of the M2 UNet (SURVEY.md §2.2 M2; U-Net, arXiv:1505.04597).

Two neighbouring slices in, the slice between them out, NHWC at the
interface.  Encoder f, 2f, 4f, 8f of (3x3 conv, BatchNorm, ReLU) x 2 with
2x2 max-pool, bottleneck 16f, decoder ConvTranspose(2, 2) + skip concat +
the same double conv, a 1x1 head.  BatchNorm in eval form (running
statistics, eps 1e-5).  The parameter names are the reference checkpoint's
(``enc1.conv.0.weight`` ... ``final.weight``).

:func:`forward` is the float model.  :func:`forward_served` is the same
model as a server computes it at ``bits`` (the control: 4): BatchNorm
folded into each conv, every conv's and upconv's weights symmetric per
output channel, and each one's input by one static scale from the absmax
over calibration batches (:func:`calibrated`), held in the float type.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
DOWN = ("enc1", "enc2", "enc3", "enc4")
UP = ("dec4", "dec3", "dec2", "dec1")


def blocks(f: int = 64, cin: int = 2) -> List[Tuple[str, int, int]]:
    """(name, in channels, out channels) of the nine double convs."""
    return [("enc1", cin, f), ("enc2", f, 2 * f), ("enc3", 2 * f, 4 * f),
            ("enc4", 4 * f, 8 * f), ("bottleneck", 8 * f, 16 * f),
            ("dec4", 16 * f, 8 * f), ("dec3", 8 * f, 4 * f),
            ("dec2", 4 * f, 2 * f), ("dec1", 2 * f, f)]


def upconvs(f: int = 64) -> List[Tuple[str, int, int]]:
    """(name, in channels, out channels) of the four 2x2 upconvs."""
    return [("upconv4", 16 * f, 8 * f), ("upconv3", 8 * f, 4 * f),
            ("upconv2", 4 * f, 2 * f), ("upconv1", 2 * f, f)]


def param_shapes(f: int = 64, cin: int = 2, cout: int = 1
                 ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and BatchNorm statistic, by name."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, ci, co in blocks(f, cin):
        for conv, bn, c_in in ((0, 1, ci), (3, 4, co)):
            shapes[f"{name}.conv.{conv}.weight"] = (co, c_in, 3, 3)
            shapes[f"{name}.conv.{conv}.bias"] = (co,)
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{name}.conv.{bn}.{leaf}"] = (co,)
    for name, ci, co in upconvs(f):
        shapes[f"{name}.weight"] = (ci, co, 2, 2)
        shapes[f"{name}.bias"] = (co,)
    shapes["final.weight"] = (cout, f, 1, 1)
    shapes["final.bias"] = (cout,)
    return shapes


def num_parameters(f: int = 64, cin: int = 2, cout: int = 1) -> int:
    """Trainable parameters (BatchNorm statistics are not)."""
    n = 0
    for name, shape in param_shapes(f, cin, cout).items():
        if not name.endswith(("running_mean", "running_var")):
            k = 1
            for d in shape:
                k *= d
            n += k
    return n


def _bn(h, w, name):
    s = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + BN_EPS)
    return ((h - w[f"{name}.running_mean"][:, None, None]) * s[:, None, None]
            + w[f"{name}.bias"][:, None, None])


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 2) -> (B, H, W, 1)`` in the weights' type."""
    dt = w["final.weight"].dtype

    def block(name, h):
        for conv, bn in ((0, 1), (3, 4)):
            h = F.conv2d(h, w[f"{name}.conv.{conv}.weight"],
                         w[f"{name}.conv.{conv}.bias"], padding=1)
            h = F.relu(_bn(h, w, f"{name}.conv.{bn}"))
        return h

    h = x.permute(0, 3, 1, 2).to(dt)
    skips = []
    for name in DOWN:
        h = block(name, h)
        skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    h = block("bottleneck", h)
    for name, skip in zip(UP, reversed(skips)):
        up = f"upconv{name[-1]}"
        h = F.conv_transpose2d(h, w[f"{up}.weight"], w[f"{up}.bias"], stride=2)
        h = block(name, torch.cat([h, skip], dim=1))
    h = F.conv2d(h, w["final.weight"], w["final.bias"])
    return h.permute(0, 2, 3, 1)


def fold(w: Dict[str, torch.Tensor]) -> Dict[str, Tuple[torch.Tensor,
                                                          torch.Tensor]]:
    """Each conv's (weight, bias) with its BatchNorm folded in."""
    out = {}
    for key in w:
        if not key.endswith(".conv.0.weight") and not key.endswith(
                ".conv.3.weight"):
            continue
        base = key[:-len(".weight")]
        name, conv = base.rsplit(".", 1)
        bn = f"{name}.{int(conv) + 1}"
        s = w[f"{bn}.weight"] / torch.sqrt(w[f"{bn}.running_var"] + BN_EPS)
        out[base] = (w[key] * s[:, None, None, None],
                     (w[f"{base}.bias"] - w[f"{bn}.running_mean"]) * s
                     + w[f"{bn}.bias"])
    return out


def quantize_weight(wt: torch.Tensor, bits: int, out_dim: int = 0
                    ) -> torch.Tensor:
    """Symmetric per-output-channel fake quantization at ``bits``."""
    q = 2 ** (bits - 1) - 1
    dims = tuple(d for d in range(wt.dim()) if d != out_dim)
    scale = wt.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / q
    return torch.clamp(torch.round(wt / scale), -q, q) * scale


class Quantizer:
    """Symmetric fake quantization at ``bits`` of the named ``sites``
    (all when None): weights per output channel, each site's input by one
    static scale, the absmax that the site saw while ``recording`` (per
    ``step``, for a sampler), as a calibration does."""

    def __init__(self, bits: int, sites=None):
        self.bits, self.sites = bits, sites
        self.absmax: Dict[Tuple[str, int], float] = {}
        self.recording = True
        self.step = 0

    def _on(self, site: str) -> bool:
        return self.sites is None or site in self.sites

    def act(self, site: str, h: torch.Tensor) -> torch.Tensor:
        if not self._on(site):
            return h
        key = (site, self.step)
        if self.recording:
            self.absmax[key] = max(self.absmax.get(key, 0.0),
                                   float(h.abs().amax()))
            return h
        q = 2 ** (self.bits - 1) - 1
        scale = max(self.absmax[key], 1e-12) / q
        return torch.clamp(torch.round(h / scale), -q, q) * scale

    def weight(self, site: str, wt: torch.Tensor, out_dim: int = 0
               ) -> torch.Tensor:
        if self.recording or not self._on(site):
            return wt
        return quantize_weight(wt, self.bits, out_dim)


def forward_served(w: Dict[str, torch.Tensor], x: torch.Tensor,
                   quant: Quantizer) -> torch.Tensor:
    """:func:`forward` as a served model computes it: BatchNorm folded
    into each conv, every conv's, upconv's and the head's weights and
    inputs through ``quant``."""
    folded = fold(w)

    def conv(h, base):
        wt, b = folded[base]
        return F.conv2d(quant.act(base, h), quant.weight(base, wt), b,
                        padding=1)

    def block(name, h):
        h = F.relu(conv(h, f"{name}.conv.0"))
        return F.relu(conv(h, f"{name}.conv.3"))

    h = x.permute(0, 3, 1, 2).to(w["final.weight"].dtype)
    skips = []
    for name in DOWN:
        h = block(name, h)
        skips.append(h)
        h = F.max_pool2d(h, 2, 2)
    h = block("bottleneck", h)
    for name, skip in zip(UP, reversed(skips)):
        up = f"upconv{name[-1]}"
        h = F.conv_transpose2d(quant.act(up, h),
                               quant.weight(up, w[f"{up}.weight"], 1),
                               w[f"{up}.bias"], stride=2)
        h = block(name, torch.cat([h, skip], dim=1))
    h = F.conv2d(quant.act("final", h), quant.weight("final",
                                                     w["final.weight"]),
                 w["final.bias"])
    return h.permute(0, 2, 3, 1)


def calibrated(w: Dict[str, torch.Tensor], batches, bits: int,
               device) -> Quantizer:
    """A :class:`Quantizer` at ``bits`` with every site's scale from the
    absmax over the calibration ``batches`` (the float folded forward)."""
    quant = Quantizer(bits)
    for b in batches:
        forward_served(w, torch.as_tensor(b).to(device), quant)
    quant.recording = False
    return quant
