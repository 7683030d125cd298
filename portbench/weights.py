"""Seeded weights, drawn on the device in two large calls.

Every leaf of a configuration's parameter list (the plain reference's
names and shapes) is a slice of one normal draw, scaled by a rule of its
kind, or of one uniform draw (BatchNorm variances).  The same seed on the
same device gives the same weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

Rule = Callable[[str, Tuple[int, ...]], Tuple[str, float, float]]


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


def draw(shapes: Dict[str, Tuple[int, ...]], rule: Rule, seed: int,
         device: torch.device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``rule(name, shape) -> (kind, scale, offset)``: the leaf is
    ``offset + scale * N(0, 1)`` for kind 'normal', ``offset + scale *
    U(0, 1)`` for 'uniform'."""
    g = generator(seed, device)
    plan = {name: rule(name, shape) for name, shape in shapes.items()}
    out = {}
    for kind in ("normal", "uniform"):
        names = [n for n, p in plan.items() if p[0] == kind]
        total = sum(math.prod(shapes[n]) for n in names)
        if not total:
            continue
        flat = (torch.randn if kind == "normal" else torch.rand)(
            total, generator=g, device=device, dtype=dtype)
        at = 0
        for n in names:
            k = math.prod(shapes[n])
            _, scale, offset = plan[n]
            out[n] = (flat[at:at + k].view(shapes[n]) * scale
                      + offset).contiguous()
            at += k
    return out


def _fan_in(shape: Tuple[int, ...], transposed: bool) -> int:
    if transposed:  # ConvTranspose2d (I, O, kh, kw): torch's fan is O*kh*kw
        return shape[1] * shape[2] * shape[3]
    return math.prod(shape[1:])


def unet_rule(name: str, shape: Tuple[int, ...]):
    """He-normal convs, small biases, BatchNorm around the identity with
    non-trivial statistics (``chip_smoke.seeded_unet``'s recipe)."""
    leaf = name.rsplit(".", 1)[-1]
    is_bn = name.split(".")[-2] in ("1", "4") and ".conv." in name
    if is_bn:
        return {"weight": ("normal", 0.2, 1.0), "bias": ("normal", 0.1, 0.0),
                "running_mean": ("normal", 0.1, 0.0),
                "running_var": ("uniform", 1.0, 0.5)}[leaf]
    if leaf == "bias":
        return ("normal", 0.05, 0.0)
    # an upconv output pixel sums one input pixel's channels
    fan = shape[0] if name.startswith("upconv") else _fan_in(shape, False)
    return ("normal", math.sqrt(2.0 / fan), 0.0)


def fastddpm_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """PyTorch's default init's variance (U(-1/sqrt(fan), 1/sqrt(fan)) for
    weights and biases, the fan a bias's weight's) as normals, GroupNorm
    scales and shifts drawn around the identity
    (``chip_smoke.seeded_fastddpm``'s recipe)."""
    def rule(name: str, shape: Tuple[int, ...]):
        if ".norm" in name or name.startswith("final.0"):
            return (("normal", 0.2, 1.0) if name.endswith("weight")
                    else ("normal", 0.05, 0.0))
        weight = (shapes[name[:-len("bias")] + "weight"]
                  if name.endswith(".bias") else shape)
        return ("normal", 1.0 / math.sqrt(
            3.0 * _fan_in(weight, name.startswith("upconv"))), 0.0)

    return draw(shapes, rule, seed, device)


def unet_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    return draw(shapes, unet_rule, seed, device)
