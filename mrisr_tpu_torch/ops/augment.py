"""Paired augmentation on the device (counterpart: ``mrisr_tpu/ops/augment.py``).

The reference augments on the host in DataLoader workers: p = 0.5
horizontal and vertical flips applied identically to pre/post/target
(reference ``src/ModelDataGenerator.py:97-115``), a random rot90 in the
progressive pipeline and a lost +-5 degree rotation variant.  Here the
augmentation is a function of the batch and a ``torch.Generator``, on the
batch's device, vectorized over the batch; every channel of a sample gets
the same transform ("paired").

The draws are split from their application: :func:`paired_augment` draws
and :func:`apply_paired_augment` applies, so a test can pass in the JAX
package's draws (a ``jax.random`` stream cannot be reproduced).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Mask = Optional[torch.Tensor]


def paired_augment(
    batch: torch.Tensor,
    generator: torch.Generator,
    hflip: bool = True,
    vflip: bool = True,
    rot90: bool = False,
    rotate_degrees: float = 0.0,
    rows: Optional[slice] = None,
    global_batch: Optional[int] = None,
) -> torch.Tensor:
    """Per-sample paired augmentation of an NHWC batch ``(B, H, W, C)``:
    one draw a sample for each enabled transform, from ``generator`` (on
    the batch's device).

    ``batch`` may be one rank's ``rows`` of a global batch of
    ``global_batch`` samples (``parallel/mesh.py``): the draws are then
    made for the global batch, in the same order, and this rank's rows of
    them applied, so the shards together get the single-process draws."""
    b, dev = batch.shape[0], batch.device
    if rows is not None:
        b = global_batch

    def uniform():
        return torch.rand(b, generator=generator, device=dev)

    hmask = uniform() < 0.5 if hflip else None
    vmask = uniform() < 0.5 if vflip else None
    k = (torch.randint(0, 4, (b,), generator=generator, device=dev)
         if rot90 else None)
    angles = None
    if rotate_degrees > 0.0:
        angles = (2.0 * uniform() - 1.0) * (rotate_degrees * math.pi / 180.0)
    if rows is not None:
        hmask, vmask, k, angles = (None if d is None else d[rows]
                                   for d in (hmask, vmask, k, angles))
    return apply_paired_augment(batch, hmask, vmask, k, angles)


def apply_paired_augment(batch: torch.Tensor, hmask: Mask = None,
                         vmask: Mask = None, k: Mask = None,
                         angles: Mask = None) -> torch.Tensor:
    """Apply given draws, in the JAX package's order: horizontal flip where
    ``hmask`` (``(B,)`` bool), vertical flip where ``vmask``, ``rot90`` by
    ``k`` quarter turns (``(B,)`` ints in [0, 4), needs H == W), then the
    bilinear rotation by ``angles`` (``(B,)`` radians).  None skips a
    transform."""
    if hmask is not None:
        batch = torch.where(hmask[:, None, None, None], batch.flip(2), batch)
    if vmask is not None:
        batch = torch.where(vmask[:, None, None, None], batch.flip(1), batch)
    if k is not None:
        if batch.shape[1] != batch.shape[2]:
            raise ValueError(f"rot90 needs square images, got "
                             f"{tuple(batch.shape[1:3])}")
        sel = k[:, None, None, None]
        out = batch
        for q in (1, 2, 3):
            out = torch.where(sel == q, torch.rot90(batch, q, dims=(1, 2)),
                              out)
        batch = out
    if angles is not None:
        batch = _rotate_bilinear(batch, angles)
    return batch


def _rotate_bilinear(batch: torch.Tensor, angles: torch.Tensor
                     ) -> torch.Tensor:
    """Rotation about the image center, bilinear, zero fill: inverse
    mapping of every output pixel, four clipped gathers."""
    b, h, w, c = batch.shape
    dev = batch.device
    yy = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")  # (H, W)
    cos = torch.cos(angles.float())[:, None, None]
    sin = torch.sin(angles.float())[:, None, None]
    sy = cos * gy - sin * gx + (h - 1) / 2.0  # (B, H, W) source coords
    sx = sin * gy + cos * gx + (w - 1) / 2.0
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    flat = batch.reshape(b, h * w, c)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, h * w, 1).expand(-1, -1, c)
        vals = flat.gather(1, idx).reshape(b, h, w, c)
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
