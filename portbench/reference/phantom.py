"""Phantom MRI volumes and the serving plans over them.

A frozen copy of ``data/synthetic.py:make_synthetic_volume`` (nested soft
ellipses drifting along Z, MRI-like magnitudes, mild noise), the per-slice
z-score that ``predict-volume`` applies before serving, and the 3 mm plan
``eval_volume_triplets`` (pairs ``(i, i + 2)`` for even ``i``).  numpy only.
"""

from __future__ import annotations

import numpy as np


def phantom_volume(num_slices: int = 60, height: int = 256, width: int = 256,
                   seed: int = 0, noise: float = 0.02) -> np.ndarray:
    """A (Z, H, W) float32 phantom."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy = (yy - height / 2) / (height / 2)
    xx = (xx - width / 2) / (width / 2)

    n_blobs = 4
    cy = rng.uniform(-0.4, 0.4, n_blobs)
    cx = rng.uniform(-0.4, 0.4, n_blobs)
    ry = rng.uniform(0.15, 0.5, n_blobs)
    rx = rng.uniform(0.15, 0.5, n_blobs)
    amp = rng.uniform(0.4, 1.0, n_blobs)
    dcy = rng.uniform(-0.3, 0.3, n_blobs) / max(num_slices, 1)
    dcx = rng.uniform(-0.3, 0.3, n_blobs) / max(num_slices, 1)
    dr = rng.uniform(-0.2, 0.2, n_blobs) / max(num_slices, 1)

    vol = np.zeros((num_slices, height, width), dtype=np.float32)
    for z in range(num_slices):
        img = np.zeros((height, width), dtype=np.float32)
        for b in range(n_blobs):
            ey = cy[b] + dcy[b] * z
            ex = cx[b] + dcx[b] * z
            sy = max(ry[b] + dr[b] * z, 0.05)
            sx = max(rx[b] + dr[b] * z, 0.05)
            d2 = ((yy - ey) / sy) ** 2 + ((xx - ex) / sx) ** 2
            img += amp[b] * np.exp(-d2 * 2.0)
        vol[z] = img
    vol = vol * 800.0 + 100.0
    if noise > 0:
        vol += rng.normal(0.0, noise * 800.0, vol.shape).astype(np.float32)
    return vol.astype(np.float32)


def zscore(vol: np.ndarray) -> np.ndarray:
    """Each (H, W) slice to mean 0, population std 1 (eps 1e-6 outside
    the root), in float32."""
    v = vol.astype(np.float32)
    mean = v.mean(axis=(-2, -1), keepdims=True)
    std = np.sqrt(((v - mean) ** 2).mean(axis=(-2, -1), keepdims=True))
    return ((v - mean) / (std + 1e-6)).astype(np.float32)


def pair_plan(num_slices: int, gap: int = 2) -> np.ndarray:
    """``(N, 2)`` slice indices ``(i, i + gap)`` for ``i`` a multiple of
    ``gap``: at gap 2 the 3 mm plan of a 1.5 mm series, 29 pairs of 60."""
    i = np.arange(0, num_slices - gap, gap)
    return np.stack([i, i + gap], axis=1)


def volume_seed(seed: int, k: int) -> int:
    """The phantom seed of volume ``k`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed % 2 ** 63, k]).generate_state(1)[0])


def pair_pool(seed: int, volumes: int, slices: int, size: int,
              gap: int = 2) -> np.ndarray:
    """``(volumes, pairs, H, W, 2)`` float32 requests: every pair of the
    plan of ``volumes`` z-scored phantoms drawn from ``seed``."""
    plan = pair_plan(slices, gap)
    out = np.empty((volumes, len(plan), size, size, 2), np.float32)
    for k in range(volumes):
        v = zscore(phantom_volume(slices, size, size, seed=volume_seed(seed,
                                                                       k)))
        out[k, ..., 0] = v[plan[:, 0]]
        out[k, ..., 1] = v[plan[:, 1]]
    return out
