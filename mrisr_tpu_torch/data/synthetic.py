"""Synthetic volumes: the test/bench fixture that replaces real DICOM data.

A copy of ``mrisr_tpu/data/synthetic.py``: the phantoms are identical bit
for bit (numpy only).

Analog of the reference's ``create_dummy_dataset``
(`reference/src/unet_model.py:301-310`) — but where the reference used
pure noise triplets, these phantoms have smooth anatomy-like structure that
varies slowly along Z, so slice interpolation is actually learnable and
end-to-end training tests can assert loss decreases.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_volume(
    num_slices: int = 60,
    height: int = 256,
    width: int = 256,
    seed: int = 0,
    noise: float = 0.02,
) -> np.ndarray:
    """A (Z, H, W) float32 phantom: nested soft ellipses drifting along Z."""
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
    # slow per-blob drift along Z
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
    # intensity scale similar to MRI magnitudes + mild noise
    vol = vol * 800.0 + 100.0
    if noise > 0:
        vol += rng.normal(0.0, noise * 800.0, vol.shape).astype(np.float32)
    return vol.astype(np.float32)


def make_synthetic_store(
    out_dir: str,
    num_patients: int = 6,
    slices_per_volume: int = 60,
    height: int = 256,
    width: int = 256,
    seed: int = 0,
):
    """Pack ``num_patients`` synthetic single-series patients into a store."""
    from mrisr_tpu_torch.data.volumes import VolumeStore

    def gen():
        for p in range(num_patients):
            pid = f"Synth-{p:04d}"
            vol = make_synthetic_volume(
                slices_per_volume, height, width, seed=seed + p
            )
            yield pid, f"{pid}/series0", vol

    return VolumeStore.pack(out_dir, gen(), meta={"synthetic": True, "seed": seed})
