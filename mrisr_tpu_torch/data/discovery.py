"""Series discovery and volume reading (the port's copy of
``mrisr_tpu/data/discovery.py``).

Reproduces the reference's rules exactly:
- a usable series is any subfolder with EXACTLY ``require_slices`` (60)
  ``.dcm`` files (`reference/src/ModelDataGenerator.py:15-25`),
- slices are stacked in SORTED-FILENAME order (`:45-47`); a position-based
  sort (DICOM ImagePositionPatient Z) is an opt-in,
- each slice is read as float32 (H, W) (`:54-59`).

Headers go through the native scanner when it compiled
(``data/dicom_fast.py``), else through the pure-Python parser; both return
the same fields.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np

from mrisr_tpu_torch.data.dicom_fast import best_reader


def discover_series(
    patient_path: str, require_slices: Optional[int] = 60
) -> List[str]:
    """All subfolders holding exactly ``require_slices`` .dcm files
    (or any >= 3 when ``require_slices`` is None)."""
    found = []
    for root, _dirs, files in os.walk(patient_path):
        n = sum(1 for f in files if f.lower().endswith(".dcm"))
        if require_slices is not None:
            if n == require_slices:
                found.append(root)
        elif n >= 3:
            found.append(root)
    return found


def count_slices(series_folder: Optional[str]) -> int:
    if series_folder is None:
        return 0
    return sum(
        1 for f in os.listdir(series_folder) if f.lower().endswith(".dcm")
    )


def read_series_volume(
    series_folder: Optional[str], sort_by: str = "filename"
) -> Optional[np.ndarray]:
    """Read a series folder into a (Z, H, W) float32 volume.

    sort_by='filename' matches the reference; 'position' sorts by the
    ImagePositionPatient Z coordinate (geometrically correct ordering).
    """
    if series_folder is None:
        return None
    files = sorted(
        os.path.join(series_folder, f)
        for f in os.listdir(series_folder)
        if f.lower().endswith(".dcm")
    )
    if len(files) < 3:
        return None
    reader = best_reader()
    dcms = [reader(f) for f in files]
    if sort_by == "position":
        positions = [d.image_position for d in dcms]
        if all(p is not None for p in positions):
            keyed = sorted(
                zip((p[2] for p in positions), files, dcms),
                key=lambda t: t[0],
            )
            dcms = [d for _, _, d in keyed]
        else:
            # a missing ImagePositionPatient would sort that slice to a
            # bogus Z=0 and scramble the stack — filename order (the
            # reference's default, ModelDataGenerator.py:33) is safe
            warnings.warn(
                f"{series_folder}: ImagePositionPatient missing on some "
                "slices; falling back to filename order",
                stacklevel=2,
            )
    slices = [d.pixel_array for d in dcms]
    if any(s is None for s in slices):
        return None
    return np.stack(slices, axis=0).astype(np.float32)


def check_z_spacing(series_folder: str) -> Optional[float]:
    """Median Z step between consecutive (filename-sorted) slices — the
    Data Analysis notebook's geometry check
    (`notebooks/Data Analysis.ipynb:cell10`: T2w steps 1.5 mm)."""
    files = sorted(
        os.path.join(series_folder, f)
        for f in os.listdir(series_folder)
        if f.lower().endswith(".dcm")
    )
    reader = best_reader()
    zs = []
    for f in files:
        pos = reader(f, pixels=False).image_position
        if pos is not None:
            zs.append(pos[2])
    if len(zs) < 2:
        return None
    zs = sorted(zs)
    return float(np.median(np.diff(zs)))
