"""Dataset cleaner (D2): drop ultrasound / 3D-rendering series, keep MR.

The port's copy of ``mrisr_tpu/data/clean.py``.  Same policy as
`reference/src/clean_dataset.py`:
- a series whose first DICOM has Modality == 'US' is deleted,
- a series whose SeriesDescription contains both '3D' and 'RENDERING' is
  deleted,
- scan -> preview -> confirm -> delete, with defensive error handling per
  patient/study/series.
"""

from __future__ import annotations

import os
import shutil
import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from mrisr_tpu_torch.data.dicom_fast import best_reader


@dataclass
class SeriesToDelete:
    path: str
    patient: str
    study: str
    series: str


def is_unwanted_series(series_dir: str) -> bool:
    """True when the series should be removed (US modality or 3D rendering)."""
    try:
        dcms = sorted(
            f for f in os.listdir(series_dir) if f.lower().endswith(".dcm")
        )
    except OSError:
        return False
    if not dcms:
        return False
    try:
        # one header a series, through the native scanner when it compiled
        d = best_reader()(os.path.join(series_dir, dcms[0]), pixels=False)
    except (OSError, ValueError, struct.error):  # unreadable: keep it
        return False
    if d.modality.upper() == "US":
        return True
    desc = d.series_description.upper()
    return "3D" in desc and "RENDERING" in desc


def scan_dataset(
    dataset_root: str, patient_prefix: str = "Prostate-MRI-US-Biopsy-"
) -> Tuple[List[SeriesToDelete], int]:
    """Identify deletable series; returns (to_delete, total_series)."""
    to_delete: List[SeriesToDelete] = []
    total = 0
    patients = sorted(
        d
        for d in os.listdir(dataset_root)
        if d.startswith(patient_prefix)
        and os.path.isdir(os.path.join(dataset_root, d))
    )
    for patient in patients:
        pdir = os.path.join(dataset_root, patient)
        try:
            for study in sorted(os.listdir(pdir)):
                sdir = os.path.join(pdir, study)
                if not os.path.isdir(sdir):
                    continue
                try:
                    for series in sorted(os.listdir(sdir)):
                        serdir = os.path.join(sdir, series)
                        if not os.path.isdir(serdir):
                            continue
                        total += 1
                        if is_unwanted_series(serdir):
                            to_delete.append(
                                SeriesToDelete(serdir, patient, study, series)
                            )
                except OSError:
                    continue
        except OSError:
            continue
    return to_delete, total


def clean_dataset(
    to_delete: List[SeriesToDelete],
    confirm: Optional[Callable[[], bool]] = None,
    dry_run: bool = False,
) -> int:
    """Delete the identified series.  ``confirm`` gates the destructive step
    (the reference's interactive yes/no); dry_run previews only."""
    if dry_run:
        return 0
    if confirm is not None and not confirm():
        return 0
    removed = 0
    for item in to_delete:
        try:
            shutil.rmtree(item.path)
            removed += 1
        except OSError:
            pass
    return removed
