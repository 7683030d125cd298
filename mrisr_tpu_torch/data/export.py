"""Export predicted volumes back to DICOM: closes the ingest loop.

The port's copy of ``mrisr_tpu/data/export.py``, writing the same bytes.
The reference only ever wrote PNG figures; clinical downstreams want DICOM.
Writes one uncompressed Explicit-VR-LE MR file per slice via
data/dicom_lite.py, with monotone Z positions at the requested spacing.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from mrisr_tpu_torch.data.dicom_lite import write_dicom


def export_volume_dicom(
    volume: np.ndarray,
    out_dir: str,
    patient_id: str = "mrisr-pred",
    series_uid: str = "1.2.826.0.1.3680043.9999.1",
    series_description: str = "mrisr-tpu predicted",
    z_spacing: float = 1.5,
    pixel_spacing: Tuple[float, float] = (0.664, 0.664),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> str:
    """volume: (Z, H, W) float.  Intensities are affinely mapped to the
    uint16 range per volume (window preserved across slices so relative
    contrast along Z is kept)."""
    vol = np.asarray(volume, np.float32)
    lo, hi = float(vol.min()), float(vol.max())
    scale = 65535.0 / (hi - lo + 1e-8)
    os.makedirs(out_dir, exist_ok=True)
    for z in range(vol.shape[0]):
        arr = ((vol[z] - lo) * scale).astype(np.uint16)
        write_dicom(
            os.path.join(out_dir, f"slice_{z:03d}.dcm"),
            arr,
            modality="MR",
            series_description=series_description,
            patient_id=patient_id,
            series_uid=series_uid,
            instance_number=z + 1,
            image_position=(
                origin[0], origin[1], origin[2] + z * z_spacing
            ),
            pixel_spacing=pixel_spacing,
        )
    return out_dir
