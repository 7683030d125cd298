"""Packed volume store: DICOM trees -> memory-mapped arrays, packed once.

The port's copy of ``mrisr_tpu/data/volumes.py``.  The manifest format is
the same, so a store that either package packs opens in the other.

The reference re-reads every DICOM file with SimpleITK and pre-caches whole
volumes in RAM per process (`reference/src/ModelDataGenerator.py:164-174`),
repeating the parse cost for every DataLoader worker and every run.  Here the
tree is converted ONCE into per-series ``.npy`` files plus a JSON manifest;
training memory-maps them, so feeding the card is never parser-bound
(SURVEY.md §7 "Host-side DICOM throughput").
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST_NAME = "manifest.json"


@dataclass
class SeriesEntry:
    patient_id: str
    series_id: str
    file: str
    n_slices: int
    height: int
    width: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class VolumeStore:
    """A directory of packed (Z, H, W) float32 series + manifest."""

    def __init__(self, root: str, entries: List[SeriesEntry], meta: dict):
        self.root = root
        self.entries = entries
        self.meta = meta

    # ------------------------------------------------------------------ pack
    @staticmethod
    def pack(
        out_dir: str,
        series: Iterable[Tuple[str, str, np.ndarray]],
        meta: Optional[dict] = None,
    ) -> "VolumeStore":
        """Pack an iterable of ``(patient_id, series_id, volume (Z,H,W))``."""
        os.makedirs(out_dir, exist_ok=True)
        entries: List[SeriesEntry] = []
        for k, (pid, sid, vol) in enumerate(series):
            vol = np.ascontiguousarray(vol, dtype=np.float32)
            if vol.ndim != 3:
                raise ValueError(f"expected (Z,H,W), got {vol.shape}")
            fname = f"series_{k:05d}.npy"
            np.save(os.path.join(out_dir, fname), vol)
            entries.append(
                SeriesEntry(
                    patient_id=pid,
                    series_id=sid,
                    file=fname,
                    n_slices=vol.shape[0],
                    height=vol.shape[1],
                    width=vol.shape[2],
                )
            )
        manifest = {
            "version": 1,
            "meta": meta or {},
            "series": [e.to_dict() for e in entries],
        }
        with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)
        return VolumeStore(out_dir, entries, manifest["meta"])

    @staticmethod
    def pack_dicom_tree(
        out_dir: str,
        dicom_root: str,
        require_slices: Optional[int] = 60,
        patient_prefix: str = "Prostate-MRI-US-Biopsy-",
    ) -> "VolumeStore":
        """Pack from a raw DICOM tree using the 60-slice discovery rule.

        Mirrors ``load_correct_study`` + ``load_patient_volume``
        (`reference/src/ModelDataGenerator.py:15-61`); the manifest and
        volumes equal the JAX package's for the same tree.
        """
        from mrisr_tpu_torch.data.discovery import (
            discover_series,
            read_series_volume,
        )

        def gen():
            patients = sorted(
                d
                for d in os.listdir(dicom_root)
                if d.startswith(patient_prefix)
                and os.path.isdir(os.path.join(dicom_root, d))
            )
            for pid in patients:
                folders = discover_series(
                    os.path.join(dicom_root, pid), require_slices=require_slices
                )
                for folder in folders:
                    vol = read_series_volume(folder)
                    if vol is not None and vol.shape[0] >= 3:
                        yield pid, os.path.relpath(folder, dicom_root), vol

        return VolumeStore.pack(out_dir, gen(), meta={"source": dicom_root})

    # ------------------------------------------------------------------ open
    @staticmethod
    def open(root: str) -> "VolumeStore":
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        entries = [SeriesEntry(**e) for e in manifest["series"]]
        return VolumeStore(root, entries, manifest.get("meta", {}))

    # ---------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.entries)

    @property
    def patient_ids(self) -> List[str]:
        """Sorted unique patient ids (the reference sorts folder names,
        `reference/src/ModelDataGenerator.py:236-239`)."""
        return sorted({e.patient_id for e in self.entries})

    def series_for_patients(self, patients: Sequence[str]) -> List[int]:
        """Indices of series whose patient is in ``patients`` (order kept)."""
        wanted = set(patients)
        return [i for i, e in enumerate(self.entries) if e.patient_id in wanted]

    def slice_counts(self, series_idx: Sequence[int]) -> List[int]:
        return [self.entries[i].n_slices for i in series_idx]

    def load_series(self, idx: int, mmap: bool = True) -> np.ndarray:
        path = os.path.join(self.root, self.entries[idx].file)
        return np.load(path, mmap_mode="r" if mmap else None)
