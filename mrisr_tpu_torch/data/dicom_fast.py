"""ctypes binding of the native DICOM header scanner (``_native/dicom_fast.c``).

The port's copy of ``mrisr_tpu/data/dicom_fast.py``: a drop-in fast path
for :func:`mrisr_tpu_torch.data.dicom_lite.parse_dicom_bytes` that returns
the same ``DicomFile`` (tests/test_torch_port_dicom_fast.py holds them equal
field for field).  The header-only parse is what the cleaner, series
discovery and ``check_z_spacing`` run over the whole 69k-file tree, and the
per-element Python overhead is what the C scanner removes.

The shared library is host code, not a device kernel.  It is compiled on
first use with the system C compiler into ``build/native/`` at the repo root
(beside ``_build.py``'s ``build/kernels/``), named by a hash of the source
and flags, so an edited source rebuilds.  Nothing is built when the module
is imported.  With no C compiler, :func:`available` is False and
:func:`best_reader` returns the pure-Python parser, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from mrisr_tpu_torch._build import BUILD_DIR as _KERNEL_DIR
from mrisr_tpu_torch.data.dicom_lite import DicomFile, decode_pixels, read_dicom

SRC = Path(__file__).resolve().parent / "_native" / "dicom_fast.c"
BUILD_DIR = _KERNEL_DIR.parent / "native"
COMPILERS = ("cc", "gcc", "clang")
CFLAGS = ("-O2", "-shared", "-fPIC")


class _Header(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_int32),
        ("err", ctypes.c_int32),
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("bits_allocated", ctypes.c_int32),
        ("pixel_representation", ctypes.c_int32),
        ("samples_per_pixel", ctypes.c_int32),
        ("bits_stored", ctypes.c_int32),
        ("high_bit", ctypes.c_int32),
        ("pixel_off", ctypes.c_int64),
        ("pixel_len", ctypes.c_int64),
        ("modality", ctypes.c_char * 68),
        ("series_description", ctypes.c_char * 132),
        ("patient_id", ctypes.c_char * 68),
        ("study_uid", ctypes.c_char * 132),
        ("series_uid", ctypes.c_char * 132),
        ("instance_number", ctypes.c_char * 36),
        ("image_position", ctypes.c_char * 132),
        ("image_orientation", ctypes.c_char * 196),
        ("pixel_spacing", ctypes.c_char * 68),
        ("rescale_intercept", ctypes.c_char * 36),
        ("rescale_slope", ctypes.c_char * 36),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"dicom_fast-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The built library, compiled now if it is not there yet; None when
    no compiler in ``COMPILERS`` builds it."""
    so = library_path()
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    # unique per process and thread, then renamed: a concurrent loader
    # sees the whole library or none
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    for cc in COMPILERS:
        try:
            subprocess.run([cc, *CFLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, so)
        return so
    return None


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.parse_dicom.restype = ctypes.c_int
    lib.parse_dicom.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(_Header)]
    return lib


def available() -> bool:
    """True when the native parser compiled and loaded on this machine."""
    return _load() is not None


# field name -> struct attribute
_STR_FIELDS = (
    ("Modality", "modality"),
    ("SeriesDescription", "series_description"),
    ("PatientID", "patient_id"),
    ("StudyInstanceUID", "study_uid"),
    ("SeriesInstanceUID", "series_uid"),
    ("InstanceNumber", "instance_number"),
    ("ImagePositionPatient", "image_position"),
    ("ImageOrientationPatient", "image_orientation"),
    ("PixelSpacing", "pixel_spacing"),
    ("RescaleIntercept", "rescale_intercept"),
    ("RescaleSlope", "rescale_slope"),
)
_INT_FIELDS = (
    ("Rows", "rows"),
    ("Columns", "cols"),
    ("BitsAllocated", "bits_allocated"),
    ("PixelRepresentation", "pixel_representation"),
)


def parse_dicom_bytes_fast(data: bytes, pixels: bool = True) -> DicomFile:
    """Native-parser equivalent of dicom_lite.parse_dicom_bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native DICOM parser unavailable (no C compiler)")
    hdr = _Header()
    if not lib.parse_dicom(data, len(data), ctypes.byref(hdr)):
        if hdr.err != 1:
            raise ValueError("DICOM parse failed")
        # encapsulated (compressed) PixelData: every header tag precedes
        # it, so a header-only parse still succeeds (the cleaner reads
        # Modality from compressed ultrasound series), as in dicom_lite
        if pixels:
            raise ValueError("compressed PixelData not supported by dicom_lite")
        hdr.pixel_off = -1

    out = DicomFile()
    for name, attr in _STR_FIELDS:
        raw = getattr(hdr, attr)
        if raw:  # empty == absent (the tags dicom_lite retains)
            out.fields[name] = raw.decode("ascii", "replace")
    for name, attr in _INT_FIELDS:
        v = getattr(hdr, attr)
        if v >= 0:
            out.fields[name] = int(v)
    if pixels and hdr.pixel_off >= 0:
        decode_pixels(out, memoryview(data)[int(hdr.pixel_off):])
    return out


def read_dicom_fast(path: str, pixels: bool = True) -> DicomFile:
    with open(path, "rb") as f:
        data = f.read()
    return parse_dicom_bytes_fast(data, pixels=pixels)


def best_reader():
    """The fastest available read_dicom: native when compiled, else the
    pure-Python parser.  Both return identical DicomFiles."""
    return read_dicom_fast if available() else read_dicom
