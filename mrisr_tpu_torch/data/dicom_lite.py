"""Dependency-free DICOM reader/writer for uncompressed MR data.

The port's copy of ``mrisr_tpu/data/dicom_lite.py``: struct and numpy only,
no pydicom.  The reference reads DICOM with SimpleITK/pydicom
(`reference/src/ModelDataGenerator.py:33-61`, `src/clean_dataset.py:27`);
this parser covers what the Prostate-MRI-US-Biopsy T2w series need:

- part-10 files (128-byte preamble + 'DICM') and raw datasets,
- transfer syntaxes Implicit VR LE (1.2.840.10008.1.2) and
  Explicit VR LE (1.2.840.10008.1.2.1),
- sequence skipping (defined and undefined lengths),
- uncompressed 8/16-bit PixelData with RescaleSlope/Intercept applied
  (matching SimpleITK's read behavior); compressed PixelData parses
  header-only.

The writer emits Explicit VR LE part-10 files, byte for byte the JAX
package's for the same arguments; ``data/export.py`` writes predicted
volumes with it.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"

# VRs with a 2-byte reserved field + 4-byte length in explicit encoding
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# tags we retain: (group, elem) -> name
TAGS = {
    (0x0008, 0x0060): "Modality",
    (0x0008, 0x103E): "SeriesDescription",
    (0x0010, 0x0020): "PatientID",
    (0x0020, 0x000D): "StudyInstanceUID",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
}

_PIXEL_DATA = (0x7FE0, 0x0010)
_US_TAGS = {(0x0028, 0x0010), (0x0028, 0x0011), (0x0028, 0x0100),
            (0x0028, 0x0103), (0x0028, 0x0002), (0x0028, 0x0101),
            (0x0028, 0x0102)}


@dataclass
class DicomFile:
    """Parsed header fields + pixel array."""

    fields: Dict[str, object] = field(default_factory=dict)
    pixel_array: Optional[np.ndarray] = None  # (H, W) after rescale, float32

    def get(self, name: str, default=None):
        return self.fields.get(name, default)

    @property
    def modality(self) -> str:
        return str(self.get("Modality", "")).strip()

    @property
    def series_description(self) -> str:
        return str(self.get("SeriesDescription", "")).strip()

    @property
    def image_position(self) -> Optional[Tuple[float, float, float]]:
        v = self.get("ImagePositionPatient")
        if v is None:
            return None
        parts = [float(p) for p in str(v).split("\\")]
        return tuple(parts) if len(parts) == 3 else None


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.d, self.p)[0]
        self.p += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.d, self.p)[0]
        self.p += 4
        return v

    def raw(self, n: int) -> bytes:
        v = self.d[self.p : self.p + n]
        self.p += n
        return v

    def eof(self) -> bool:
        return self.p >= len(self.d)


def _skip_undefined_sequence(r: _Reader, explicit: bool) -> None:
    """Skip an undefined-length SQ until its sequence delimiter.

    ``depth`` counts OPEN undefined-length containers (the SQ itself, plus
    any undefined-length items or nested SQs).  Item delimiters (FFFE,E00D)
    close undefined items; the sequence delimiter (FFFE,E0DD) closes the SQ.
    Defined-length items are skipped wholesale (their length covers all
    nested content).  Elements inside undefined-length items follow the
    DATASET's VR encoding, so ``explicit`` must match the file.
    """
    depth = 1
    while depth > 0 and not r.eof():
        group = r.u16()
        elem = r.u16()
        if (group, elem) == (0xFFFE, 0xE000):  # item start
            length = r.u32()
            if length == 0xFFFFFFFF:
                depth += 1
            else:
                r.raw(length)
        elif (group, elem) in ((0xFFFE, 0xE00D), (0xFFFE, 0xE0DD)):
            r.u32()  # delimiter length field (always 0)
            depth -= 1
        else:
            # dataset element inside an undefined-length item
            if explicit:
                vr = r.raw(2)
                if vr in _LONG_VRS:
                    r.raw(2)
                    length = r.u32()
                else:
                    length = r.u16()
            else:
                length = r.u32()
            if length == 0xFFFFFFFF:  # nested undefined-length SQ
                depth += 1
            else:
                r.raw(length)


def _decode_value(name: str, vr: bytes, raw: bytes, tag) -> object:
    if tag in _US_TAGS or vr == b"US":
        return struct.unpack("<H", raw[:2])[0] if len(raw) >= 2 else None
    try:
        return raw.decode("ascii", "replace").strip("\x00 ").strip()
    except Exception:
        return raw


def read_dicom(path: str, pixels: bool = True) -> DicomFile:
    with open(path, "rb") as f:
        data = f.read()
    return parse_dicom_bytes(data, pixels=pixels)


def parse_dicom_bytes(data: bytes, pixels: bool = True) -> DicomFile:
    r = _Reader(data)
    if len(data) > 132 and data[128:132] == b"DICM":
        r.p = 132
    out = DicomFile()
    transfer_syntax = EXPLICIT_VR_LE
    explicit = True
    in_meta = True
    pixel_raw: Optional[bytes] = None

    while not r.eof():
        if r.p + 8 > len(r.d):
            break
        group = r.u16()
        elem = r.u16()
        tag = (group, elem)

        if in_meta and group != 0x0002:
            # meta group done; switch to negotiated syntax
            in_meta = False
            explicit = transfer_syntax != IMPLICIT_VR_LE
            if explicit and transfer_syntax == EXPLICIT_VR_LE:
                # Raw datasets (no part-10 header) carry no
                # TransferSyntaxUID, so EXPLICIT stayed defaulted; sniff
                # the first dataset element — explicit VR places a valid
                # two-letter VR code right after the tag, implicit places
                # a 4-byte length there.
                peek = r.d[r.p : r.p + 2]
                if not (peek.isalpha() and peek.isupper()):
                    explicit = False
        if group == 0x0002:
            cur_explicit = True  # meta is always explicit LE
        else:
            cur_explicit = explicit

        if cur_explicit:
            vr = r.raw(2)
            if vr in _LONG_VRS:
                r.raw(2)
                length = r.u32()
            else:
                length = r.u16()
        else:
            vr = b"UN"
            length = r.u32()

        if vr == b"SQ" or (length == 0xFFFFFFFF and tag != _PIXEL_DATA):
            if length == 0xFFFFFFFF:
                _skip_undefined_sequence(r, explicit=cur_explicit)
            else:
                r.raw(length)
            continue

        if length == 0xFFFFFFFF:
            # encapsulated (compressed) pixel data — decode unsupported.
            # Header-only parses (pixels=False) must still SUCCEED here:
            # the cleaner reads Modality to delete compressed ultrasound
            # series, and every header tag precedes PixelData.
            if not pixels:
                break
            raise ValueError("compressed PixelData not supported by dicom_lite")

        raw = r.raw(length)

        if tag == (0x0002, 0x0010):
            transfer_syntax = raw.decode("ascii", "replace").strip("\x00 ")
        elif tag == _PIXEL_DATA:
            pixel_raw = raw
            break  # pixel data is last
        elif tag in TAGS:
            out.fields[TAGS[tag]] = _decode_value(TAGS[tag], vr, raw, tag)

    if pixels and pixel_raw is not None:
        decode_pixels(out, pixel_raw)
    return out


def decode_pixels(out: DicomFile, raw) -> None:
    """Set ``out.pixel_array`` from the PixelData bytes ``raw`` (a buffer
    starting at the value) and the header fields already in ``out``:
    8/16-bit, signed per PixelRepresentation, then the rescale."""
    rows = int(out.get("Rows", 0) or 0)
    cols = int(out.get("Columns", 0) or 0)
    bits = int(out.get("BitsAllocated", 16) or 16)
    signed = int(out.get("PixelRepresentation", 0) or 0) == 1
    if not (rows and cols):
        return
    if bits == 16:
        dt = np.int16 if signed else np.uint16
    elif bits == 8:
        dt = np.int8 if signed else np.uint8
    else:
        raise ValueError(f"unsupported BitsAllocated={bits}")
    arr = np.frombuffer(
        raw[: rows * cols * (bits // 8)], dtype=np.dtype(dt).newbyteorder("<")
    ).reshape(rows, cols)
    slope = float(out.get("RescaleSlope", 1.0) or 1.0)
    intercept = float(out.get("RescaleIntercept", 0.0) or 0.0)
    out.pixel_array = arr.astype(np.float32) * slope + intercept


# ------------------------------------------------------------------ writer


# string VRs pad with space (0x20); UI and binary VRs pad with NUL
_SPACE_PAD_VRS = {b"AE", b"AS", b"CS", b"DA", b"DS", b"DT", b"IS", b"LO",
                  b"LT", b"PN", b"SH", b"ST", b"TM", b"UC", b"UR", b"UT"}


def _el(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" " if vr in _SPACE_PAD_VRS else b"\x00"
    head = struct.pack("<HH", group, elem)
    if vr in _LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def write_dicom(
    path: str,
    pixel_array: np.ndarray,
    modality: str = "MR",
    series_description: str = "T2 AXIAL",
    patient_id: str = "P0",
    series_uid: str = "1.2.3.4",
    instance_number: int = 1,
    image_position: Optional[Tuple[float, float, float]] = (0.0, 0.0, 0.0),
    pixel_spacing: Tuple[float, float] = (0.664, 0.664),
) -> None:
    """Write a single-frame uncompressed Explicit-VR-LE MR image."""
    arr = np.asarray(pixel_array)
    if arr.dtype != np.uint16:
        arr = np.clip(arr, 0, 65535).astype(np.uint16)
    rows, cols = arr.shape

    def s(x) -> bytes:
        return str(x).encode("ascii")

    meta = b"".join([
        _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
        _el(0x0002, 0x0002, b"UI", s("1.2.840.10008.5.1.4.1.1.4")),
        _el(0x0002, 0x0003, b"UI", s(f"{series_uid}.{instance_number}")),
        _el(0x0002, 0x0010, b"UI", s(EXPLICIT_VR_LE)),
    ])
    meta_group_len = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))

    body = b"".join([
        _el(0x0008, 0x0060, b"CS", s(modality)),
        _el(0x0008, 0x103E, b"LO", s(series_description)),
        _el(0x0010, 0x0020, b"LO", s(patient_id)),
        _el(0x0020, 0x000E, b"UI", s(series_uid)),
        _el(0x0020, 0x0013, b"IS", s(instance_number)),
        # None omits the tag (tests exercise missing-position fallbacks)
        *([_el(0x0020, 0x0032, b"DS",
               s("\\".join(f"{v:g}" for v in image_position)))]
          if image_position is not None else []),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0030, b"DS", s("\\".join(f"{v:g}" for v in pixel_spacing))),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _el(0x0028, 0x0101, b"US", struct.pack("<H", 16)),
        _el(0x0028, 0x0102, b"US", struct.pack("<H", 15)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        _el(0x7FE0, 0x0010, b"OW", arr.astype("<u2").tobytes()),
    ])

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128)
        f.write(b"DICM")
        f.write(meta_group_len)
        f.write(meta)
        f.write(body)
