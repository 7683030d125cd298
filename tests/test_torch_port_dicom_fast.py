"""The port's native DICOM header scanner (data/dicom_fast.py, built from its
own copy of _native/dicom_fast.c into build/native/) against the port's
pure-Python parser and against mrisr_tpu's native parser: the cases of
tests/test_dicom_fast.py, field for field and pixels bit for bit, plus the
fallback to the Python parser on a machine with no C compiler."""

import struct

import numpy as np
import pytest

from mrisr_tpu.data import dicom_fast as jax_fast
from mrisr_tpu.data.dicom_lite import parse_dicom_bytes as jax_parse
from mrisr_tpu_torch.data import dicom_fast, dicom_lite, discovery
from mrisr_tpu_torch.data.dicom_lite import (
    IMPLICIT_VR_LE,
    parse_dicom_bytes,
    write_dicom,
)


@pytest.fixture(autouse=True)
def native():
    if not dicom_fast.available():
        pytest.skip("no C compiler on this machine: the Python parser runs")


def assert_equal(data: bytes, pixels: bool = True):
    """The native parse equals the Python parse (the reference) and the JAX
    package's parses of the same bytes."""
    ref = parse_dicom_bytes(data, pixels=pixels)
    fast = dicom_fast.parse_dicom_bytes_fast(data, pixels=pixels)
    for other in (fast, jax_parse(data, pixels=pixels)):
        assert other.fields == ref.fields
        if ref.pixel_array is None:
            assert other.pixel_array is None
        else:
            np.testing.assert_array_equal(other.pixel_array, ref.pixel_array)
            assert other.pixel_array.dtype == ref.pixel_array.dtype
    if jax_fast.available():
        assert jax_fast.parse_dicom_bytes_fast(data, pixels=pixels).fields \
            == fast.fields
    assert fast.modality == ref.modality
    assert fast.series_description == ref.series_description
    assert fast.image_position == ref.image_position
    return fast


def el_implicit(group, elem, value):
    return struct.pack("<HHI", group, elem, len(value)) + value


def el(group, elem, vr, value, pad=b"\x00"):
    if len(value) % 2:
        value += pad
    head = struct.pack("<HH", group, elem)
    if vr in (b"OB", b"OW", b"SQ", b"UN"):
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def test_writer_roundtrip_parity(tmp_path):
    rng = np.random.RandomState(0)
    p = str(tmp_path / "a.dcm")
    write_dicom(p, (rng.rand(16, 12) * 4000).astype(np.uint16),
                modality="MR", series_description="T2 AXIAL PROSTATE",
                patient_id="Prostate-01", series_uid="1.2.840.999.1",
                instance_number=7, image_position=(1.5, -2.25, 33.0))
    with open(p, "rb") as f:
        data = f.read()
    for pixels in (True, False):
        assert_equal(data, pixels=pixels)
    got = dicom_fast.read_dicom_fast(p)
    assert got.get("InstanceNumber") == "7" and got.get("Rows") == 16


def test_implicit_vr_parity():
    """A part-10 file negotiating implicit VR in its meta group."""
    ts = IMPLICIT_VR_LE.encode()
    if len(ts) % 2:
        ts += b"\x00"
    el_ts = struct.pack("<HH", 2, 0x10) + b"UI" + struct.pack("<H", len(ts)) + ts
    meta = (struct.pack("<HH", 2, 0) + b"UL" + struct.pack("<H", 4)
            + struct.pack("<I", len(el_ts)) + el_ts)
    arr = (np.arange(6 * 4, dtype=np.uint16) * 100).reshape(6, 4)
    body = b"".join([
        el_implicit(0x0008, 0x0060, b"MR"),
        el_implicit(0x0010, 0x0020, b"P42 "),
        el_implicit(0x0020, 0x0032, b"0\\0\\12.5 "),
        el_implicit(0x0028, 0x0010, struct.pack("<H", 6)),
        el_implicit(0x0028, 0x0011, struct.pack("<H", 4)),
        el_implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        el_implicit(0x0028, 0x0103, struct.pack("<H", 0)),
        el_implicit(0x7FE0, 0x0010, arr.astype("<u2").tobytes()),
    ])
    fast = assert_equal(b"\x00" * 128 + b"DICM" + meta + body)
    assert fast.image_position == (0.0, 0.0, 12.5)


def test_raw_implicit_vr_no_preamble_parity():
    """No part-10 header, implicit VR: both parsers sniff the first
    element, and the result is not the vacuous empty header."""
    arr = (np.arange(5 * 3, dtype=np.uint16) * 7).reshape(5, 3)
    body = b"".join([
        el_implicit(0x0008, 0x0060, b"MR"),
        el_implicit(0x0008, 0x103E, b"T2 AX PROSTATE"),
        el_implicit(0x0010, 0x0020, b"P99 "),
        el_implicit(0x0020, 0x0032, b"1\\2\\3.5 "),
        el_implicit(0x0028, 0x0010, struct.pack("<H", 5)),
        el_implicit(0x0028, 0x0011, struct.pack("<H", 3)),
        el_implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        el_implicit(0x0028, 0x0103, struct.pack("<H", 0)),
        el_implicit(0x7FE0, 0x0010, arr.astype("<u2").tobytes()),
    ])
    fast = assert_equal(body)
    assert fast.modality == "MR"
    assert fast.get("Rows") == 5 and fast.get("Columns") == 3
    np.testing.assert_array_equal(fast.pixel_array, arr.astype(np.float32))


def test_undefined_sequence_skip_parity():
    """An undefined-length SQ with a nested undefined-length item before the
    retained tags, and a defined-length SQ after them."""
    inner = el(0x0008, 0x0100, b"SH", b"CODE")
    item_undef = (struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + inner
                  + struct.pack("<HHI", 0xFFFE, 0xE00D, 0))
    seq = (struct.pack("<HH", 0x0008, 0x1115) + b"SQ" + b"\x00\x00"
           + struct.pack("<I", 0xFFFFFFFF) + item_undef
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    defined = el(0x0040, 0x0275, b"SQ",
                 struct.pack("<HHI", 0xFFFE, 0xE000, 8) + inner)
    arr = np.full((2, 2), 7, np.uint16)
    body = seq + b"".join([
        el(0x0008, 0x0060, b"CS", b"MR"),
        defined,
        el(0x0028, 0x0010, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        el(0x7FE0, 0x0010, b"OW", arr.astype("<u2").tobytes()),
    ])
    fast = assert_equal(body)
    assert fast.modality == "MR" and fast.get("Rows") == 2


def test_rescale_parity():
    arr = np.array([[0, 1], [2, 3]], np.uint16)
    body = b"".join([
        el(0x0028, 0x0010, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        el(0x0028, 0x1052, b"DS", b"-1024", pad=b" "),
        el(0x0028, 0x1053, b"DS", b"2.0", pad=b" "),
        el(0x7FE0, 0x0010, b"OW", arr.astype("<u2").tobytes()),
    ])
    fast = assert_equal(body)
    np.testing.assert_array_equal(fast.pixel_array,
                                  arr.astype(np.float32) * 2.0 - 1024.0)


@pytest.mark.parametrize("bits,dtype,signed", [
    (8, np.int8, 1), (8, np.uint8, 0), (16, np.int16, 1)])
def test_signed_8bit_parity(bits, dtype, signed):
    """8-bit signed (tests/test_dicom_fast.py's case), 8-bit unsigned and
    16-bit signed pixels."""
    arr = np.array([[-5, 3], [120, -128]]).astype(dtype)
    body = b"".join([
        el(0x0028, 0x0010, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", signed)),
        el(0x7FE0, 0x0010, b"OW", arr.astype(arr.dtype.newbyteorder("<"))
           .tobytes()),
    ])
    fast = assert_equal(body)
    np.testing.assert_array_equal(fast.pixel_array, arr.astype(np.float32))


def test_compressed_rejected_like_lite():
    """Encapsulated pixel data raises in both parsers; 12-bit allocation
    too, and only where pixels are asked for."""
    data = (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB" + b"\x00\x00"
            + struct.pack("<I", 0xFFFFFFFF))
    for parse in (parse_dicom_bytes, dicom_fast.parse_dicom_bytes_fast):
        with pytest.raises(ValueError, match="compressed"):
            parse(data)
    odd = b"".join([
        el(0x0028, 0x0010, b"US", struct.pack("<H", 1)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", 2)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 12)),
        el(0x7FE0, 0x0010, b"OW", b"\x00" * 4),
    ])
    for parse in (parse_dicom_bytes, dicom_fast.parse_dicom_bytes_fast):
        with pytest.raises(ValueError, match="BitsAllocated=12"):
            parse(odd)
    assert_equal(odd, pixels=False)


def test_best_reader_selects_native(tmp_path, monkeypatch):
    """The native reader when it built; the Python parser when no C
    compiler builds it (a fresh build dir, compilers that do not exist)."""
    assert dicom_fast.best_reader() is dicom_fast.read_dicom_fast
    assert dicom_fast.library_path().parent == dicom_fast.BUILD_DIR
    assert dicom_fast.BUILD_DIR.parts[-2:] == ("build", "native")
    monkeypatch.setattr(dicom_fast, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(dicom_fast, "COMPILERS", ("no-such-cc",))
    dicom_fast._load.cache_clear()
    try:
        assert not dicom_fast.available()
        assert dicom_fast.best_reader() is dicom_lite.read_dicom
        with pytest.raises(RuntimeError, match="no C compiler"):
            dicom_fast.parse_dicom_bytes_fast(b"")
        assert list((tmp_path / "native").iterdir()) == []
    finally:
        dicom_fast._load.cache_clear()


def test_discovery_uses_fast_path(tmp_path, monkeypatch):
    """read_series_volume and check_z_spacing through the native reader
    (every read goes through it) give the Python reader's volume."""
    rng = np.random.RandomState(1)
    d = tmp_path / "series"
    for i in range(3):
        write_dicom(str(d / f"{i:03d}.dcm"),
                    (rng.rand(8, 8) * 100).astype(np.uint16),
                    instance_number=i + 1, image_position=(0, 0, 1.5 * i))
    calls = []

    def counted(path, pixels=True):
        calls.append(path)
        return dicom_fast.read_dicom_fast(path, pixels=pixels)

    monkeypatch.setattr(discovery, "best_reader", lambda: counted)
    vol = discovery.read_series_volume(str(d))
    assert vol.shape == (3, 8, 8) and len(calls) == 3
    assert discovery.check_z_spacing(str(d)) == pytest.approx(1.5)
    monkeypatch.setattr(discovery, "best_reader",
                        lambda: dicom_lite.read_dicom)
    np.testing.assert_array_equal(discovery.read_series_volume(str(d)), vol)
