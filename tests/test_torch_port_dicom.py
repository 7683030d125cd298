"""The port's DICOM ingest and export against mrisr_tpu's (CPU): the cases of
tests/test_dicom.py, each run through both packages on the same seeded
inputs.  The writers and the exporter must emit the same bytes; the parsers,
discovery, the cleaner's scan, the extractor and pack_dicom_tree must give
equal results (pixel arrays and packed volumes bit for bit)."""

import json
import os
import struct
import warnings
import zipfile

import numpy as np
import pytest

from mrisr_tpu.data import clean as jax_clean
from mrisr_tpu.data import dicom_lite as jax_lite
from mrisr_tpu.data import discovery as jax_discovery
from mrisr_tpu.data.export import export_volume_dicom as jax_export
from mrisr_tpu.data.extract import extract_zip as jax_extract_zip
from mrisr_tpu.data.volumes import VolumeStore as JaxVolumeStore
from mrisr_tpu_torch.data import clean, dicom_fast, discovery
from mrisr_tpu_torch.data.dicom_lite import (
    EXPLICIT_VR_LE,
    parse_dicom_bytes,
    read_dicom,
    write_dicom,
)
from mrisr_tpu_torch.data.export import export_volume_dicom
from mrisr_tpu_torch.data.extract import extract_zip
from mrisr_tpu_torch.data.volumes import VolumeStore


def assert_same_parse(got, want):
    """Two DicomFiles (the port's, the JAX package's) field for field, and
    their pixel arrays bit for bit."""
    assert got.fields == want.fields
    if want.pixel_array is None:
        assert got.pixel_array is None
    else:
        assert got.pixel_array.dtype == want.pixel_array.dtype
        np.testing.assert_array_equal(got.pixel_array, want.pixel_array)


def parse_both(data: bytes, pixels: bool = True):
    got = parse_dicom_bytes(data, pixels=pixels)
    assert_same_parse(got, jax_lite.parse_dicom_bytes(data, pixels=pixels))
    return got


def write_series(folder, n_slices=6, rows=16, cols=18, modality="MR",
                 desc="T2 AXIAL", z_step=1.5, seed=0):
    """tests/test_dicom.py's series, written by the port's writer."""
    rng = np.random.default_rng(seed)
    vols = []
    for i in range(n_slices):
        arr = (rng.random((rows, cols)) * 1000).astype(np.uint16)
        vols.append(arr)
        write_dicom(os.path.join(folder, f"slice_{i:03d}.dcm"), arr,
                    modality=modality, series_description=desc,
                    instance_number=i + 1,
                    image_position=(0.0, 0.0, i * z_step))
    return np.stack(vols)


def el_explicit(group, elem, vr, value):
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return (struct.pack("<HH", group, elem) + vr + b"\x00\x00"
                + struct.pack("<I", len(value)) + value)
    return (struct.pack("<HH", group, elem) + vr
            + struct.pack("<H", len(value)) + value)


def el_implicit(group, elem, value):
    return struct.pack("<HHI", group, elem, len(value)) + value


def implicit_body(arr):
    return b"".join([
        el_implicit(0x0008, 0x0060, b"MR"),
        el_implicit(0x0028, 0x0010, struct.pack("<H", arr.shape[0])),
        el_implicit(0x0028, 0x0011, struct.pack("<H", arr.shape[1])
                    + b"\x00\x00"),
        el_implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        el_implicit(0x7FE0, 0x0010, arr.astype("<u2").tobytes()),
    ])


def compressed_us() -> bytes:
    """A part-10 US file whose PixelData is encapsulated (compressed)."""
    frag = struct.pack("<HHI", 0xFFFE, 0xE000, 4) + b"\x01\x02\x03\x04"
    delim = struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    body = el_explicit(0x0008, 0x0060, b"CS", b"US")
    body += (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
             + struct.pack("<I", 0xFFFFFFFF) + frag + delim)
    return b"\x00" * 128 + b"DICM" + body


WRITER_ARGS = [
    {},
    {"modality": "MR", "series_description": "T2 test",
     "image_position": (1.5, -2.0, 33.0)},
    {"modality": "US", "series_description": "T2 3D RENDERING",
     "patient_id": "Prostate-MRI-US-Biopsy-0007", "series_uid": "1.2.840.9.1",
     "instance_number": 17, "image_position": None,
     "pixel_spacing": (0.5, 0.664)},
]


@pytest.mark.parametrize("kw", WRITER_ARGS, ids=["defaults", "t2", "us"])
def test_dicom_roundtrip(tmp_path, kw):
    """The writers emit the same bytes; both readers read them back the
    same, pixels exactly."""
    arr = (np.random.default_rng(1).random((12, 14)) * 4000).astype(np.uint16)
    got, want = str(tmp_path / "port.dcm"), str(tmp_path / "jax.dcm")
    write_dicom(got, arr, **kw)
    jax_lite.write_dicom(want, arr, **kw)
    assert open(got, "rb").read() == open(want, "rb").read()
    d = read_dicom(got)
    assert_same_parse(d, jax_lite.read_dicom(got))
    assert d.modality == kw.get("modality", "MR")
    assert int(d.get("Rows")) == 12 and int(d.get("Columns")) == 14
    assert d.image_position == kw.get("image_position", (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(d.pixel_array, arr.astype(np.float32))
    # a float array is clipped to uint16 by both writers alike
    f = np.random.default_rng(2).normal(0, 3e4, (5, 7))
    write_dicom(got, f, **kw)
    jax_lite.write_dicom(want, f, **kw)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_dicom_implicit_vr_parse():
    """A part-10 file whose meta group negotiates implicit VR."""
    arr = np.arange(20, dtype=np.uint16).reshape(4, 5)
    ts = el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2\x00")
    data = (b"\x00" * 128 + b"DICM"
            + el_explicit(0x0002, 0x0000, b"UL", struct.pack("<I", len(ts)))
            + ts + implicit_body(arr))
    d = parse_both(data)
    assert d.modality == "MR"
    np.testing.assert_array_equal(d.pixel_array, arr.astype(np.float32))


def test_rescale_applied(tmp_path):
    """No slope/intercept in the writer's file: identity; a hand-built one
    rescales, the same in both parsers."""
    arr = (np.ones((4, 4)) * 100).astype(np.uint16)
    p = str(tmp_path / "r.dcm")
    write_dicom(p, arr)
    d = parse_both(open(p, "rb").read())
    np.testing.assert_array_equal(d.pixel_array, arr.astype(np.float32))
    body = b"".join([
        el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", 4)),
        el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", 4)),
        el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el_explicit(0x0028, 0x1052, b"DS", b"-1024 "),
        el_explicit(0x0028, 0x1053, b"DS", b"2.5 "),
        el_explicit(0x7FE0, 0x0010, b"OW", arr.astype("<u2").tobytes()),
    ])
    d = parse_both(body)
    np.testing.assert_array_equal(d.pixel_array,
                                  arr.astype(np.float32) * 2.5 - 1024.0)


def test_discovery_and_volume(tmp_path):
    sdir = tmp_path / "P1" / "study" / "series1"
    sdir.mkdir(parents=True)
    truth = write_series(str(sdir), n_slices=6)
    for mod in (discovery, jax_discovery):
        assert mod.discover_series(str(tmp_path / "P1"),
                                   require_slices=6) == [str(sdir)]
        assert mod.discover_series(str(tmp_path / "P1"),
                                   require_slices=60) == []
        assert mod.discover_series(str(tmp_path / "P1"),
                                   require_slices=None) == [str(sdir)]
        assert mod.count_slices(str(sdir)) == 6
        assert mod.count_slices(None) == 0
    vol = discovery.read_series_volume(str(sdir))
    assert vol.shape == (6, 16, 18) and vol.dtype == np.float32
    np.testing.assert_array_equal(vol, truth.astype(np.float32))
    np.testing.assert_array_equal(
        vol, jax_discovery.read_series_volume(str(sdir)))
    np.testing.assert_array_equal(
        discovery.read_series_volume(str(sdir), sort_by="position"), vol)
    assert discovery.read_series_volume(None) is None
    assert discovery.check_z_spacing(str(sdir)) == pytest.approx(1.5)
    assert discovery.check_z_spacing(str(sdir)) == \
        jax_discovery.check_z_spacing(str(sdir))


def make_clean_tree(root):
    keep = root / "Prostate-MRI-US-Biopsy-0001" / "study" / "mr_series"
    drop_us = root / "Prostate-MRI-US-Biopsy-0001" / "study" / "us_series"
    drop_3d = root / "Prostate-MRI-US-Biopsy-0002" / "study" / "render"
    for d in (keep, drop_us, drop_3d):
        d.mkdir(parents=True)
    write_series(str(keep), 3, modality="MR")
    write_series(str(drop_us), 3, modality="US")
    write_series(str(drop_3d), 3, modality="MR", desc="3D RENDERING recon")
    # a compressed US series (header-only parse), an empty series and a
    # series of unreadable files: deleted, kept, kept
    comp = root / "Prostate-MRI-US-Biopsy-0002" / "study" / "us_compressed"
    comp.mkdir()
    (comp / "0.dcm").write_bytes(compressed_us())
    (root / "Prostate-MRI-US-Biopsy-0002" / "study" / "empty").mkdir()
    bad = root / "Prostate-MRI-US-Biopsy-0002" / "study" / "bad"
    bad.mkdir()
    (bad / "0.dcm").write_bytes(b"\x01")
    (root / "other-0001").mkdir()
    return keep, drop_us, drop_3d, comp


def test_cleaner(tmp_path):
    root = tmp_path / "ds"
    keep, drop_us, drop_3d, comp = make_clean_tree(root)
    for d in (keep, drop_us, drop_3d, comp):
        assert clean.is_unwanted_series(str(d)) == \
            jax_clean.is_unwanted_series(str(d))
    assert not clean.is_unwanted_series(str(keep))
    assert clean.is_unwanted_series(str(drop_us))
    assert clean.is_unwanted_series(str(drop_3d))
    assert clean.is_unwanted_series(str(comp))

    to_delete, total = clean.scan_dataset(str(root))
    want, want_total = jax_clean.scan_dataset(str(root))
    assert total == want_total == 6
    assert [vars(t) for t in to_delete] == [vars(t) for t in want]
    assert len(to_delete) == 3

    assert clean.clean_dataset(to_delete, dry_run=True) == 0
    assert drop_us.exists()
    assert clean.clean_dataset(to_delete, confirm=lambda: False) == 0
    assert drop_us.exists()
    assert clean.clean_dataset(to_delete, confirm=lambda: True) == 3
    assert keep.exists() and not drop_us.exists() and not drop_3d.exists()
    assert not comp.exists()
    assert clean.scan_dataset(str(root)) == ([], 3)


def test_extract_zip(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("hello")
    (src / "b.txt").write_text("world")
    zpath = str(tmp_path / "data.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(src / "a.txt", "a.txt")
        zf.write(src / "b.txt", "sub/b.txt")
        zf.writestr("sub/deeper/c.bin", bytes(range(256)))
    got = extract_zip(zpath, str(tmp_path / "out"))
    assert got == jax_extract_zip(zpath, str(tmp_path / "jax_out")) == (3, 0)
    for rel in ("a.txt", "sub/b.txt", "sub/deeper/c.bin"):
        assert (tmp_path / "out" / rel).read_bytes() == (
            tmp_path / "jax_out" / rel).read_bytes()
    assert (tmp_path / "out" / "sub" / "b.txt").read_text() == "world"
    (tmp_path / "not.zip").write_bytes(b"plain text")
    with pytest.raises(ValueError, match="not a zip"):
        extract_zip(str(tmp_path / "not.zip"), str(tmp_path / "o2"))


def test_pack_dicom_tree_end_to_end(tmp_path):
    """DICOM tree -> packed store, the exactly-N rule enforced; the same
    manifest (but its source path) and the same volumes as the JAX
    package's."""
    root = tmp_path / "manifest" / "Prostate-MRI-US-Biopsy"
    good = root / "Prostate-MRI-US-Biopsy-0001" / "study" / "t2"
    good2 = root / "Prostate-MRI-US-Biopsy-0003" / "s" / "t2"
    short = root / "Prostate-MRI-US-Biopsy-0002" / "study" / "t2"
    for d in (good, good2, short):
        d.mkdir(parents=True)
    truth = write_series(str(good), n_slices=6, seed=1)
    write_series(str(good2), n_slices=6, seed=3, rows=20, cols=12)
    write_series(str(short), n_slices=4, seed=2)

    store = VolumeStore.pack_dicom_tree(str(tmp_path / "packed"), str(root),
                                        require_slices=6)
    want = JaxVolumeStore.pack_dicom_tree(str(tmp_path / "jax_packed"),
                                          str(root), require_slices=6)
    assert len(store) == 2
    assert store.entries[0].patient_id == "Prostate-MRI-US-Biopsy-0001"
    got_m = json.loads((tmp_path / "packed" / "manifest.json").read_text())
    want_m = json.loads((tmp_path / "jax_packed" / "manifest.json")
                        .read_text())
    assert got_m == want_m
    assert got_m["meta"] == {"source": str(root)}
    for i, e in enumerate(store.entries):
        assert (tmp_path / "packed" / e.file).read_bytes() == (
            tmp_path / "jax_packed" / want.entries[i].file).read_bytes()
    np.testing.assert_array_equal(store.load_series(0),
                                  truth.astype(np.float32))
    assert store.load_series(1).shape == (6, 20, 12)


def test_export_volume_roundtrip(tmp_path):
    """The exporter writes the JAX exporter's files byte for byte; read back,
    the volume is its uint16 map at the requested Z spacing."""
    vol = np.random.default_rng(9).standard_normal((5, 16, 16)).astype(
        np.float32)
    out = export_volume_dicom(vol, str(tmp_path / "pred"), z_spacing=3.0)
    jax_out = jax_export(vol, str(tmp_path / "jax_pred"), z_spacing=3.0)
    files = sorted(os.listdir(out))
    assert files == sorted(os.listdir(jax_out)) == [
        f"slice_{z:03d}.dcm" for z in range(5)]
    for f in files:
        assert open(os.path.join(out, f), "rb").read() == open(
            os.path.join(jax_out, f), "rb").read(), f
    back = discovery.read_series_volume(out)
    assert back.shape == (5, 16, 16)
    lo, hi = float(vol.min()), float(vol.max())
    codes = ((vol - lo) * (65535.0 / (hi - lo + 1e-8))).astype(np.uint16)
    np.testing.assert_array_equal(back, codes.astype(np.float32))
    assert np.corrcoef(vol.ravel(), back.ravel())[0, 1] > 0.9999
    assert discovery.check_z_spacing(out) == pytest.approx(3.0)
    d = read_dicom(os.path.join(out, files[2]), pixels=False)
    assert d.get("PatientID") == "mrisr-pred" and d.pixel_array is None
    assert d.get("InstanceNumber") == "3"


def test_undefined_length_sequence_skipping():
    """An undefined-length SQ holding an undefined-length item of
    explicit-VR elements, before the geometry tags."""
    inner = el_explicit(0x0008, 0x1150, b"UI", b"1.2.840.10008.5.1.4.1.1.4\x00")
    inner += el_explicit(0x0008, 0x1155, b"UI", b"1.2.3.4.5.6.7\x00")
    item = struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + inner
    item += struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
    # a defined-length item too, and a nested undefined-length SQ
    nested = (struct.pack("<HH", 0x0008, 0x1199) + b"SQ\x00\x00"
              + struct.pack("<I", 0xFFFFFFFF)
              + struct.pack("<HHI", 0xFFFE, 0xE000, 4) + b"abcd"
              + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    item2 = (struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + nested
             + struct.pack("<HHI", 0xFFFE, 0xE00D, 0))
    sq = struct.pack("<HH", 0x0008, 0x1140) + b"SQ" + b"\x00\x00"
    sq += struct.pack("<I", 0xFFFFFFFF) + item + item2
    sq += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    arr = np.arange(12, dtype=np.uint16).reshape(3, 4)
    body = el_explicit(0x0008, 0x0060, b"CS", b"MR")
    body += sq
    body += el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", 3))
    body += el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", 4))
    body += el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += el_explicit(0x7FE0, 0x0010, b"OW", arr.astype("<u2").tobytes())
    meta = el_explicit(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode())
    data = (b"\x00" * 128 + b"DICM"
            + el_explicit(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))
            + meta + body)
    d = parse_both(data)
    assert d.modality == "MR"
    assert int(d.get("Rows")) == 3 and int(d.get("Columns")) == 4
    np.testing.assert_array_equal(d.pixel_array, arr.astype(np.float32))


def test_string_vr_space_padding(tmp_path):
    """Odd-length string values are space-padded, UIs NUL-padded."""
    p = str(tmp_path / "pad.dcm")
    write_dicom(p, np.zeros((2, 2), np.uint16), series_uid="1.2.3",
                image_position=(0.0, 0.0, 1.5))
    raw = open(p, "rb").read()
    assert b"0\\0\\1.5 " in raw and b"1.2.3\x00" in raw
    d = parse_both(raw)
    assert d.image_position == (0.0, 0.0, 1.5)
    assert d.get("SeriesInstanceUID") == "1.2.3"


def test_compressed_pixeldata_header_only_parse():
    """Encapsulated PixelData: a header-only parse returns the fields (the
    cleaner reads Modality from compressed US series); pixels raise."""
    data = compressed_us()
    d = parse_both(data, pixels=False)
    assert d.modality == "US" and d.pixel_array is None
    with pytest.raises(ValueError, match="compressed"):
        parse_dicom_bytes(data, pixels=True)


def test_compressed_pixeldata_header_only_native(native):
    """The same contract through the port's native scanner."""
    data = compressed_us()
    d = dicom_fast.parse_dicom_bytes_fast(data, pixels=False)
    assert_same_parse(d, parse_dicom_bytes(data, pixels=False))
    assert d.modality == "US" and d.pixel_array is None
    with pytest.raises(ValueError, match="compressed"):
        dicom_fast.parse_dicom_bytes_fast(data, pixels=True)


def test_raw_implicit_vr_dataset_sniffed():
    """A dataset with no part-10 header, implicit VR: found by the sniff."""
    arr = np.arange(20, dtype=np.uint16).reshape(4, 5)
    d = parse_both(implicit_body(arr))
    assert d.modality == "MR"
    np.testing.assert_array_equal(d.pixel_array, arr.astype(np.float32))


def test_position_sort_falls_back_on_missing_positions(tmp_path):
    """Some slices lack ImagePositionPatient: filename order, with the
    warning, in both packages; with every position there, Z order."""
    folder = tmp_path / "series"
    folder.mkdir()
    for i in range(4):
        write_dicom(str(folder / f"s{i:03d}.dcm"), np.full((4, 4), i, np.uint16),
                    modality="MR",
                    image_position=None if i == 2 else (0.0, 0.0,
                                                        float(10 - i)))
    for mod in (discovery, jax_discovery):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            vol = mod.read_series_volume(str(folder), sort_by="position")
        assert [float(vol[i, 0, 0]) for i in range(4)] == [0.0, 1.0, 2.0, 3.0]
        assert any("filename order" in str(x.message) for x in w)
    write_dicom(str(folder / "s002.dcm"), np.full((4, 4), 2, np.uint16),
                image_position=(0.0, 0.0, 8.0))
    vol = discovery.read_series_volume(str(folder), sort_by="position")
    assert [float(vol[i, 0, 0]) for i in range(4)] == [3.0, 2.0, 1.0, 0.0]
    np.testing.assert_array_equal(
        vol, jax_discovery.read_series_volume(str(folder), sort_by="position"))


@pytest.fixture
def native():
    if not dicom_fast.available():
        pytest.skip("no C compiler on this machine: the Python parser runs")
