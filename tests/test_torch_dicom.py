"""The port's DICOM reader (``utils/dicom``) and DICOM -> NIfTI converter
(``utils/dcm2nifti``) against the JAX package's, on the same files, on the
CPU.

``read_dcm`` must give equal elements (sequences included) and bitwise
equal pixels in every transfer syntax the tests write: explicit and
implicit VR little endian, deflated, multi-frame, RLE, JPEG-lossless (SV1,
process 14, several fragments per frame), JPEG 2000, 8-bit baseline and
12-bit extended JPEG. Errors must be of the same class with the same
message. ``series_to_volume`` / ``convert_series`` must give equal volumes
and equal NIfTI files once decompressed (header and data), and equal
sidecar JSON. The files come from the writers of tests/test_dcm2nifti.py
and tests/test_ingest.py.
"""

import gzip
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.utils import dcm2nifti as ref_d2n
from fetal_t2mapping_tpu.utils import dicom as ref_dicom
from fetal_t2mapping_tpu_torch.core import nifti
from fetal_t2mapping_tpu_torch.utils import dcm2nifti, dicom
from tests.test_dcm2nifti import (
    _el_explicit,
    _j2k_available,
    write_test_dicom,
    write_test_dicom_j2k,
    write_test_dicom_jpeg12,
    write_test_dicom_jpegll,
    write_test_dicom_multiframe,
    write_test_dicom_rle,
)
from tests.test_ingest import make_dicom

needs_j2k = pytest.mark.skipif(not _j2k_available(), reason="PIL lacks OpenJPEG")


def _pix(shape, seed, top=4000):
    return np.random.default_rng(seed).integers(0, top, size=shape).astype(np.uint16)


def _deflated(path, pixel):
    """An explicit-VR file re-encoded as Deflated Explicit VR Little Endian
    (1.2.840.10008.1.2.1.99): everything after the meta group is one raw
    DEFLATE stream."""
    write_test_dicom(path, pixel, ipp=(1.0, 2.0, 3.0))
    raw = open(path, "rb").read()
    glen = struct.unpack_from("<I", raw, 132 + 8)[0]
    meta_end = 132 + 12 + glen
    ts = b"1.2.840.10008.1.2.1.99"
    meta_body = _el_explicit(0x0002, 0x0010, b"UI", ts)
    meta = _el_explicit(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    comp = zlib.compressobj(9, zlib.DEFLATED, -15)
    body = comp.compress(raw[meta_end:]) + comp.flush()
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _jpeg8(path, pixel):
    """8-bit Baseline (1.2.840.10008.1.2.4.50), encoded by PIL/libjpeg."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixel.astype(np.uint8)).save(buf, format="JPEG", quality=95)
    stream = buf.getvalue()
    if len(stream) % 2:
        stream += b"\x00"
    ts = b"1.2.840.10008.1.2.4.50"
    meta_body = _el_explicit(0x0002, 0x0010, b"UI", ts)
    meta = _el_explicit(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    rows, cols = pixel.shape
    body = b"".join([
        _el_explicit(0x0008, 0x0060, b"CS", b"MR"),
        _el_explicit(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 8)),
        _el_explicit(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ])
    pd = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
    pd += struct.pack("<HHI", 0xFFFE, 0xE000, 0)
    pd += struct.pack("<HHI", 0xFFFE, 0xE000, len(stream)) + stream
    pd += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body + pd)


def _ramp8():
    yy, xx = np.mgrid[0:32, 0:32]
    return (96 + 2 * yy + xx).astype(np.uint16)


def _ramp12():
    yy, xx = np.mgrid[0:24, 0:16].astype(np.float64)
    return np.clip(np.round(2000 + 900 * np.sin(yy / 4) * np.cos(xx / 3)), 0,
                   4095).astype(np.uint16)


# one file per case: name -> writer(path)
FILES = {
    "explicit": lambda p: write_test_dicom(p, _pix((6, 8), 1), ipp=(10.0, 20.0, 30.0),
                                           slope=2.0, intercept=-10.0),
    "implicit": lambda p: write_test_dicom(p, _pix((6, 8), 2), ipp=(0, 0, 0), explicit=False),
    "deflated": lambda p: _deflated(p, _pix((6, 8), 3)),
    "multiframe": lambda p: write_test_dicom_multiframe(
        p, _pix((5, 6, 8), 4), ipp=(1.0, 2.0, 30.0), iop=(1, 0, 0, 0, 0, -1),
        spacing=(1.5, 2.0), dz=4.0),
    "sequences": lambda p: make_dicom(p, series="t2_haste_cor", rows=256, cols=192,
                                      spacing=(0.5, 0.75), iop=(1, 0, 0, 0, 0, -1)),
    "rle": lambda p: write_test_dicom_rle(p, np.where(_pix((6, 8), 5) > 2000, 777,
                                                      _pix((6, 8), 5)), ipp=(0.0, 0.0, 0.0)),
    "jpegll-sv1": lambda p: write_test_dicom_jpegll(p, _pix((6, 8), 6), ipp=(0.0, 0.0, 0.0)),
    "jpegll-p14-fragments": lambda p: write_test_dicom_jpegll(
        p, _pix((16, 12), 7, 65535), ipp=(0.0, 0.0, 0.0), predictor=4, n_fragments=3),
    "j2k": lambda p: write_test_dicom_j2k(p, _pix((16, 12), 8, 65535), ipp=(0.0, 0.0, 0.0)),
    "j2k-fragments": lambda p: write_test_dicom_j2k(p, _pix((16, 16), 9), ipp=(0.0, 0.0, 0.0),
                                                    n_fragments=3),
    "j2k-jp2": lambda p: write_test_dicom_j2k(p, _pix((16, 16), 9), ipp=(0.0, 0.0, 0.0),
                                              jp2=True),
    "jpeg8": lambda p: _jpeg8(p, _ramp8()),
    "jpeg12": lambda p: write_test_dicom_jpeg12(p, _ramp12(), ipp=(1.0, 2.0, 3.0)),
}


def _cases(table):
    """The names of ``table``; those written through PIL's OpenJPEG skip
    where PIL lacks it."""
    return [pytest.param(n, id=n, marks=needs_j2k if n.startswith("j2k") else ())
            for n in table]


def _plain(v):
    """A parsed dataset as nested builtins: {tag: value}, sequences as lists."""
    if hasattr(v, "_el"):
        return {k: _plain(x) for k, x in v._el.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("name", _cases(FILES))
@pytest.mark.parametrize("with_pixels", [False, True], ids=["header", "pixels"])
def test_read_dcm_equals_reference(tmp_path, name, with_pixels):
    p = str(tmp_path / f"{name}.dcm")
    FILES[name](p)
    got = dicom.read_dcm(p, with_pixels=with_pixels)
    want = ref_dicom.read_dcm(p, with_pixels=with_pixels)
    assert _plain(got) == _plain(want)
    assert got.keys() == want.keys()
    assert dicom.is_dcm_file(p) and ref_dicom.is_dcm_file(p)
    if with_pixels and name != "sequences":        # make_dicom writes no pixels
        assert isinstance(got.get("PixelData"), bytes) and got.get("PixelData")


def _outcome(read, path):
    try:
        return "parsed", _plain(read(path, with_pixels=True))
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)


def test_error_paths_equal_reference(tmp_path):
    """Unsupported transfer syntaxes, a lossless stream outside the decoder's
    scope (SOF0 in a .4.70 file: the host library hands it to utils/jpegll),
    a missing magic and big endian raise the same class and message."""
    paths = []
    rle = str(tmp_path / "jpg.dcm")
    write_test_dicom_rle(rle, _pix((4, 4), 11, 100), ipp=(0.0, 0.0, 0.0))
    raw = open(rle, "rb").read()
    open(rle, "wb").write(raw.replace(b"1.2.840.10008.1.2.5\x00", b"1.2.840.10008.1.2.4\x00"))
    paths.append(rle)
    sof0 = str(tmp_path / "sof0.dcm")
    write_test_dicom_jpegll(sof0, _pix((6, 8), 12), ipp=(0.0, 0.0, 0.0))
    raw = bytearray(open(sof0, "rb").read())
    raw[raw.find(b"\xff\xc3") + 1] = 0xC0
    open(sof0, "wb").write(bytes(raw))
    paths.append(sof0)
    trunc = str(tmp_path / "trunc.dcm")
    write_test_dicom_jpegll(trunc, _pix((16, 16), 13), ipp=(0.0, 0.0, 0.0))
    raw = open(trunc, "rb").read()
    open(trunc, "wb").write(raw[:raw.find(b"\xff\xda") + 30] + raw[-8:])
    paths.append(trunc)
    nomagic = str(tmp_path / "nomagic.dcm")
    open(nomagic, "wb").write(b"\x00" * 200)
    paths.append(nomagic)
    big = str(tmp_path / "big.dcm")
    write_test_dicom(big, _pix((4, 4), 14), ipp=(0, 0, 0))
    raw = open(big, "rb").read()
    open(big, "wb").write(raw.replace(b"1.2.840.10008.1.2.1\x00", b"1.2.840.10008.1.2.2\x00"))
    paths.append(big)
    for p in paths:
        got, want = _outcome(dicom.read_dcm, p), _outcome(ref_dicom.read_dcm, p)
        assert want[0] != "parsed", p
        assert got == want, p


def test_corruptions_fail_as_the_reference(tmp_path):
    """tests/test_dcm2nifti.py's corruption fuzz, both readers on each file:
    the same parse or the same error class and message."""
    base = str(tmp_path / "base.dcm")
    write_test_dicom_multiframe(base, _pix((2, 6, 8), 0), ipp=(0.0, 0.0, 0.0), dz=1.0)
    base_bytes = open(base, "rb").read()
    rng = np.random.default_rng(42)
    kinds = {"parsed": 0, "raised": 0}
    for i in range(80):
        buf = bytearray(base_bytes)
        kind = i % 4
        if kind == 0:
            buf = buf[:rng.integers(136, len(buf))]
        elif kind == 1:
            j = int(rng.integers(128, min(420, len(buf))))
            buf[j] ^= int(rng.integers(1, 256))
        elif kind == 2:
            j = int(rng.integers(132, min(420, len(buf) - 4)))
            buf[j:j + 4] = rng.integers(0, 256, 4).astype("uint8").tobytes()
        else:
            j = int(rng.integers(150, min(420, len(buf) - 4)))
            buf[j:j + 4] = struct.pack("<I", 0xFFFFFFF0)
        p = str(tmp_path / f"fuzz_{i}.dcm")
        open(p, "wb").write(bytes(buf))
        got, want = _outcome(dicom.read_dcm, p), _outcome(ref_dicom.read_dcm, p)
        assert got == want, i
        kinds["parsed" if got[0] == "parsed" else "raised"] += 1
    assert min(kinds.values()) >= 5, kinds


def _series(tmp_path, explicit=True):
    paths = []
    truth = _pix((5, 6, 8), 0)
    for i in reversed(range(5)):
        p = str(tmp_path / f"sl{i}.dcm")
        write_test_dicom(p, truth[i], ipp=(10.0, 20.0, 30.0 + 3.0 * i), instance=i + 1,
                         explicit=explicit)
        paths.append(p)
    return paths


def _slices(tmp_path, writer, n=3, **kw):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"s{i}.dcm")
        writer(p, _pix((6, 8), 20 + i), ipp=(0.0, 0.0, 3.0 * i), instance=i + 1, **kw)
        paths.append(p)
    return paths


def _one(tmp_path, writer, *args, **kw):
    p = str(tmp_path / "one.dcm")
    writer(p, *args, **kw)
    return [p]


def _file(tmp_path, name):
    p = str(tmp_path / f"{name}.dcm")
    FILES[name](p)
    return [p]


# name -> a function of tmp_path giving the series' paths
SERIES = {
    "explicit-shuffled": lambda t: _series(t),
    "implicit": lambda t: _series(t, explicit=False),
    "multiframe-coronal": lambda t: _file(t, "multiframe"),
    "rescale-float": lambda t: _one(t, write_test_dicom, np.arange(48, dtype=np.uint16)
                                    .reshape(6, 8), ipp=(0, 0, 0), slope=0.5, intercept=0.25),
    "uint16": lambda t: _one(t, write_test_dicom, _pix((6, 8), 30) + 40000, ipp=(0, 0, 0)),
    "sagittal": lambda t: _one(t, write_test_dicom, _pix((6, 8), 31), ipp=(5, 6, 7),
                               iop=(0, 1, 0, 0, 0, -1)),
    "rle": lambda t: _slices(t, write_test_dicom_rle),
    "jpegll": lambda t: _slices(t, write_test_dicom_jpegll),
    "jpeg12": lambda t: _one(t, write_test_dicom_jpeg12, _ramp12(), ipp=(1.0, 2.0, 3.0)),
    "j2k": lambda t: _slices(t, write_test_dicom_j2k),
}


@pytest.mark.parametrize("name", _cases(SERIES))
def test_series_and_conversion_equal_reference(tmp_path, name):
    paths = SERIES[name](tmp_path)
    vol, ds = dcm2nifti.series_to_volume(paths)
    rvol, rds = ref_d2n.series_to_volume(paths)
    assert vol.data.dtype == np.float32
    np.testing.assert_array_equal(vol.data, np.asarray(rvol.data))
    assert (vol.spacing, vol.origin, vol.direction) == (rvol.spacing, rvol.origin, rvol.direction)
    assert _plain(ds) == _plain(rds)

    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    nii, js = dcm2nifti.convert_series(paths, str(tmp_path / "port" / "x_T2w"))
    rnii, rjs = ref_d2n.convert_series(paths, str(tmp_path / "ref" / "x_T2w"))
    got, want = nifti.read(nii), ref_nifti.read(rnii)
    assert got.data.dtype == np.asarray(want.data).dtype
    np.testing.assert_array_equal(got.data, np.asarray(want.data))
    np.testing.assert_array_equal(nifti._itk_to_affine_ras(got), ref_nifti._itk_to_affine_ras(want))
    assert (got.spacing, got.origin, got.direction) == (want.spacing, want.origin,
                                                        want.direction)
    with gzip.open(nii) as a, gzip.open(rnii) as b:
        assert a.read() == b.read()              # header and voxels, decompressed
    with open(js) as a, open(rjs) as b:
        text = a.read()
        assert text == b.read()
    assert json.loads(text)["Rows"] == int(ds.get("Rows"))


def test_group_series_and_repeated_positions_equal_reference(tmp_path):
    paths = _series(tmp_path)[:2]
    other = str(tmp_path / "other.dcm")
    write_test_dicom(other, np.zeros((6, 8), np.uint16), ipp=(0, 0, 0), series_uid="9.9.9")
    assert dcm2nifti.group_series(paths + [other]) == ref_d2n.group_series(paths + [other])
    dup = []
    for i, te in enumerate((114.0, 202.0)):
        p = str(tmp_path / f"dup{i}.dcm")
        write_test_dicom(p, _pix((6, 8), i), ipp=(0, 0, 0), te=te, instance=i + 1)
        dup.append(p)
    with pytest.raises(ValueError) as got:
        dcm2nifti.series_to_volume(dup)
    with pytest.raises(ValueError) as want:
        ref_d2n.series_to_volume(dup)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty series"):
        dcm2nifti.series_to_volume([])


@pytest.mark.parametrize("data,dtype", [
    (np.zeros((0, 2, 2), np.float32), np.float32),
    (np.array([[[-5.0, 7.0]]], np.float32), np.int16),
    (np.array([[[0.0, 40000.0]]], np.float32), np.uint16),
    (np.array([[[-1.0, 40000.0]]], np.float32), np.float32),
    (np.array([[[0.5, 2.0]]], np.float32), np.float32),
    (np.array([[[np.nan, 2.0]]], np.float32), np.float32),
])
def test_disk_dtype_equals_reference(data, dtype):
    assert dcm2nifti._disk_dtype(data) == ref_d2n._disk_dtype(data) == np.dtype(dtype)
