"""The port's JPEG codecs (``utils/jpegll``, ``utils/jpegdct``) and its
host library (``csrc/dicom_host.cpp`` through ``build.jpegll_decode``)
against the JAX package's, on the same seeded inputs, on the CPU.

Encoders must give equal bytes and decoders equal arrays, over the
parametrisations of tests/test_jpegll.py and tests/test_jpegdct.py; a bad
stream raises the same error class with the same message in both. The
host library is held bitwise to ``utils.jpegll.decode`` over the same
grid. It is built with g++ and skips where there is none.
"""

import io
import os
import shutil
import struct

import numpy as np
import pytest

from fetal_t2mapping_tpu.utils import jpegdct as ref_dct
from fetal_t2mapping_tpu.utils import jpegll as ref_ll
from fetal_t2mapping_tpu_torch import build
from fetal_t2mapping_tpu_torch.utils import jpegdct, jpegll

# tests/test_jpegll.py:15-25: (shape, bits, predictor, point_transform, restart_interval)
LL_CASES = [
    ((6, 8), 16, 1, 0, 0),
    ((13, 7), 12, 1, 0, 0),
    ((16, 16), 16, 4, 0, 0),
    ((9, 5), 8, 7, 0, 0),
    ((12, 10), 16, 1, 0, 17),
    ((8, 8), 10, 2, 2, 0),
    ((1, 1), 16, 1, 0, 0),
    ((1, 9), 16, 3, 0, 0),
    ((64, 64), 16, 6, 0, 100),
]

needs_gxx = pytest.mark.skipif(shutil.which(build.gxx()) is None,
                               reason="needs g++ to build csrc/dicom_host.cpp")


def _rand(shape, bits, seed):
    return np.random.default_rng(seed).integers(0, 1 << bits, size=shape).astype(np.uint16)


def _smooth12(shape, seed=0, top=4095):
    """tests/test_jpegdct.py:20-25."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    img = (top / 2) * (1 + np.sin(yy / 7.0) * np.cos(xx / 5.0))
    img += rng.normal(0, top / 60.0, shape)
    return np.clip(np.round(img), 0, top).astype(np.uint16)


def _ll_stream(module, case, seed):
    shape, bits, pred, pt, ri = case
    return module.encode(_rand(shape, bits, seed), predictor=pred, point_transform=pt,
                         precision=bits, restart_interval=ri)


def _equal_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", LL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}b-p{c[2]}")
def test_jpegll_encode_and_decode_equal_reference(case):
    got, want = _ll_stream(jpegll, case, 0), _ll_stream(ref_ll, case, 0)
    assert got == want
    dec = jpegll.decode(got)
    _equal_arrays(dec, ref_ll.decode(want))
    shape, bits, _, pt, _ = case
    np.testing.assert_array_equal(dec, (_rand(shape, bits, 0) >> pt) << pt)


@needs_gxx
@pytest.mark.parametrize("case", LL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}b-p{c[2]}")
def test_host_library_bitwise_equals_python(case):
    stream = _ll_stream(jpegll, case, 1)
    _equal_arrays(build.jpegll_decode(stream), jpegll.decode(stream))


def _dct_stream(module, kind):
    if kind == "quant1-8x8":
        return module.encode(_smooth12((8, 8), seed=8), precision=12, quant=1)
    if kind == "quant1-32x24":
        return module.encode(_smooth12((32, 24), seed=32), precision=12, quant=1)
    if kind == "quant1-19x13":
        return module.encode(_smooth12((19, 13), seed=19), precision=12, quant=1)
    if kind == "table-restarts":
        q = np.concatenate([[8], np.full(63, 16)]).astype(np.int64)
        return module.encode(_smooth12((40, 40), seed=3), precision=12, quant=q,
                             restart_interval=3)
    if kind == "table-16bit":
        return module.encode(_smooth12((16, 16), seed=5), precision=12,
                             quant=np.full(64, 300, np.int64))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["quant1-8x8", "quant1-32x24", "quant1-19x13",
                                  "table-restarts", "table-16bit"])
def test_jpegdct_encode_and_decode_equal_reference(kind):
    got, want = _dct_stream(jpegdct, kind), _dct_stream(ref_dct, kind)
    assert got == want
    _equal_arrays(jpegdct.decode(got), ref_dct.decode(want))


def test_jpegdct_decodes_a_libjpeg_stream_as_the_reference():
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_smooth12((48, 40), seed=7, top=255).astype(np.uint8)).save(
        buf, format="JPEG", quality=92)
    stream = buf.getvalue()
    got = jpegdct.decode(stream)
    assert got.dtype == np.uint8
    _equal_arrays(got, ref_dct.decode(stream))


def _sof_swapped(stream: bytes, sof: bytes, to: int) -> bytes:
    b = bytearray(stream)
    b[b.find(sof) + 1] = to
    return bytes(b)


def _huge_dims(stream: bytes, sof: bytes) -> bytes:
    b = bytearray(stream)
    i = b.find(sof)
    b[i + 5:i + 9] = b"\xff\xff\xff\xff"
    return bytes(b)


# name -> a call that must raise, over tests/test_jpegll.py:73-103 and
# tests/test_jpegdct.py:74-91; each call takes the module under test
BAD = {
    "ll-non-lossless-sof": lambda m: m.decode(_sof_swapped(
        m.encode(_rand((4, 4), 8, 3), precision=8), b"\xff\xc3", 0xC0)),
    "ll-truncated": lambda m: m.decode(m.encode(_rand((8, 8), 16, 4))[:-40]),
    "ll-predictor-0": lambda m: m.encode(_rand((4, 4), 16, 5), predictor=0),
    "ll-3d": lambda m: m.encode(_rand((4, 4), 16, 5)[None]),
    "ll-precision-17": lambda m: m.encode(_rand((4, 4), 16, 5), precision=17),
    "dct-progressive": lambda m: m.decode(_sof_swapped(
        m.encode(_smooth12((8, 8)), precision=12), b"\xff\xc1", 0xC2)),
    "dct-no-soi": lambda m: m.decode(b"\x00\x00\x00\x00"),
    "dct-implausible": lambda m: m.decode(_huge_dims(
        m.encode(_smooth12((8, 8)), precision=12), b"\xff\xc1")),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_streams_raise_as_the_reference(name):
    port, ref = (jpegll, ref_ll) if name.startswith("ll") else (jpegdct, ref_dct)
    with pytest.raises(ref.JpegError) as want:
        BAD[name](ref)
    with pytest.raises(port.JpegError) as got:
        BAD[name](port)
    assert type(got.value).__name__ == type(want.value).__name__ == "JpegError"
    assert str(got.value) == str(want.value)
    assert issubclass(port.JpegError, ValueError)


@needs_gxx
def test_host_library_scope_errors_and_cap():
    # parseable but not lossless (SOF0): None, so utils/jpegll names the feature
    sof0 = _sof_swapped(jpegll.encode(_rand((4, 4), 8, 3), precision=8), b"\xff\xc3", 0xC0)
    assert build.jpegll_decode(sof0) is None
    enc = jpegll.encode(_rand((8, 8), 16, 4))
    for cut in (enc[:8], enc[:-40], b"\x00\x00\x00\x00"):
        with pytest.raises(ValueError, match="jpegll"):
            build.jpegll_decode(cut)
    # a header asking for 65535 x 65535 pixels: refused before any allocation
    with pytest.raises(ValueError, match="implausible"):
        build.jpegll_decode(_huge_dims(enc, b"\xff\xc3"))
    assert (65535 * 65535 > build.MAX_JPEG_PIXELS == 1 << 26)
    # 8-bit precision decodes to uint8, as utils/jpegll does
    eight = jpegll.encode(_rand((5, 4), 8, 2), precision=8)
    _equal_arrays(build.jpegll_decode(eight), jpegll.decode(eight))
    assert build.jpegll_decode(eight).dtype == np.uint8


@needs_gxx
def test_host_library_multicomponent_equals_python():
    """3 interleaved components (the library's scope is 1-4)."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 4096, size=(7, 9, 3)).astype(np.uint16)
    enc = _three_component_stream(img)
    got = build.jpegll_decode(enc)
    _equal_arrays(got, jpegll.decode(enc))
    np.testing.assert_array_equal(got, img)


def _three_component_stream(img):
    """A T.81 lossless stream with 3 interleaved components sharing table 0:
    predictor 1, 12-bit, every difference coded with one flat table of
    SSSS 0-16 (code length 5)."""
    rows, cols, nf = img.shape
    bits = [0, 0, 0, 0, 17] + [0] * 11
    vals = list(range(17))
    w = ref_ll._BitWriter()
    codes = {v: (i, 5) for i, v in enumerate(vals)}
    for y in range(rows):
        for x in range(cols):
            for c in range(nf):
                if y == 0 and x == 0:
                    pred = 1 << 11                 # 2^(P - 1), P = 12
                elif x == 0:
                    pred = int(img[y - 1, x, c])   # first column: above
                else:
                    pred = int(img[y, x - 1, c])   # predictor 1: left
                d = int(img[y, x, c]) - pred
                t = ref_ll._ssss(d)
                w.write(*codes[t])
                if t:
                    w.write(d if d >= 0 else d - 1, t)
    w.flush()
    scan = bytes(w.out)
    sof = struct.pack(">BHHB", 12, rows, cols, nf) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(nf))
    dht = bytes([0x00]) + bytes(bits) + bytes(vals)
    sos = bytes([nf]) + b"".join(bytes([c + 1, 0x00]) for c in range(nf)) + bytes([1, 0, 0])

    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    return (b"\xff\xd8" + seg(0xFFC3, sof) + seg(0xFFC4, dht) + seg(0xFFDA, sos) + scan
            + b"\xff\xd9")


@needs_gxx
def test_dicom_probe_flags(tmp_path):
    dcm = tmp_path / "a.dcm"
    dcm.write_bytes(b"\x00" * 128 + b"DICM" + b"\x00" * 16)
    short = tmp_path / "short"
    short.write_bytes(b"\x00" * 100)
    text = tmp_path / "b.txt"
    text.write_text("x" * 200)
    paths = [str(dcm), str(short), str(text), str(tmp_path / "missing")]
    assert build.dicom_probe(paths) == [1, 0, 0, -1]
    assert build.dicom_probe(paths, n_threads=1) == [1, 0, 0, -1]
    assert build.dicom_probe([]) == []


@needs_gxx
def test_host_build_is_atomic_and_raises(tmp_path, monkeypatch):
    """The library is built into the build directory under a private name
    and renamed into place, rebuilt only when its source is newer, and a
    failed build raises with the compiler's output and leaves nothing."""
    src = tmp_path / "dicom_host.cpp"
    shutil.copy(build.HOST_SOURCE, src)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "HOST_SOURCE", str(src))
    lib = build.build_host_lib()
    assert lib == str(tmp_path / "build" / "libdicom_host.so")
    assert os.listdir(tmp_path / "build") == ["libdicom_host.so"]
    stamp = os.path.getmtime(lib)
    assert build.build_host_lib() == lib and os.path.getmtime(lib) == stamp
    src.write_text(src.read_text() + "\n#error made to fail\n")
    os.utime(src, (stamp + 10, stamp + 10))
    with pytest.raises(RuntimeError, match="made to fail"):
        build.build_host_lib()
    assert os.listdir(tmp_path / "build") == ["libdicom_host.so"]
    assert os.path.getmtime(lib) == stamp
