"""The port's native gzip file I/O (csrc/gzio_host.cpp through native.py,
built with g++ and zlib) and the NIfTI files it writes.

tests/test_native.py's gzip cases against the port's bindings; the
truncated-member check; the build contract (a failed build raises, no
stdlib fallback; FT2_DISABLE_NATIVE is the explicit opt-out); and files
crossing the two packages: a file that the port writes, through the native
library or the stdlib, reads bitwise through the JAX package's
``nifti.read``, and the reverse.
"""

import gzip
import os
import shutil

import numpy as np
import pytest

from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.core import volcache as ref_volcache
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu_torch import build, native
from fetal_t2mapping_tpu_torch.core import nifti, volcache
from fetal_t2mapping_tpu_torch.core.volume import Volume

pytestmark = pytest.mark.skipif(shutil.which(build.gxx()) is None,
                                reason="needs g++ to build csrc/gzio_host.cpp")

GEOM = dict(spacing=(0.8, 1.1, 1.3), origin=(-10.5, 4.25, 30.0),
            direction=(0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0))


@pytest.fixture(autouse=True)
def _no_cache():
    """Every read here goes to the file."""
    volcache.flush()
    volcache.clear()
    ref_volcache.clear()
    yield
    volcache.flush()
    volcache.clear()
    ref_volcache.clear()


def test_version():
    assert native.available()
    assert native.version().startswith("gzio_host")


def test_read_file_gz_and_raw(tmp_path):
    payload = os.urandom(100_000) + b"tail"
    raw_p = tmp_path / "a.bin"
    raw_p.write_bytes(payload)
    gz_p = tmp_path / "a.bin.gz"
    with gzip.open(gz_p, "wb") as f:
        f.write(payload)
    assert native.read_file(str(raw_p)) == payload
    assert native.read_file(str(gz_p)) == payload


def test_read_batch_parallel(tmp_path):
    payloads = [os.urandom(10_000 + i) for i in range(17)]
    paths = []
    for i, p in enumerate(payloads):
        fp = tmp_path / f"f{i}.gz"
        with gzip.open(fp, "wb") as f:
            f.write(p)
        paths.append(str(fp))
    assert native.read_batch(paths, n_threads=8) == payloads
    assert native.read_batch([]) == []


def test_read_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        native.read_file(str(tmp_path / "nope.gz"))
    ok = tmp_path / "ok.gz"
    with gzip.open(ok, "wb") as f:
        f.write(b"x" * 100)
    with pytest.raises(OSError, match="nope2"):
        native.read_batch([str(ok), str(tmp_path / "nope2.gz")])


def test_truncated_member_raises(tmp_path):
    """gzread returns 0 at a clean end and at a truncated member alike; the
    library tells them apart, and nifti.read names the file."""
    vol = Volume(np.arange(4000, dtype=np.float32).reshape(10, 20, 20), **GEOM)
    good = str(tmp_path / "good.nii.gz")
    nifti.write(good, vol)
    volcache.clear()
    raw = open(good, "rb").read()
    bad = tmp_path / "cut.nii.gz"
    bad.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(OSError):
        native.read_file(str(bad))
    with pytest.raises(ValueError, match="cut.nii.gz"):
        nifti.read(str(bad))
    with pytest.raises(ValueError, match="cut.nii.gz"):
        nifti.read_batch([good, str(bad)])


def test_write_file_roundtrip(tmp_path):
    data = os.urandom(50_000)
    gz_p = str(tmp_path / "w.gz")
    assert native.write_file(gz_p, data, gzip_level=6)
    with gzip.open(gz_p, "rb") as f:
        assert f.read() == data
    raw_p = str(tmp_path / "w.bin")
    assert native.write_file(raw_p, data)
    assert open(raw_p, "rb").read() == data
    with pytest.raises(OSError):
        native.write_file(str(tmp_path / "no" / "dir" / "x.gz"), data, gzip_level=4)


def test_nifti_roundtrip_through_native(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    data = rng.normal(500, 100, (9, 8, 7)).astype(np.float32)
    vol = Volume(data=data, spacing=(1.5, 2.0, 2.5), origin=(3, 4, 5))
    path = str(tmp_path / "v.nii.gz")
    nifti.write(path, vol)           # native gzip write
    volcache.clear()
    back = nifti.read(path)          # native inflate
    np.testing.assert_array_equal(back.data, data)
    np.testing.assert_allclose(back.spacing, vol.spacing, atol=1e-5)
    np.testing.assert_allclose(back.origin, vol.origin, atol=1e-4)
    # the same bytes parse identically through the stdlib path
    monkeypatch.setenv("FT2_DISABLE_NATIVE", "1")
    assert not native.available()
    np.testing.assert_array_equal(nifti.read(path).data, back.data)


def test_nifti_read_batch(tmp_path):
    vols, paths = [], []
    for i in range(5):
        v = Volume(np.full((4, 4, 4), float(i), np.float32))
        p = str(tmp_path / f"b{i}.nii.gz")
        nifti.write(p, v)
        vols.append(v)
        paths.append(p)
    volcache.clear()
    for v, o in zip(vols, nifti.read_batch(paths)):
        np.testing.assert_array_equal(o.data, v.data)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's output: nifti.read does
    not fall back to the stdlib behind the caller's back."""
    src = tmp_path / "gzio_host.cpp"
    src.write_text(open(build.GZIO_SOURCE).read() + "\n#error made to fail\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "GZIO_SOURCE", str(src))
    build.load_gzio_lib.cache_clear()
    path = str(tmp_path / "v.nii.gz")
    with gzip.open(path, "wb") as f:
        f.write(b"\x00" * 400)
    try:
        with pytest.raises(RuntimeError, match="made to fail"):
            native.available()
        with pytest.raises(RuntimeError, match="made to fail"):
            nifti.read(path)
        assert not os.path.exists(tmp_path / "build" / "libgzio_host.so")
    finally:
        build.load_gzio_lib.cache_clear()


@pytest.mark.parametrize("route", ["native", "stdlib"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16, np.uint8])
def test_files_cross_the_two_packages(tmp_path, monkeypatch, route, dtype):
    """A file the port writes (native or stdlib gzip) reads bitwise through
    the JAX package's nifti.read, and a file the JAX package writes reads
    bitwise through the port's (header geometry to the float32 of the
    file)."""
    if route == "stdlib":
        monkeypatch.setenv("FT2_DISABLE_NATIVE", "1")
    rng = np.random.default_rng(5)
    data = rng.uniform(-200, 70000, (7, 6, 5)).astype(np.float32)
    data[0, 0, :3] = [np.nan, 0.5, 70000.5]
    a, b = str(tmp_path / "port.nii.gz"), str(tmp_path / "ref.nii.gz")
    nifti.write_async(a, Volume(data, **GEOM), dtype=dtype)
    nifti.flush_writes()
    ref_nifti.write(b, RefVolume(data, **GEOM), dtype=dtype)
    ref_nifti.flush_writes()
    ref_volcache.clear()
    volcache.clear()
    got_ref, got_port = ref_nifti.read(a), nifti.read(b)
    want = nifti.read(a)
    assert want.data.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(np.asarray(got_ref.data), want.data)
    np.testing.assert_array_equal(got_port.data, want.data)
    for g in (got_ref, got_port, want):
        assert g.data.dtype == np.dtype(dtype)
        assert (g.spacing, g.origin, g.direction) == (want.spacing, want.origin, want.direction)
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        assert fa.read() == fb.read()        # decompressed header and voxels equal


_LEVEL_WRITER = r"""
import os, sys
import numpy as np
from fetal_t2mapping_tpu_torch.core import nifti
from fetal_t2mapping_tpu_torch.core.volume import Volume
if sys.argv[2] == "stdlib":
    os.environ["FT2_DISABLE_NATIVE"] = "1"
data = (np.arange(24 * 20 * 16, dtype=np.float32) % 251.0).reshape(24, 20, 16)
nifti.write(sys.argv[1], Volume(data), dtype=np.int16)
print(nifti._GZIP_LEVEL)
"""


@pytest.mark.parametrize("route", ["native", "stdlib"])
def test_gzip_level_env_on_both_routes(tmp_path, route):
    """FT2_GZIP_LEVEL (read at import, as the JAX package reads it) sets
    the level of both write routes: files written at levels 1 and 9 hold
    the same decompressed payload in different compressed bytes, and both
    packages read them back to the same voxels."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("FT2_DISABLE_NATIVE", "FT2_GZIP_LEVEL")}
    paths = {}
    for level in ("1", "9"):
        paths[level] = str(tmp_path / f"level{level}.nii.gz")
        out = subprocess.run([sys.executable, "-c", _LEVEL_WRITER, paths[level], route],
                             cwd=repo, env=dict(env, FT2_GZIP_LEVEL=level),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.split()[-1] == level
    raw = {lv: open(p, "rb").read() for lv, p in paths.items()}
    assert raw["1"] != raw["9"]
    with gzip.open(paths["1"], "rb") as f1, gzip.open(paths["9"], "rb") as f9:
        assert f1.read() == f9.read()
    want = (np.arange(24 * 20 * 16, dtype=np.float32) % 251.0).reshape(24, 20, 16)
    for p in paths.values():
        np.testing.assert_array_equal(nifti.read(p).data, want.astype(np.int16))
        np.testing.assert_array_equal(np.asarray(ref_nifti.read(p).data), want.astype(np.int16))
