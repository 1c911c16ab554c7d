"""The port's volume cache and asynchronous NIfTI writes
(fetal_t2mapping_tpu_torch/core/volcache.py, core/nifti.py).

The reference's cases of tests/test_volcache.py run against the port's
modules: the filesystem-is-checkpoint contract survives the cache (reads
reflect what the write put on disk, an external change or deletion
invalidates, queued writes are visible to exists()/read() and land by
flush()). Then what the port adds: the two fixes to the reference's
writer (each scenario also run on the reference's module, where it shows
the fault), the in-place-modification guard on cached tensors, and the
disk cast on a tensor against numpy's.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from fetal_t2mapping_tpu.core import volcache as ref_volcache
from fetal_t2mapping_tpu_torch.core import nifti, volcache
from fetal_t2mapping_tpu_torch.core.volume import Volume

torch.set_num_threads(1)


def _vol(val, shape=(6, 5, 4), dtype=np.float32):
    data = np.full(shape, val, dtype)
    return Volume(data, spacing=(1, 1, 1), origin=(0, 0, 0))


@pytest.fixture(autouse=True)
def _clean_cache():
    volcache.flush()
    volcache.clear()
    yield
    volcache.flush()
    volcache.clear()


def test_write_then_read_hits_cache(tmp_path):
    p = str(tmp_path / "a.nii.gz")
    v = _vol(3.0)
    nifti.write(p, v)
    r = nifti.read(p)
    # the cached array is served without a disk read or a copy: a read-only
    # view of it, as a disk read's payload is read-only
    assert r.data.base is v.data and not r.data.flags.writeable
    volcache.clear()
    r2 = nifti.read(p)
    np.testing.assert_array_equal(np.asarray(r2.data), np.asarray(v.data))


def test_dtype_cast_is_reflected_in_cache(tmp_path):
    p = str(tmp_path / "m.nii.gz")
    mask = Volume(np.ones((4, 4, 4), bool), spacing=(1, 1, 1), origin=(0, 0, 0))
    nifti.write(p, mask, dtype=np.uint8)
    assert np.asarray(nifti.read(p).data).dtype == np.uint8   # cache == disk dtype
    volcache.clear()
    assert np.asarray(nifti.read(p).data).dtype == np.uint8


def test_external_modification_invalidates(tmp_path):
    pa, pb = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    nifti.write(pa, _vol(1.0))
    nifti.write(pb, _vol(2.0))
    shutil.copy(pb, pa)                      # external overwrite of pa
    os.utime(pa)                             # a fresh mtime_ns
    assert float(np.asarray(nifti.read(pa).data)[0, 0, 0]) == 2.0


def test_deleted_file_is_not_served_from_cache(tmp_path):
    p = str(tmp_path / "gone.nii.gz")
    nifti.write(p, _vol(1.0))
    os.remove(p)
    with pytest.raises(OSError):
        nifti.read(p)


def test_write_async_visible_and_flushes(tmp_path):
    p = str(tmp_path / "async.nii.gz")
    v = _vol(7.5)
    nifti.write_async(p, v)
    assert nifti.exists(p)                   # pending or landed
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), v.data)
    nifti.flush_writes()
    assert os.path.exists(p)
    volcache.clear()
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), v.data)


def test_deferred_flushes_collapse_barriers(tmp_path):
    p1, p2 = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    with nifti.deferred_flushes():
        nifti.write_async(p1, _vol(1.0))
        nifti.flush_writes()                  # deferred: no barrier
        assert nifti.exists(p1)
        np.testing.assert_array_equal(np.asarray(nifti.read(p1).data), _vol(1.0).data)
        with nifti.deferred_flushes():        # re-entrant
            nifti.write_async(p2, _vol(2.0))
            nifti.flush_writes(force=True)    # forced: a real barrier
            assert os.path.exists(p2)
        nifti.flush_writes()                  # still inside the outer scope
    assert os.path.exists(p1)                 # the outermost exit flushed
    volcache.clear()
    assert float(np.asarray(nifti.read(p1).data)[0, 0, 0]) == 1.0


def test_deferred_flushes_depth_restored_on_error(tmp_path):
    p = str(tmp_path / "e.nii.gz")
    with pytest.raises(RuntimeError):
        with nifti.deferred_flushes():
            nifti.write_async(p, _vol(3.0))
            raise RuntimeError("stage failed")
    assert os.path.exists(p)
    nifti.write_async(p, _vol(4.0))
    nifti.flush_writes()
    volcache.clear()
    assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == 4.0


def test_async_overwrite_order(tmp_path):
    p = str(tmp_path / "ow.nii.gz")
    nifti.write_async(p, _vol(1.0))
    nifti.write_async(p, _vol(2.0))
    nifti.flush_writes()
    volcache.clear()
    assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == 2.0


def test_async_error_surfaces_at_flush(tmp_path):
    p = str(tmp_path / "no" / "such" / "dir" / "x.nii.gz")
    nifti.write_async(p, _vol(1.0))
    with pytest.raises(OSError):
        nifti.flush_writes()
    nifti.flush_writes()                     # the error queue was drained


def test_read_batch_mixes_cache_and_disk(tmp_path):
    pa, pb = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    va, vb = _vol(1.0), _vol(2.0)
    nifti.write(pa, va)
    nifti.write(pb, vb)
    volcache.invalidate(pb)                  # pb comes from disk
    ra, rb = nifti.read_batch([pa, pb])
    assert ra.data.base is va.data
    np.testing.assert_array_equal(np.asarray(rb.data), vb.data)


def test_lru_eviction_spares_nothing_needed(tmp_path, monkeypatch):
    monkeypatch.setattr(volcache, "_CACHE_MB", 0.003)   # 3 KB cap
    pa, pb = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    nifti.write(pa, _vol(1.0, shape=(8, 8, 8)))         # 2 KB each
    nifti.write(pb, _vol(2.0, shape=(8, 8, 8)))
    assert volcache.get(pa) is None                     # evicted
    assert volcache.get(pb) is not None
    assert float(np.asarray(nifti.read(pa).data)[0, 0, 0]) == 1.0


def test_concurrent_read_write_flush(tmp_path):
    """A reader thread reads paths while the main pattern queues writes and
    stage boundaries flush: no deadlock, no torn read, disk consistent."""
    paths = [str(tmp_path / f"v{i}.nii.gz") for i in range(24)]
    vals = {p: float(i) for i, p in enumerate(paths)}
    errors = []

    def writer():
        try:
            for p in paths:
                nifti.write_async(p, _vol(vals[p]))
        except Exception as e:                    # pragma: no cover
            errors.append(e)

    def reader():
        try:
            for p in paths:
                for _ in range(50):
                    if nifti.exists(p):
                        assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == vals[p]
                        break
        except Exception as e:
            errors.append(e)

    def flusher():
        try:
            for _ in range(5):
                nifti.flush_writes()
        except Exception as e:                    # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (writer, reader, flusher, reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "volcache deadlock"
    assert not errors, errors
    nifti.flush_writes()
    volcache.clear()
    for p in paths:
        assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == vals[p]


def test_tensor_roundtrip(tmp_path):
    """The reference's device-array case, with a torch tensor: the cache hit
    and the disk read after a flush both give the written values."""
    p = str(tmp_path / "dev.nii.gz")
    host = np.random.default_rng(0).normal(size=(5, 6, 7)).astype(np.float32)
    nifti.write_async(p, Volume(torch.from_numpy(host.copy()), spacing=(1, 1, 1)))
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), host)
    nifti.flush_writes()
    volcache.clear()
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), host)


def test_failed_async_write_drops_cache_entry(tmp_path):
    """A write that never landed is not served as a phantom checkpoint."""
    p = str(tmp_path / "missing_dir" / "x.nii.gz")
    nifti.write_async(p, _vol(4.0))
    with pytest.raises(OSError):
        nifti.flush_writes()
    assert not nifti.exists(p)
    assert volcache.get(p) is None
    with pytest.raises(FileNotFoundError):
        nifti.read(p)


def test_failed_sync_write_drops_cache_entry(tmp_path, monkeypatch):
    monkeypatch.setattr(volcache, "_ASYNC_ON", False)
    p = str(tmp_path / "missing_dir" / "y.nii.gz")
    with pytest.raises(OSError):
        nifti.write(p, _vol(4.0))
    assert volcache.get(p) is None
    assert not nifti.exists(p)


def test_async_write_readable_when_cache_disabled(tmp_path, monkeypatch):
    """FT2_VOLCACHE=0 with async writes on: read() waits for the queued
    write instead of racing it to the filesystem."""
    monkeypatch.setattr(volcache, "_CACHE_ON", False)
    p = str(tmp_path / "nc.nii.gz")
    v = _vol(7.0)
    nifti.write_async(p, v)
    assert nifti.exists(p)
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), v.data)
    nifti.flush_writes()


def test_oversize_volume_still_readable_while_queued(tmp_path, monkeypatch):
    monkeypatch.setattr(volcache, "_CACHE_MB", 0.001)   # 1 KB cap
    p = str(tmp_path / "big.nii.gz")
    v = _vol(5.0, shape=(16, 16, 16))                   # 16 KB > cap
    nifti.write_async(p, v)
    assert volcache.get(p) is None                      # not cached
    np.testing.assert_array_equal(np.asarray(nifti.read(p).data), v.data)


def test_entry_pending_until_marked_written(tmp_path):
    p = str(tmp_path / "pend.nii.gz")
    volcache.put(p, _vol(9.0))                # the write has not landed
    assert volcache.get(p) is not None
    assert volcache.get(p) is not None        # the entry survived the reads
    volcache.invalidate(p)


def _stall_writer_pool(mod=volcache):
    """Park every writer-pool thread on a blocked task; returns the Event
    that releases them ('queued but not on disk' without racing the pool)."""
    release = threading.Event()
    started = threading.Barrier(mod._THREADS + 1)

    def blocker():
        started.wait(timeout=30)
        release.wait(timeout=30)

    for _ in range(mod._THREADS):
        mod._get_executor().submit(blocker)
    started.wait(timeout=30)
    return release


def test_list_volumes_sees_queued_writes(tmp_path):
    import glob

    d = tmp_path / "anat"
    d.mkdir()
    p = str(d / "a_recon.nii.gz")
    release = _stall_writer_pool()
    try:
        with nifti.deferred_flushes():
            nifti.write_async(p, _vol(5.0))
            assert glob.glob(str(d / "*.nii.gz")) == []   # the pool is stalled
            assert nifti.list_volumes(str(d)) == [p]
            assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == 5.0
            release.set()
            nifti.flush_writes(force=True)
    finally:
        release.set()
    assert os.path.exists(p)
    assert nifti.list_volumes(str(d)) == [p]
    assert nifti.list_volumes(str(d / "missing")) == []


def test_fake_synthseg_segments_queued_recons(tmp_path):
    from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner

    in_dir, out_dir = tmp_path / "recon", tmp_path / "labels"
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    vol = Volume(rng.uniform(0, 100, (8, 8, 8)).astype(np.float32), spacing=(1, 1, 1))
    release = _stall_writer_pool()
    try:
        with nifti.deferred_flushes():
            nifti.write_async(str(in_dir / "s1_recon.nii.gz"), vol)
            SynthSegRunner(mode="fake").run(str(in_dir), str(out_dir))
            release.set()
            nifti.flush_writes(force=True)
    finally:
        release.set()
    out = str(out_dir / "s1_recon_synthseg.nii.gz")
    assert os.path.exists(out)
    assert set(np.unique(np.asarray(nifti.read(out).data))) == {0, 2, 3}


def test_callable_synthseg_sees_flushed_files(tmp_path):
    """'callable' hands a directory to code with its own I/O: queued writes
    land first, even inside deferred_flushes."""
    from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner

    in_dir = tmp_path / "recon"
    in_dir.mkdir()
    seen = []
    release = _stall_writer_pool()
    try:
        with nifti.deferred_flushes():
            nifti.write_async(str(in_dir / "s1_recon.nii.gz"), _vol(2.0))
            release.set()
            SynthSegRunner(mode="callable", fn=lambda i, o: seen.extend(os.listdir(i))).run(
                str(in_dir), str(tmp_path / "labels"))
    finally:
        release.set()
    assert seen == ["s1_recon.nii.gz"]


def test_oversize_overwrite_drops_stale_small_entry(tmp_path, monkeypatch):
    p = str(tmp_path / "grow.nii.gz")
    nifti.write(p, _vol(1.0))                           # small: cached
    assert volcache.get(p) is not None
    monkeypatch.setattr(volcache, "_CACHE_MB", 0.001)   # 1 KB cap
    nifti.write(p, _vol(2.0, shape=(16, 16, 16)))       # over-cap rewrite
    nifti.flush_writes()
    assert volcache.get(p) is None                      # the stale entry is gone
    r = nifti.read(p)
    assert float(np.asarray(r.data).ravel()[0]) == 2.0 and r.shape == (16, 16, 16)


def test_mark_written_is_generation_scoped(tmp_path):
    p = str(tmp_path / "gen.nii.gz")
    gen1 = volcache.put(p, _vol(1.0))
    gen2 = volcache.put(p, _vol(2.0))
    assert gen2 > gen1
    open(p, "wb").write(b"x")                 # a file, so os.stat succeeds
    volcache.mark_written(p, gen1)            # the old write lands late
    with volcache._lock:
        assert volcache._entries[volcache._key(p)].pending is True
    volcache.mark_written(p, gen2)
    with volcache._lock:
        assert volcache._entries[volcache._key(p)].pending is False
    volcache.invalidate(p)


def test_concurrent_write_async_same_path_serializes(tmp_path):
    p = str(tmp_path / "race.nii.gz")
    vals = list(range(1, 9))
    threads = [threading.Thread(target=nifti.write_async, args=(p, _vol(float(v))))
               for v in vals]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    nifti.flush_writes()
    volcache.clear()
    assert float(np.asarray(nifti.read(p).data).ravel()[0]) in [float(v) for v in vals]


# ------------------------------------------------ the two fixes to the reference's writer
def _uncached_write_then_cached_put(mod, path):
    """An over-cap (uncached, gen None) write of ``path`` lands while a newer
    cached put of the same path waits for its own write: is the newer entry
    still pending afterwards?"""
    gate = threading.Event()

    def slow_write():
        gate.wait(timeout=30)
        with open(path, "wb") as f:
            f.write(b"first")

    fut = mod.submit_write(path, slow_write, None)
    gen2 = mod.put(path, _vol(2.0))
    gate.set()
    fut.result(timeout=30)
    time.sleep(0.05)
    with mod._lock:
        e = mod._entries[mod._key(path)]
        still_pending = e.pending and e.gen == gen2
    mod.invalidate(path)
    mod.flush()
    return still_pending


def test_uncached_write_does_not_stamp_a_newer_entry(tmp_path):
    """The reference's volcache.py:241: a write that cached nothing (gen None) must
    not stamp the entry a newer put made for the same path. The port's
    writer skips mark_written then; the reference's stamps the newer entry
    with the older file's stat and clears its pending flag."""
    assert _uncached_write_then_cached_put(volcache, str(tmp_path / "port.nii.gz"))
    assert not _uncached_write_then_cached_put(ref_volcache, str(tmp_path / "ref.nii.gz"))


class _SlowDeregisterLock:
    """A stand-in for the module lock that counts the main thread's
    acquisitions and delays every writer-pool thread's acquisition by 50
    ms, which widens the window between a write completing and its
    deregistration from ``_pending``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.main = 0

    def __enter__(self):
        name = threading.current_thread().name
        if name.startswith("ft2-volwrite") or name.startswith("ThreadPoolExecutor"):
            time.sleep(0.05)
        elif threading.current_thread() is threading.main_thread():
            self.main += 1
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def _claim_spins(mod, path, monkeypatch):
    """The main thread's lock acquisitions while a second write of ``path``
    waits for the first one's slot."""
    gate = threading.Event()
    mod._get_executor()                       # the pool exists before the swap
    lock = _SlowDeregisterLock()
    monkeypatch.setattr(mod, "_lock", lock)

    def first():
        gate.wait(timeout=30)

    mod.submit_write(path, first, None)
    lock.main = 0
    threading.Timer(0.05, gate.set).start()
    mod.submit_write(path, lambda: None, None)
    spins = lock.main
    mod.flush()
    return spins


def test_waiting_writer_does_not_spin(tmp_path, monkeypatch):
    """The reference's volcache.py:223, fixed: the worker deregisters from ``_pending``
    before it completes the future, so a writer waiting for the slot wakes
    once and claims it (two acquisitions). The reference's worker completes
    the future first, and the waiter spins on the finished future until
    the worker's finally-block runs."""
    assert _claim_spins(volcache, str(tmp_path / "port.nii.gz"), monkeypatch) <= 2
    assert _claim_spins(ref_volcache, str(tmp_path / "ref.nii.gz"), monkeypatch) > 10


# ------------------------------------------------ tensors: the in-place guard and the cast
def test_inplace_edit_of_a_cached_tensor_raises(tmp_path):
    """A torch tensor can change in place, a JAX array cannot: the cache
    records the tensor's version at put, and get() and the writer raise if
    it moved instead of serving or writing a checkpoint that changed."""
    p, q = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    t = torch.ones((4, 5, 6))
    nifti.write_async(p, Volume(t))
    nifti.flush_writes()
    t.add_(1.0)
    with pytest.raises(RuntimeError, match="modified in place"):
        nifti.read(p)
    volcache.clear()
    assert float(np.asarray(nifti.read(p).data)[0, 0, 0]) == 1.0   # the file as written
    release = _stall_writer_pool()
    try:
        u = torch.zeros((4, 5, 6))
        nifti.write_async(q, Volume(u))
        u[0, 0, 0] = 7.0                      # before the queued write copies it
        release.set()
        with pytest.raises(RuntimeError, match="modified in place"):
            nifti.flush_writes()
    finally:
        release.set()
    assert not nifti.exists(q)


def test_cache_served_tensor_is_the_written_cast(tmp_path):
    """A CPU tensor is served as a read-only numpy view of the cast tensor
    (what a disk read returns); the producer's later edits of its own
    tensor do not reach it when the cast made a copy."""
    p = str(tmp_path / "c.nii.gz")
    t = torch.full((3, 4, 5), 2.6)
    nifti.write_async(p, Volume(t), dtype=np.int16)
    t.fill_(9.0)                              # the int16 cast is another tensor
    r = nifti.read(p).data
    assert isinstance(r, np.ndarray) and r.dtype == np.int16 and not r.flags.writeable
    assert (r == 3).all()
    nifti.flush_writes()


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16, np.uint8])
def test_cache_hit_equals_disk_read(tmp_path, dtype):
    """read() from the cache and read() from disk after flush + clear give
    the same dtype, values and geometry, for float and integer storage of
    data with NaN and out-of-range values, from numpy and from a tensor.
    The geometry is a rotated one whose float64 values do not survive the
    header's float32 fields: the cache serves the header's."""
    rng = np.random.default_rng(3)
    data = rng.uniform(-70000, 70000, (6, 7, 8)).astype(np.float32)
    data[0, :3, :3] = [[np.nan, 0.5, 1.5], [2.5, -0.5, 65535.5], [-32768.5, 255.5, 32767.5]]
    c, s = np.cos(0.3), np.sin(0.3)
    geom = dict(spacing=(0.7, 1.1, 3.3), origin=(-12.345678, 4.1, 47.525329),
                direction=(c, -s, 0.0, s, c, 0.0, 0.0, 0.0, 1.0))
    for i, src in enumerate((data, torch.from_numpy(data.copy()))):
        p = str(tmp_path / f"v{i}.nii.gz")
        nifti.write_async(p, Volume(src, **geom), dtype=dtype)
        hit = nifti.read(p)
        nifti.flush_writes()
        volcache.clear()
        disk = nifti.read(p)
        assert np.asarray(hit.data).dtype == disk.data.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(np.asarray(hit.data), disk.data)
        assert (hit.spacing, hit.origin, hit.direction) == (
            disk.spacing, disk.origin, disk.direction)


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.uint8, np.float32])
def test_disk_cast_of_a_tensor_equals_numpy(dtype):
    """_cast_for_disk on a tensor (clamp, half-even round, NaN -> 0, .to)
    stores the integers numpy's clip/round/nan_to_num/astype stores."""
    rng = np.random.default_rng(4)
    data = rng.uniform(-80000, 80000, 4096).astype(np.float32)
    data[:8] = [np.nan, 0.5, 1.5, 2.5, -0.5, -1.5, np.inf, -np.inf]
    data[8:16] = np.arange(8) + 0.5
    got = nifti._cast_for_disk(torch.from_numpy(data.copy()), dtype)
    want = nifti._cast_for_disk(data, dtype)
    assert torch.is_tensor(got) and got.numpy().dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.numpy(), want)
