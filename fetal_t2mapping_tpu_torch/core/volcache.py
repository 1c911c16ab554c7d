"""In-process volume cache and asynchronous NIfTI write queue.

The counterpart of ``fetal_t2mapping_tpu.core.volcache``. The pipeline's
checkpoint design is filesystem-is-checkpoint (reference
utils/dcm_utils.py:277: every stage re-runs from the previous stage's
NIfTIs). Naively that makes every stage boundary a device -> host -> gzip
-> disk -> gunzip -> host -> device round trip: ``nifti.write`` blocks on
the download and the compression, and the next stage inflates the bytes
just written and uploads them again. This module keeps the contract and
removes the round trips:

- ``put``/``get``: an LRU byte-capped cache of the Volume handed to
  ``nifti.write``/``write_async``, cast to its on-disk dtype (a CUDA
  tensor when the pipeline computed it on the card). A later
  ``nifti.read``/``read_batch`` of the path returns it: the next stage
  chains on the device tensor. Entries validate against ``os.stat`` (size
  + mtime_ns recorded once the write lands), so an external change or
  deletion of the file invalidates the entry. Host data is served as a
  read-only numpy view, as a disk read returns it.
- ``submit_write``/``flush``: a small thread pool that does the download,
  the encode and the gzip off the main thread. Same-path writes are
  serialised (an overwrite waits for the prior write of that path).
  Worker errors re-raise at ``flush()``; an ``atexit`` flush is the
  backstop, so a process never exits with checkpoints still queued.

A torch tensor, unlike a JAX array, can change in place. A stage that
edits a cache-served tensor would corrupt the cached checkpoint and the
write still queued for it, so ``put`` records the tensor's ``_version``
and ``get`` (like the writer, ``nifti.write_async``) raises if it moved.

Knobs, the JAX package's own: ``FT2_VOLCACHE=0`` (no caching),
``FT2_VOLCACHE_MB`` (cap, default 1024), ``FT2_ASYNC_WRITES=0``
(``nifti.write_async`` writes synchronously), ``FT2_WRITE_THREADS``
(default 4).
"""

from __future__ import annotations

import atexit
import itertools
import logging
import os
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import torch

_gen_counter = itertools.count(1)   # write generations (see put/mark_written)

_CACHE_MB = float(os.environ.get("FT2_VOLCACHE_MB", "1024"))
_CACHE_ON = os.environ.get("FT2_VOLCACHE", "1") != "0"
_ASYNC_ON = os.environ.get("FT2_ASYNC_WRITES", "1") != "0"
_THREADS = int(os.environ.get("FT2_WRITE_THREADS", "4"))

_lock = threading.Lock()
_entries: "OrderedDict[str, _Entry]" = OrderedDict()
_bytes = 0
_pending: dict = {}          # path -> Future of the in-flight write
_errors: list = []           # exceptions raised by completed writes
_executor: Optional[ThreadPoolExecutor] = None
_executor_lock = threading.Lock()


class _Entry:
    __slots__ = ("vol", "nbytes", "stat", "pending", "gen", "version")

    def __init__(self, vol, nbytes):
        self.vol = vol
        self.nbytes = nbytes
        self.stat = None       # (st_size, st_mtime_ns) once the write landed
        # pending starts True: between put() and mark_written() the file is
        # absent or half-written, so the cached Volume must be served and
        # the entry must survive. Every caller (nifti.write/write_async)
        # pairs put() with mark_written() or fail_write().
        self.pending = True
        self.gen = 0           # write generation (set by put; see mark_written)
        self.version = version_of(vol.data)


def version_of(data) -> Optional[int]:
    """A tensor's in-place version counter (None for numpy data and for
    tensors made under ``torch.inference_mode``, which have none)."""
    if not torch.is_tensor(data) or data.is_inference():
        return None
    return data._version


def check_unchanged(path, data, version: Optional[int]) -> None:
    """Raise if ``data`` was modified in place since ``version`` was taken."""
    now = version_of(data)
    if version is not None and now != version:
        raise RuntimeError(
            f"{path}: the tensor written there was modified in place after the write "
            f"(version {version} -> {now}); copy it before editing a cache-served volume")


def _key(path) -> str:
    return os.path.abspath(str(path))


def caching_enabled() -> bool:
    return _CACHE_ON and _CACHE_MB > 0


def async_enabled() -> bool:
    return _ASYNC_ON


def _served(vol):
    """What a read returns for a cached Volume: a CUDA tensor as it is, host
    data as a read-only numpy view (a disk read's payload is read-only too)."""
    data = vol.data
    if torch.is_tensor(data):
        if data.device.type != "cpu":
            return vol
        data = data.numpy()
    view = data.view()
    view.flags.writeable = False
    return vol.with_data(view)


def put(path, vol) -> "int | None":
    """Remember ``vol`` as the content of ``path`` (call before/with write).

    Returns the entry's write generation (monotonic per put), or None when
    nothing was cached: :func:`mark_written` uses it to stamp only the
    entry whose write landed (an overwrite bumps the generation, so a
    completing older write cannot mark the newer entry clean)."""
    if not caching_enabled():
        return None
    global _bytes
    nbytes = int(vol.data.nbytes)
    if nbytes > _CACHE_MB * 1e6:
        # larger than the whole cap: not cached, and a prior smaller entry
        # for this path must go too, or get() would serve it forever
        invalidate(path)
        return None
    k = _key(path)
    with _lock:
        old = _entries.pop(k, None)
        if old is not None:
            _bytes -= old.nbytes
        e = _Entry(vol, nbytes)
        e.gen = next(_gen_counter)
        _entries[k] = e
        _bytes += nbytes
        # LRU eviction: never evict an entry whose write is still queued,
        # it is the only copy of that checkpoint until the worker lands it
        for kk in list(_entries):
            if _bytes <= _CACHE_MB * 1e6:
                break
            if kk == k or _entries[kk].pending:
                continue
            _bytes -= _entries.pop(kk).nbytes
        return e.gen


def mark_written(path, gen: int) -> None:
    """Record the on-disk stat of a completed write for later validation,
    on the entry of generation ``gen`` (from :func:`put`) only: when an
    overwrite has already replaced the entry, the older write's completion
    must neither stamp its stat on the newer entry nor clear its pending
    flag (the newer entry is the only copy of its checkpoint until its own
    write lands)."""
    if not caching_enabled():
        return
    k = _key(path)
    try:
        st = os.stat(k)
    except OSError:
        return
    with _lock:
        e = _entries.get(k)
        if e is not None and e.gen == gen:
            e.stat = (st.st_size, st.st_mtime_ns)
            e.pending = False


def get(path):
    """The cached Volume for ``path`` if it still matches the file, else None.

    Valid while the write is pending (the cached Volume is what will land
    on disk) or while ``os.stat`` matches what the completed write
    recorded; anything else (deleted, rewritten outside, never stamped)
    drops the entry. Raises RuntimeError if the cached tensor was modified
    in place since it was written."""
    if not caching_enabled():
        return None
    global _bytes
    k = _key(path)
    with _lock:
        e = _entries.get(k)
        if e is None:
            return None
        valid = e.pending
        if not valid and e.stat is not None:
            try:
                st = os.stat(k)
                valid = (st.st_size, st.st_mtime_ns) == e.stat
            except OSError:
                pass
        if not valid:
            _bytes -= _entries.pop(k).nbytes
            return None
        _entries.move_to_end(k)
    check_unchanged(k, e.vol.data, e.version)
    return _served(e.vol)


def invalidate(path) -> None:
    global _bytes
    with _lock:
        e = _entries.pop(_key(path), None)
        if e is not None:
            _bytes -= e.nbytes


def clear() -> None:
    """Drop every cache entry (pending writes keep running; flush() first
    if their content must be on disk)."""
    global _bytes
    with _lock:
        _entries.clear()
        _bytes = 0


def _get_executor() -> ThreadPoolExecutor:
    global _executor
    with _executor_lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(max_workers=_THREADS,
                                           thread_name_prefix="ft2-volwrite")
            atexit.register(_atexit_flush)
        return _executor


def fail_write(path) -> None:
    """Drop ``path``'s entry after its write failed: the cached Volume would
    otherwise be served forever for a checkpoint that never landed, and the
    pending entry could never be evicted."""
    invalidate(path)


def submit_write(path, fn: Callable[[], None], gen: "int | None" = None) -> Future:
    """Queue ``fn`` (download + encode + write of ``path``) on the writer
    pool. Serialised per path: an overwrite of a still-queued path waits
    for the prior write, so the order on disk matches the call order.
    ``gen`` (from :func:`put`) ties the completion stamp to the entry this
    write belongs to; a write that cached nothing (``gen`` None) stamps
    nothing."""
    k = _key(path)
    fut: Future = Future()
    # check-then-register is atomic, and the wait on the prior happens
    # outside the lock (its worker needs the lock to deregister): loop
    # until this future claims the slot
    while True:
        with _lock:
            prior = _pending.get(k)
            if prior is None:
                _pending[k] = fut        # registered before the worker can finish it
                break
        try:
            prior.result()
        except Exception:
            pass                         # already recorded in _errors

    def run():
        from ..utils.profiling import profiler

        try:
            with profiler.stage("io.write_worker"):
                fn()
            if gen is not None:
                mark_written(k, gen)
        except Exception as exc:         # surfaced at flush()
            fail_write(k)
            _errors.append(exc)
            _release(k, fut)
            fut.set_exception(exc)
        else:
            _release(k, fut)
            fut.set_result(None)

    _get_executor().submit(run)
    return fut


def _release(k: str, fut: Future) -> None:
    # deregister before the future completes: a waiter that wakes on it
    # then finds the slot free instead of spinning on a finished future
    with _lock:
        if _pending.get(k) is fut:
            del _pending[k]


def wait(path) -> None:
    """Block until ``path``'s in-flight write (if any) completes.

    Lets a filesystem read of a queued but uncached path (FT2_VOLCACHE=0,
    or a Volume over the cap) see the whole file instead of racing the
    writer: ``exists`` reports pending paths as present. Raises the
    write's error, if it failed."""
    fut = _pending.get(_key(path))
    if fut is not None:
        fut.result()


def pending(path) -> bool:
    return _key(path) in _pending


def pending_under(directory) -> list:
    """Queued-write paths directly inside ``directory`` (absolute paths):
    a directory listing cannot see them, ``nifti.list_volumes`` unions
    them with it."""
    prefix = os.path.abspath(str(directory))
    with _lock:
        keys = list(_pending)
    return [k for k in keys if os.path.dirname(k) == prefix]


def n_pending() -> int:
    """Writes queued or running now."""
    with _lock:
        return len(_pending)


def flush() -> None:
    """Wait for every queued write; re-raise the first worker error."""
    from ..utils.profiling import profiler

    with profiler.stage("io.flush_wait"):
        _flush_inner()
    if _errors:
        exc = _errors[0]
        _errors.clear()
        raise exc


def _flush_inner() -> None:
    while True:
        with _lock:
            items = list(_pending.items())
        if not items:
            break
        for k, fut in items:
            try:
                fut.result()
            except Exception:
                pass
            _release(k, fut)


def _atexit_flush() -> None:
    try:
        flush()
    except Exception as exc:                      # pragma: no cover
        logging.getLogger(__name__).error("async NIfTI write failed: %s", exc)
