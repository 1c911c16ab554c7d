"""Native gzip file I/O for ``core.nifti``: ctypes bindings of
``csrc/gzio_host.cpp`` (zlib ``gzread``/``gzwrite``, a ``std::thread``
batch reader), with the names and contracts of the JAX package's
``native`` module (``read_file``, ``read_batch``, ``write_file``), and
that module's two DICOM entries, ``jpegll_decode`` and ``dicom_probe``,
re-exported from ``build`` (bindings of ``csrc/dicom_host.cpp``).

The library is built by ``build.build_gzio_lib`` at first use; a failed
build raises, it does not fall back to the stdlib. ``FT2_DISABLE_NATIVE``
set to anything but the empty string is the explicit opt-out: then
:func:`available` is False and ``core.nifti`` uses ``gzip``/``zlib``.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

from . import build
from .build import dicom_probe, jpegll_decode  # noqa: F401  (the JAX package's names)


def available() -> bool:
    """False when ``FT2_DISABLE_NATIVE`` opts out; otherwise True once the
    library is built and loaded (a failed build raises)."""
    if os.environ.get("FT2_DISABLE_NATIVE"):
        return False
    build.load_gzio_lib()
    return True


def version() -> str:
    return build.load_gzio_lib().ft2_gz_version().decode()


def read_file(path: str) -> bytes:
    """gz-transparent read of one file. A missing, unreadable or truncated
    file raises OSError with the library's code."""
    lib = build.load_gzio_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = lib.ft2_read_file(os.fsencode(path), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise OSError(f"ft2_read_file({path!r}) failed with code {rc}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.ft2_gz_free(out)


def read_batch(paths: Sequence[str], n_threads: int = 8) -> List[bytes]:
    """Parallel gz-transparent reads; raises OSError naming the first path
    that failed (every buffer is freed either way)."""
    lib = build.load_gzio_lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    lens = (ctypes.c_uint64 * n)()
    errs = (ctypes.c_int32 * n)()
    lib.ft2_read_batch(c_paths, n, outs, lens, errs, n_threads)
    result: List[bytes] = []
    failed = None
    for i in range(n):
        if errs[i] != 0:
            failed = failed or (paths[i], errs[i])
            continue
        result.append(ctypes.string_at(outs[i], lens[i]))
        lib.ft2_gz_free(outs[i])
    if failed:
        raise OSError(f"ft2_read_batch: {failed[0]!r} failed with code {failed[1]}")
    return result


def write_file(path: str, data: bytes, *, gzip_level=None) -> bool:
    """Write ``data`` to ``path``, gzip-compressed at ``gzip_level`` (0-9)
    or raw when it is None; raises OSError on failure, returns True."""
    lib = build.load_gzio_lib()
    level = -1 if gzip_level is None else int(gzip_level)
    # no copy: bytes are immutable and stay referenced for the call
    buf = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    rc = lib.ft2_write_file(os.fsencode(path), buf, len(data), level)
    if rc != 0:
        raise OSError(f"ft2_write_file({path!r}) failed with code {rc}")
    return True
