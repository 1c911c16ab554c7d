"""nvcc build and ctypes binding of the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled for sm_90a into a shared library with a plain C
interface under ``_build/`` (gitignored) at first use — one nvcc per
source, all started together — and loaded with ctypes. A failed build
raises; nothing falls back to a plain version.

Flags differ per source. The fit kernels are built with ``-fmad=false``:
they round op by op like their plain versions and the reference, and with
FMA contraction they missed the parity bands against them. The S2D conv is
held to its plain version by a tolerance, not bitwise, and keeps nvcc's
default contraction; so does the volume layout, which only copies.

Two host libraries are built here too, with g++, into the same
directory: the DICOM ingest's (``csrc/dicom_host.cpp``: the Part-10 probe
and the JPEG-lossless decoder), bound by :func:`dicom_probe` and
:func:`jpegll_decode`, and the NIfTI I/O's (``csrc/gzio_host.cpp``: zlib
file reads and writes, linked with ``-lz``), bound by ``native.py``. Their
builds raise on failure as well.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NO_FMA = ("-fmad=false",)
#: kernel library -> the flags its source adds to COMMON_FLAGS
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "gauss_fit": _NO_FMA,
    "gr_varpro_fit": _NO_FMA,
    "fit3": _NO_FMA,
    "conv_s2d": (),
    "volume_layout": (),
}
KERNEL_SOURCES = {name: os.path.join(CSRC, f"{name}.cu") for name in SOURCE_FLAGS}

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each library's C entries and their argument types (every entry returns int)
SIGNATURES = {
    "gauss_fit": {
        "ft2_gauss_fit": [_VP, _I64, _I32, _VP, _I32, _I32, _I32, _I32,
                          _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _VP],
        "ft2_gauss_params_floats": [],
        "ft2_gauss_slot_rows": [_I32],
        "ft2_gauss_head_iters": []},
    "gr_varpro_fit": {
        "ft2_gr_varpro_fit": [_VP, _I64, _I32, _VP, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP,
                              _I32, _VP],
        "ft2_gr_params_floats": [],
        "ft2_gr_slot_rows": [_I32],
        "ft2_gr_head_iters": [],
        "ft2_rsqrt_probe": [_VP, _I64, _VP, _VP, _VP]},
    "fit3": {
        "ft2_fit3_multistart": [_VP, _I64, _I32, _I32, _VP, _I32] + [_VP] * 5,
        "ft2_fit3_cont": [_VP, _I64, _I32, _I32, _VP, _I32] + [_VP] * 9,
        "ft2_fit3_params_floats": [],
        "ft2_fit3_cont_slot_rows": []},
    "conv_s2d": {
        "ft2_conv_s2d_f32": [_VP] * 5 + [_I32] * 6 + [_VP],
        "ft2_conv_s2d_bf16": [_VP] * 5 + [_I32] * 9 + [_VP],
        "ft2_conv_s2d_geometry": [_VP]},
    "volume_layout": {
        "ft2_layout_work_ints": [_I64, _I32, _I32],
        "ft2_layout_compact": [_VP, _VP, _I64, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _I64, _VP,
                               _VP],
        "ft2_layout_scatter": [_VP, _I64, _I32, _VP, _VP, _I64, _I64, _I32, _VP, _I64, _VP,
                               _I64, _VP, _I64, _VP, _I32] + [_VP] * 8},
}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return COMMON_FLAGS + SOURCE_FLAGS[name]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    last build of kernel ``name``."""
    with open(os.path.join(BUILD_DIR, f"{name}.log")) as f:
        return f.read()


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [KERNEL_SOURCES[name]] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(d) > os.path.getmtime(lib) for d in deps)


def build_kernels() -> Dict[str, str]:
    """Compile every stale ``csrc/*.cu`` with nvcc for sm_90a into
    ``_build/`` — one nvcc per source, all started together — and return
    {kernel name: library path}. A source is stale when its library is
    missing or older than it or any ``csrc/*.cuh``. A failed build raises."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in KERNEL_SOURCES:
        if _stale(name):
            # build under a private name and rename: concurrent builders
            # never load a half-written library
            tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
            cmd = [nvcc(), *nvcc_flags(name), "-o", tmp, KERNEL_SOURCES[name]]
            procs[name] = (tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, cmd, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(out)
        os.replace(f"{tmp}.log", os.path.join(BUILD_DIR, f"{name}.log"))
        os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: lib_path(name) for name in KERNEL_SOURCES}


@functools.lru_cache(maxsize=None)
def load_lib(name: str):
    """The ctypes handle of kernel library ``name`` (built first if stale),
    with every C entry's argument types declared."""
    lib = ctypes.CDLL(build_kernels()[name])
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I32
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise unless a C entry reported cudaSuccess for its launch."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream(dev) -> int:
    """The current CUDA stream of ``dev`` as an int for a C entry."""
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------- the ingest's host library (g++)
HOST_SOURCE = os.path.join(CSRC, "dicom_host.cpp")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
GZIO_SOURCE = os.path.join(CSRC, "gzio_host.cpp")
GZIO_LIBS = ("-lz",)
#: the most pixels an untrusted JPEG-lossless frame header may ask for: 2^26
#: (128 MiB of uint16) dwarfs any real DICOM frame, and a crafted 65535 x
#: 65535 x 4 header would otherwise allocate ~34 GB before decoding a pixel
MAX_JPEG_PIXELS = 1 << 26
_U8P, _U16P, _I32P = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
                      ctypes.POINTER(ctypes.c_int32))
HOST_SIGNATURES = {
    "ft2_dicom_probe_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, _I32P,
                               ctypes.c_int32], ctypes.c_int),
    "ft2_jpegll_info": ([_U8P, ctypes.c_uint64, _I32P, _I32P, _I32P, _I32P], ctypes.c_int),
    "ft2_jpegll_decode": ([_U8P, ctypes.c_uint64, _U16P, ctypes.c_uint64], ctypes.c_int),
    "ft2_free": ([_U8P], None),
    "ft2_version": ([], ctypes.c_char_p),
}


def gxx() -> str:
    return os.environ.get("CXX") or "g++"


def host_lib_path() -> str:
    return os.path.join(BUILD_DIR, "libdicom_host.so")


def build_host_lib() -> str:
    """Compile ``csrc/dicom_host.cpp`` with g++ into ``_build/`` when the
    library is missing or older than its source, under a private name and
    renamed into place; return its path. A failed build raises with the
    compiler's output."""
    return _build_host(HOST_SOURCE, host_lib_path())


def gzio_lib_path() -> str:
    return os.path.join(BUILD_DIR, "libgzio_host.so")


def build_gzio_lib() -> str:
    """:func:`build_host_lib` for ``csrc/gzio_host.cpp``, linked with zlib."""
    return _build_host(GZIO_SOURCE, gzio_lib_path(), GZIO_LIBS)


def _build_host(source: str, lib: str, libs: Sequence[str] = ()) -> str:
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(source):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx(), *HOST_FLAGS, "-o", tmp, source, *libs]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_host_lib():
    """The ctypes handle of the ingest's host library (built first if
    stale), with every C entry's types declared."""
    lib = ctypes.CDLL(build_host_lib())
    for fn, (argtypes, restype) in HOST_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


_SIZEP = ctypes.POINTER(ctypes.c_uint64)
GZIO_SIGNATURES = {
    "ft2_read_file": ([ctypes.c_char_p, ctypes.POINTER(_U8P), _SIZEP], ctypes.c_int),
    "ft2_read_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.POINTER(_U8P),
                        _SIZEP, _I32P, ctypes.c_int32], ctypes.c_int),
    "ft2_write_file": ([ctypes.c_char_p, _U8P, ctypes.c_uint64, ctypes.c_int32], ctypes.c_int),
    "ft2_gz_free": ([_U8P], None),
    "ft2_gz_version": ([], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def load_gzio_lib():
    """The ctypes handle of the NIfTI I/O's host library (built first if
    stale), with every C entry's types declared."""
    lib = ctypes.CDLL(build_gzio_lib())
    for fn, (argtypes, restype) in GZIO_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def jpegll_decode(data: bytes):
    """Decode a T.81 lossless JPEG stream with the host library -> uint16
    (uint8 at precision <= 8) array, (rows, cols) or (rows, cols, comps).

    Returns None for a stream that parses but lies outside the library's
    lossless scope (code -11), so that ``utils.jpegll.decode`` names the
    feature; raises ValueError on a malformed stream or an implausible
    frame header."""
    lib = load_host_lib()
    buf = ctypes.cast(ctypes.c_char_p(data), _U8P)
    rows, cols, comps, prec = (ctypes.c_int32() for _ in range(4))
    rc = lib.ft2_jpegll_info(buf, len(data), ctypes.byref(rows), ctypes.byref(cols),
                             ctypes.byref(comps), ctypes.byref(prec))
    if rc == -11:
        return None
    if rc != 0:
        raise ValueError(f"jpegll: malformed stream (native code {rc})")
    n = rows.value * cols.value * comps.value
    if n <= 0 or n > MAX_JPEG_PIXELS:
        raise ValueError(f"jpegll: implausible frame header "
                         f"{rows.value}x{cols.value}x{comps.value}")
    out = np.empty(n, np.uint16)
    rc = lib.ft2_jpegll_decode(buf, len(data), out.ctypes.data_as(_U16P), n)
    if rc != 0:
        raise ValueError(f"jpegll: decode failed (native code {rc})")
    arr = out.reshape(rows.value, cols.value, comps.value)
    arr = arr[:, :, 0] if comps.value == 1 else arr
    if prec.value <= 8:
        arr = arr.astype(np.uint8)
    return np.ascontiguousarray(arr)


def dicom_probe(paths: Sequence[str], n_threads: int = 8) -> List[int]:
    """Part-10 magic probe per path with the host library's thread pool:
    1 DICOM, 0 not, -1 unreadable."""
    lib = load_host_lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    flags = (ctypes.c_int32 * n)()
    lib.ft2_dicom_probe_batch(c_paths, n, flags, n_threads)
    return list(flags)
