"""nvcc build and ctypes binding of the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled for sm_90a into a shared library with a plain C
interface under ``_build/`` (gitignored) at first use — one nvcc per
source, all started together — and loaded with ctypes. A failed build
raises; nothing falls back to a plain version.

Flags differ per source. The fit kernels are built with ``-fmad=false``:
they round op by op like their plain versions and the reference, and with
FMA contraction they missed the parity bands against them. The S2D conv is
held to its plain version by a tolerance, not bitwise, and keeps nvcc's
default contraction.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import subprocess
from typing import Dict, Tuple

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
}
KERNEL_SOURCES = {name: os.path.join(CSRC, f"{name}.cu") for name in SOURCE_FLAGS}

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each library's C entries and their argument types (every entry returns int)
SIGNATURES = {
    "gauss_fit": {
        "ft2_gauss_fit": [_VP, _I64, _I32, _VP, _I32, _I32, _I32, _I32,
                          _VP, _VP, _VP, _VP, _VP, _VP],
        "ft2_gauss_params_floats": []},
    "gr_varpro_fit": {
        "ft2_gr_varpro_fit": [_VP, _I64, _I32, _VP, _I32, _I32, _I32, _VP, _VP, _VP, _VP, _VP],
        "ft2_gr_params_floats": [],
        "ft2_gr_slot_rows": [_I32],
        "ft2_gr_head_iters": [],
        "ft2_rsqrt_probe": [_VP, _I64, _VP, _VP, _VP]},
    "fit3": {
        "ft2_fit3_multistart": [_VP, _I64, _I32, _I32, _VP, _I32, _VP, _VP, _VP],
        "ft2_fit3_cont": [_VP, _I64, _I32, _I32, _VP, _I32, _VP, _VP, _VP, _VP, _VP, _VP,
                          _VP],
        "ft2_fit3_params_floats": [],
        "ft2_fit3_cont_slot_rows": []},
    "conv_s2d": {
        "ft2_conv_s2d_f32": [_VP] * 5 + [_I32] * 6 + [_VP],
        "ft2_conv_s2d_bf16": [_VP] * 5 + [_I32] * 9 + [_VP],
        "ft2_conv_s2d_geometry": [_VP]},
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
