"""Pure-Python NIfTI-1 reader/writer (.nii / .nii.gz), synchronous.

The codec of ``fetal_t2mapping_tpu.core.nifti`` (same header layout, dtype
table, scl_slope/scl_inter handling and sform/qform geometry, so files
written by either package read back identically in the other), without
the JAX package's volume cache, async writer pool and native loader.
Decompression and compression go through the stdlib ``gzip``/``zlib``,
which release the GIL, so callers parallelise with threads.

Geometry: NIfTI affines are RAS; :class:`~.volume.Volume` carries ITK
LPS spacing/origin/direction. Conversion is ``LPS = diag(-1,-1,1) @ RAS``.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .volume import Volume

_HDR_SIZE = 348
_MAGIC_N1 = b"n+1\x00"

# NIfTI datatype codes
_DT_TO_NP = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
    1280: np.dtype(np.uint64),
}
_NP_TO_DT = {v: k for k, v in _DT_TO_NP.items()}

_FLIP_LPS = np.diag([-1.0, -1.0, 1.0])  # RAS <-> LPS

# gzip level for written volumes: ~2x faster to compress than zlib's
# default 6 at a few-percent size cost (the JAX package's default too).
_GZIP_LEVEL = 4


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        if "w" in mode:
            return gzip.open(path, mode, compresslevel=_GZIP_LEVEL)
        return gzip.open(path, mode)
    return open(path, mode)


# --------------------------------------------------------------------------
# quaternion helpers (qform fallback)
def _quat_to_matrix(b: float, c: float, d: float, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )
    R[:, 2] *= 1.0 if qfac >= 0 else -1.0
    return R


def _matrix_to_quat(R: np.ndarray):
    """Inverse of _quat_to_matrix; returns (b, c, d, qfac)."""
    R = R.copy()
    qfac = 1.0
    if np.linalg.det(R) < 0:
        qfac = -1.0
        R[:, 2] *= -1.0
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        a = 0.25 * s
        b = (R[2, 1] - R[1, 2]) / s
        c = (R[0, 2] - R[2, 0]) / s
        d = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            a = (R[2, 1] - R[1, 2]) / s
            b = 0.25 * s
            c = (R[0, 1] + R[1, 0]) / s
            d = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            a = (R[0, 2] - R[2, 0]) / s
            b = (R[0, 1] + R[1, 0]) / s
            c = 0.25 * s
            d = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            a = (R[1, 0] - R[0, 1]) / s
            b = (R[0, 2] + R[2, 0]) / s
            c = (R[1, 2] + R[2, 1]) / s
            d = 0.25 * s
    if a < 0:
        b, c, d = -b, -c, -d
    return float(b), float(c), float(d), qfac


# --------------------------------------------------------------------------
def _affine_ras_to_itk(aff: np.ndarray):
    """RAS 4x4 -> (spacing xyz, origin LPS xyz, direction row-major 3x3 LPS)."""
    A = _FLIP_LPS @ aff[:3, :3]  # now LPS
    spacing = np.linalg.norm(A, axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    direction = A / spacing[None, :]
    origin = _FLIP_LPS @ aff[:3, 3]
    return tuple(spacing), tuple(origin), tuple(direction.reshape(-1))


def _itk_to_affine_ras(vol: Volume) -> np.ndarray:
    aff = np.eye(4)
    aff[:3, :3] = _FLIP_LPS @ vol.direction_matrix @ np.diag(vol.spacing)
    aff[:3, 3] = _FLIP_LPS @ np.asarray(vol.origin)
    return aff


# --------------------------------------------------------------------------
def read(path: str) -> Volume:
    """Read a .nii or .nii.gz file into a Volume (data indexed (z,y,x)).

    A missing file raises FileNotFoundError; a corrupt or truncated
    payload raises ValueError naming the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with _open(path, "rb") as f:
            raw = f.read()
    except (OSError, EOFError, zlib.error) as exc:
        raise ValueError(f"{path}: unreadable NIfTI payload ({exc})") from exc
    return parse(raw, name=str(path))


def read_batch(paths, n_threads: int = 8):
    """Read many NIfTI files concurrently (gzip inflate releases the GIL)."""
    paths = list(paths)
    if len(paths) <= 1:
        return [read(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(n_threads, len(paths))) as ex:
        return list(ex.map(read, paths))


def exists(path) -> bool:
    """True if ``path`` is on disk (writes are synchronous in this package)."""
    return os.path.exists(path)


def list_volumes(directory, suffix: str = ".nii.gz") -> list:
    """Sorted absolute paths of the ``suffix`` files in ``directory`` ([]
    for a missing directory). Writes are synchronous in this package, so
    there are no queued writes to merge as the JAX package does."""
    directory = os.path.abspath(str(directory))
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(os.path.join(directory, f) for f in names if f.endswith(suffix))


def parse(raw: bytes, name: str = "<bytes>") -> Volume:
    """Decode an in-memory NIfTI-1 byte string into a Volume.

    Any structural corruption raises ValueError naming the file (never
    struct.error or an unbounded allocation: np.frombuffer validates its
    count against the buffer before allocating)."""
    path = name
    if len(raw) < _HDR_SIZE:
        raise ValueError(
            f"{path}: truncated NIfTI header ({len(raw)} < {_HDR_SIZE} bytes)")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = dim[0]
    if ndim < 3:
        shape_xyz = tuple(list(dim[1 : 1 + ndim]) + [1] * (3 - ndim))
    else:
        shape_xyz = tuple(dim[1:4])
        extra = [d for d in dim[4 : 1 + ndim] if d > 1]
        if extra:
            raise ValueError(f"{path}: only scalar 3-D volumes supported, dim={dim}")

    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    if datatype not in _DT_TO_NP:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = _DT_TO_NP[datatype].newbyteorder(endian)

    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset = struct.unpack_from(endian + "f", raw, 108)[0]
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]

    if any(d < 0 for d in shape_xyz):
        raise ValueError(f"{path}: negative dimension in header, dim={dim}")
    nvox = int(np.prod(shape_xyz))
    if not np.isfinite(vox_offset) or vox_offset < 0:
        raise ValueError(f"{path}: invalid vox_offset {vox_offset}")
    offset = int(vox_offset) if vox_offset else _HDR_SIZE + 4
    try:
        data = np.frombuffer(raw, dtype=dtype, count=nvox, offset=offset)
    except ValueError as exc:
        raise ValueError(
            f"{path}: payload smaller than header dims "
            f"{shape_xyz} @ offset {offset} ({exc})") from exc
    # NIfTI voxels are Fortran-ordered in (x,y,z) == C-ordered in (z,y,x)
    data = data.reshape(shape_xyz[::-1])

    # NIfTI-1: scl_slope == 0 means NO scaling at all (inter is ignored too)
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        data = data.astype(np.float32) * np.float32(scl_slope) + np.float32(scl_inter)
    else:
        data = np.asarray(data)
        if data.dtype.byteorder not in ("=", "|", "<"):
            data = data.astype(data.dtype.newbyteorder("="))

    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    if sform_code > 0:
        srow = np.array(struct.unpack_from(endian + "12f", raw, 280), dtype=np.float64)
        aff = np.eye(4)
        aff[:3, :4] = srow.reshape(3, 4)
    elif qform_code > 0:
        qb, qc, qd = struct.unpack_from(endian + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
        qfac = pixdim[0] if pixdim[0] != 0 else 1.0
        R = _quat_to_matrix(qb, qc, qd, qfac)
        aff = np.eye(4)
        aff[:3, :3] = R @ np.diag(pixdim[1:4])
        aff[:3, 3] = (qx, qy, qz)
    else:
        aff = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    if not np.all(np.isfinite(aff)):
        raise ValueError(f"{path}: non-finite geometry in header affine")
    spacing, origin, direction = _affine_ras_to_itk(aff)
    return Volume(data=data, spacing=spacing, origin=origin, direction=direction)


def _cast_for_disk(data: np.ndarray, dtype) -> np.ndarray:
    """Cast to the on-disk dtype. float -> integer storage rounds half-even
    and clamps to the target range (NaN stores as 0) instead of C-cast
    truncation/wraparound, as the JAX package does."""
    target = np.dtype(dtype) if dtype is not None else np.dtype(data.dtype)
    if target not in _NP_TO_DT:
        target = np.dtype(np.float32)
    if data.dtype != target:
        if data.dtype.kind == "f" and target.kind in "iu":
            info = np.iinfo(target)
            data = np.nan_to_num(data.clip(info.min, info.max).round(), nan=0.0)
        data = data.astype(target)
    return data


def write(path: str, vol: Volume, dtype: Optional[np.dtype] = None) -> None:
    """Write a Volume as NIfTI-1 (.nii or .nii.gz), sform+qform set.

    ``vol.data`` must be a numpy array: device tensors are downloaded by
    the caller (``tensor.cpu().numpy()``), so a write never hides a
    device->host copy. Anything else raises TypeError."""
    if not isinstance(vol.data, np.ndarray):
        raise TypeError(
            f"nifti.write takes numpy data, got {type(vol.data).__name__}; "
            "download device tensors with .cpu().numpy() first")
    data = _cast_for_disk(vol.data, dtype)
    datatype = _NP_TO_DT[data.dtype]
    bitpix = data.dtype.itemsize * 8

    nz, ny, nx = data.shape
    aff = _itk_to_affine_ras(vol)
    spacing = np.asarray(vol.spacing, dtype=np.float64)
    # qform rotation must be expressed in RAS
    R_ras = _FLIP_LPS @ vol.direction_matrix
    qb, qc, qd, qfac = _matrix_to_quat(R_ras)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, qfac, *spacing, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    struct.pack_into("<h", hdr, 252, 1)  # qform_code = SCANNER_ANAT
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = SCANNER_ANAT
    struct.pack_into("<3f", hdr, 256, qb, qc, qd)
    struct.pack_into("<3f", hdr, 268, *aff[:3, 3])
    struct.pack_into("<12f", hdr, 280, *aff[:3, :4].reshape(-1))
    hdr[344:348] = _MAGIC_N1

    with _open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(memoryview(np.ascontiguousarray(data)).cast("B"))
