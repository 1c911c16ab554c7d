"""Pure-Python NIfTI-1 reader/writer (.nii / .nii.gz) with the volume
cache and the asynchronous writer of :mod:`.volcache`.

The codec and I/O layer of ``fetal_t2mapping_tpu.core.nifti`` (same header
layout, dtype table, scl_slope/scl_inter handling and sform/qform geometry,
so files written by either package read back identically in the other):

- :func:`write_async` casts a volume to its on-disk dtype on the tensor's
  own device (so a CUDA volume's integer cast runs on the card and only the
  cast bytes cross PCIe) and queues the download, the encode and the gzip
  on the writer pool; :func:`write` does the same synchronously for host
  data. Both keep the written volume in the cache, so :func:`read` /
  :func:`read_batch` of the path serve it from memory (a CUDA tensor stays
  on the card), and :func:`exists` / :func:`list_volumes` see writes
  still queued. :func:`flush_writes` lands them; :func:`deferred_flushes`
  collapses the per-stage flushes of a composite pipeline into one.
- gzip goes through the native host library (``native``, zlib, released
  GIL, a thread pool for batches) unless ``FT2_DISABLE_NATIVE`` opts out,
  then through the stdlib ``gzip``/``zlib``. Written files are gzipped at
  level 4.

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
import torch

from . import volcache
from .volume import Volume, np_dtype

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

# gzip level for written volumes, on the native and the stdlib route: 4 is
# ~2x faster to compress than zlib's default 6 at a few-percent size cost.
# Override with FT2_GZIP_LEVEL (0-9), read at import as the JAX package does.
_GZIP_LEVEL = int(os.environ.get("FT2_GZIP_LEVEL", "4"))
_GZ_MAGIC = b"\x1f\x8b"

_NP_TO_TORCH = {np.dtype(n): getattr(torch, n) for n in (
    "uint8", "int8", "int16", "uint16", "int32", "uint32", "int64", "uint64",
    "float32", "float64")}


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

    A path this process wrote through :func:`write`/:func:`write_async`
    returns the cached Volume (a CUDA tensor if it was written from the
    card, else a read-only numpy array) without touching the filesystem.
    A missing file raises FileNotFoundError; a corrupt or truncated
    payload raises ValueError naming the file."""
    cached = volcache.get(path)
    if cached is not None:
        return cached
    # a queued write_async that the cache did not keep (FT2_VOLCACHE=0, or
    # over the cap): exists() already reports it, so let it land first
    volcache.wait(path)
    return parse(_load_raw(path), name=str(path))


def read_header(path: str) -> Volume:
    """Geometry-only read: decode the 348-byte header and return a Volume
    whose ``data`` is a zero broadcast view of the right shape and dtype
    (no voxel payload is read or allocated; of a .nii.gz only the first
    deflate blocks are inflated). For the prewarm, which needs an input's
    shape and affine without its megabytes. Errors as :func:`read`."""
    cached = volcache.get(path)
    if cached is not None:
        return cached
    if volcache.pending(path):
        return read(path)
    _check_file(path)
    try:
        with _open(path, "rb") as f:
            raw = f.read(_HDR_SIZE)
    except (OSError, EOFError, zlib.error) as exc:
        raise ValueError(f"{path}: unreadable NIfTI payload ({exc})") from exc
    return parse(raw, name=str(path), header_only=True)


def _check_file(path: str) -> None:
    """FileNotFoundError for a missing file; ValueError for a .gz path
    that is not gzip (zlib's gzread would pass its bytes through, the
    stdlib raises: one contract whatever the backend)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if str(path).endswith(".gz"):
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic != _GZ_MAGIC:
            raise ValueError(f"{path}: unreadable NIfTI payload (not a gzip file)")


def _load_raw(path: str) -> bytes:
    """gz-transparent byte load: FileNotFoundError for a missing file, and
    ValueError for a corrupt or truncated payload from the native library
    (its codes surface as OSError) and the stdlib alike."""
    from .. import native

    _check_file(path)
    try:
        if native.available():
            return native.read_file(path)
        with _open(path, "rb") as f:
            return f.read()
    except (OSError, EOFError, zlib.error) as exc:
        raise ValueError(f"{path}: unreadable NIfTI payload ({exc})") from exc


def read_batch(paths, n_threads: int = 8):
    """Read many NIfTI files in parallel: cache hits first, then the misses
    through the native thread pool (or stdlib threads: inflate releases the
    GIL). A failing file raises as :func:`read` does, attributed to it."""
    from .. import native

    paths = list(paths)
    out = [volcache.get(p) for p in paths]
    misses = [(i, p) for i, p in enumerate(paths) if out[i] is None]
    if not misses:
        return out
    for _, p in misses:
        volcache.wait(p)           # see read(): queued but uncached writes
    raws = None
    if native.available() and len(misses) > 1:
        try:
            for _, p in misses:
                _check_file(p)
            raws = native.read_batch([p for _, p in misses], n_threads)
        except (OSError, ValueError):
            pass                   # the per-path reads below raise, attributed
    if raws is not None:
        for (i, p), raw in zip(misses, raws):
            out[i] = parse(raw, name=str(p))
    elif len(misses) == 1:
        out[misses[0][0]] = read(misses[0][1])
    else:
        with ThreadPoolExecutor(max_workers=min(n_threads, len(misses))) as ex:
            for (i, _), vol in zip(misses, ex.map(read, [p for _, p in misses])):
                out[i] = vol
    return out


def exists(path) -> bool:
    """True if ``path`` is on disk or its write is still queued (the
    checkpoint test under asynchronous writes)."""
    return volcache.pending(path) or os.path.exists(path)


def list_volumes(directory, suffix: str = ".nii.gz") -> list:
    """Sorted absolute paths of the ``suffix`` files in ``directory``,
    queued writes included ([] for a missing directory).

    A plain listing races the writer pool: under :func:`deferred_flushes`
    a stage that lists a derivative directory while the producing stage's
    writes are in flight would see it empty. Queued paths read through
    :func:`read` (the cache), so the union is safe to consume at once."""
    directory = os.path.abspath(str(directory))
    try:
        on_disk = [os.path.join(directory, f) for f in os.listdir(directory)
                   if f.endswith(suffix)]
    except OSError:
        on_disk = []
    queued = [p for p in volcache.pending_under(directory) if p.endswith(suffix)]
    return sorted(set(on_disk) | set(queued))


_DEFER_DEPTH = 0


def flush_writes(force: bool = False) -> None:
    """Block until every queued :func:`write_async` has landed on disk;
    re-raise the first failed write.

    Inside :func:`deferred_flushes` this is a no-op unless ``force``:
    pass it before handing files to a consumer outside this process (a
    subprocess, a callback with its own I/O). In-process readers never
    need a flush: :func:`read`/:func:`exists` see queued writes."""
    if _DEFER_DEPTH and not force:
        return
    volcache.flush()


class deferred_flushes:
    """Context manager: make intermediate :func:`flush_writes` calls no-ops.

    The composite pipelines run their stages inside it, so the per-stage
    flush barriers (every public stage drains the queue on exit) collapse
    into one at the pipeline's boundary, and the writer pool's downloads
    and compressions overlap the next stages' compute. Re-entrant; the
    outermost exit flushes (so the contract holds at the boundary, on an
    error path too)."""

    def __enter__(self):
        global _DEFER_DEPTH
        _DEFER_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _DEFER_DEPTH
        _DEFER_DEPTH -= 1
        if _DEFER_DEPTH == 0:
            flush_writes()
        return False


def parse(raw: bytes, name: str = "<bytes>", header_only: bool = False) -> Volume:
    """Decode an in-memory NIfTI-1 byte string into a Volume.

    Any structural corruption raises ValueError naming the file (never
    struct.error or an unbounded allocation: np.frombuffer validates its
    count against the buffer before allocating). ``header_only`` skips the
    payload: ``data`` is a zero broadcast view of the declared shape and of
    the dtype a full read returns (see :func:`read_header`)."""
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
    # NIfTI-1: scl_slope == 0 means NO scaling at all (inter is ignored too)
    scaled = scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0)

    if any(d < 0 for d in shape_xyz):
        raise ValueError(f"{path}: negative dimension in header, dim={dim}")
    nvox = int(np.prod(shape_xyz))
    if not np.isfinite(vox_offset) or vox_offset < 0:
        raise ValueError(f"{path}: invalid vox_offset {vox_offset}")
    offset = int(vox_offset) if vox_offset else _HDR_SIZE + 4
    if header_only:
        # the dtype a full read returns: scaled headers read as float32
        eff = np.dtype(np.float32) if scaled else dtype.newbyteorder("=")
        data = np.broadcast_to(np.zeros((), eff), shape_xyz[::-1])
        return _finish_parse(raw, endian, path, data, pixdim)
    try:
        data = np.frombuffer(raw, dtype=dtype, count=nvox, offset=offset)
    except ValueError as exc:
        raise ValueError(
            f"{path}: payload smaller than header dims "
            f"{shape_xyz} @ offset {offset} ({exc})") from exc
    # NIfTI voxels are Fortran-ordered in (x,y,z) == C-ordered in (z,y,x)
    data = data.reshape(shape_xyz[::-1])
    if scaled:
        data = data.astype(np.float32) * np.float32(scl_slope) + np.float32(scl_inter)
    elif data.dtype.byteorder not in ("=", "|", "<"):
        data = data.astype(data.dtype.newbyteorder("="))
    return _finish_parse(raw, endian, path, data, pixdim)


def _finish_parse(raw, endian, path, data, pixdim) -> Volume:
    """Geometry decode shared by the full and header-only parses."""
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


def _cast_for_disk(data, dtype):
    """Cast ``data`` (numpy, or a tensor on its own device) to the on-disk
    dtype ``dtype`` (default: its own, float32 where NIfTI has no code).
    float -> integer storage rounds half-even and clamps to the target
    range, NaN storing as 0 (fusion's out-of-FOV marker), instead of C-cast
    truncation and wraparound, as the JAX package does; torch's round is
    half-even like numpy's, so both paths store the same integers."""
    src = np_dtype(data)
    target = np.dtype(dtype) if dtype is not None else src
    if target not in _NP_TO_DT:
        target = np.dtype(np.float32)
    if src == target:
        return data
    if src.kind == "f" and target.kind in "iu":
        info = np.iinfo(target)
        if torch.is_tensor(data):
            data = torch.nan_to_num(data.clamp(info.min, info.max).round(), nan=0.0)
        else:
            data = np.nan_to_num(data.clip(info.min, info.max).round(), nan=0.0)
    if torch.is_tensor(data):
        return data.to(_NP_TO_TORCH[target])
    return data.astype(target)


def write(path: str, vol: Volume, dtype: Optional[np.dtype] = None) -> None:
    """Write a Volume as NIfTI-1 (.nii or .nii.gz), sform+qform set, and
    keep it in the volume cache, so a later :func:`read` of the path is
    free.

    ``vol.data`` must be a numpy array: a synchronous write never hides a
    device->host copy (:func:`write_async` takes tensors). Anything else
    raises TypeError."""
    if not isinstance(vol.data, np.ndarray):
        raise TypeError(
            f"nifti.write takes numpy data, got {type(vol.data).__name__}; "
            "queue device tensors with nifti.write_async")
    hdr, cached = _for_disk(vol, dtype)
    gen = volcache.put(path, cached)
    try:
        _write_payload(path, hdr, cached.data)
    except BaseException:
        volcache.fail_write(path)     # never serve a checkpoint that failed
        raise
    volcache.mark_written(path, gen)


def write_async(path: str, vol: Volume, dtype: Optional[np.dtype] = None) -> None:
    """Queue a NIfTI write of ``vol`` (numpy or a tensor on any device);
    returns once the cast to the on-disk dtype is issued on the data's own
    device.

    The download, the encode and the gzip run on the writer pool
    (:mod:`.volcache`), overlapping whatever the caller computes next. The
    Volume is visible at once to :func:`read`/:func:`read_batch` (the
    cache) and :func:`exists`; :func:`flush_writes` (pipelines call it, and
    an atexit flush is the backstop) lands it before the file goes to a
    consumer outside this process. A CUDA tensor is copied after an event
    recorded on the caller's current stream; a tensor modified in place
    before its copy fails the write (raised at the flush).
    ``FT2_ASYNC_WRITES=0`` writes synchronously."""
    hdr, cached = _for_disk(vol, dtype)
    data = cached.data
    gen = volcache.put(path, cached)
    version = volcache.version_of(data)
    event = None
    if torch.is_tensor(data) and data.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(data.device))

    def payload():
        from ..utils.profiling import profiler

        with profiler.stage("io.download"):
            arr = _to_host(path, data, event, version)
        with profiler.stage("io.encode"):
            _write_payload(path, hdr, arr)

    if not volcache.async_enabled():
        try:
            payload()
        except BaseException:
            volcache.fail_write(path)
            raise
        volcache.mark_written(path, gen)
        return
    volcache.submit_write(path, payload, gen)


def _for_disk(vol: Volume, dtype):
    """(the file's header, the Volume a read of the file returns): the data
    cast to its on-disk dtype, on its own device, with the geometry decoded
    back from the header (its float32 fields), so a cache hit is what a
    disk read would give."""
    data = _cast_for_disk(vol.data, dtype)
    hdr = _header(vol, np_dtype(data), tuple(data.shape))
    geom = parse(hdr, header_only=True)
    return hdr, Volume(data, spacing=geom.spacing, origin=geom.origin, direction=geom.direction)


def _to_host(path: str, data, event, version) -> np.ndarray:
    """A host snapshot of the data to write. A CUDA tensor is copied once
    its producer's stream has reached ``event``; a CPU tensor is copied
    with numpy (its owner may go on editing it; a torch copy would run
    intra-op threads beside the caller's, which can change how a CPU
    reduction there is split, and so its rounding). The version check
    after the copy fails the write if the tensor changed in place before
    the copy completed."""
    if not torch.is_tensor(data):
        return np.asarray(data)
    if event is not None:
        with torch.cuda.device(data.device):
            torch.cuda.current_stream().wait_event(event)
            snap = data.cpu().numpy()
    else:
        snap = data.numpy().copy()
    volcache.check_unchanged(path, data, version)
    return snap


def _header(vol: Volume, dtype: np.dtype, shape) -> bytes:
    """The 348-byte NIfTI-1 header of ``vol``'s geometry for data of
    ``dtype`` and (z, y, x) ``shape``, and the 4-byte empty extension."""
    nz, ny, nx = shape
    aff = _itk_to_affine_ras(vol)
    spacing = np.asarray(vol.spacing, dtype=np.float64)
    # qform rotation must be expressed in RAS
    R_ras = _FLIP_LPS @ vol.direction_matrix
    qb, qc, qd, qfac = _matrix_to_quat(R_ras)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _NP_TO_DT[dtype])
    struct.pack_into("<h", hdr, 72, dtype.itemsize * 8)
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
    return bytes(hdr) + b"\x00" * 4


def _write_payload(path: str, hdr: bytes, data: np.ndarray) -> None:
    from .. import native

    payload = hdr + np.ascontiguousarray(data).tobytes()
    if native.available():
        native.write_file(path, payload,
                          gzip_level=_GZIP_LEVEL if str(path).endswith(".gz") else None)
        return
    with _open(path, "wb") as f:
        f.write(payload)
