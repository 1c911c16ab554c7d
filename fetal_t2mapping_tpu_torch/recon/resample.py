"""Physical-space volume resampling on the device.

The counterpart of ``fetal_t2mapping_tpu.recon.resample``, replacing the
reference's ``sitk.Resample`` calls: iso-resampling to 1 mm^3 (reference
utils/qmri_utils.py:35-80), label/mask resampling to a reference grid
(:468-589) and transform application. One trilinear (or nearest) gather
over the target grid's voxels, direction-aware.

``Volume.data`` may be a numpy array or a torch tensor. With
``on_device=True`` the result's data is a tensor on ``device`` (callers
that keep computing there, as the fusion does); otherwise it is
downloaded to numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.volume import Volume, np_dtype
from ..device import resolve_device
from ..ops.interp import _nearest, _trilinear, sample_nearest, sample_trilinear

# torch has no arithmetic on these unsigned types: they are sampled widened
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}
_WIDEN_T = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def _world_to_index_matrix(vol: Volume):
    """(3x3 matrix, origin) mapping world(LPS) -> continuous (x,y,z) index."""
    M = vol.direction_matrix @ np.diag(vol.spacing)
    return np.linalg.inv(M), np.asarray(vol.origin)


def to_tensor(data, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``data`` (numpy or tensor) as a tensor on ``device``; float64 and the
    unsigned types torch cannot compute with are narrowed/widened first."""
    if not torch.is_tensor(data):
        arr = np.asarray(data)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype in _WIDEN:
            arr = arr.astype(_WIDEN[arr.dtype])
        elif not arr.flags.writeable:      # a NIfTI payload read from bytes
            arr = arr.copy()
        data = torch.from_numpy(np.ascontiguousarray(arr))
    elif dtype is None and data.dtype in _WIDEN_T:   # a cache-served volume
        dtype = _WIDEN_T[data.dtype]
    return data.to(device=device, dtype=dtype)


def sample_volume_at_world(vol: Volume, world_pts, *, method: str = "linear",
                           cval: float = 0.0, device="cuda") -> torch.Tensor:
    """Sample ``vol`` at (N, 3) world (x,y,z) points; returns (N,) values."""
    dev = resolve_device(device)
    inv, origin = _world_to_index_matrix(vol)
    pts = to_tensor(np.asarray(world_pts, np.float32), dev)
    idx_xyz = ((pts - torch.as_tensor(origin, dtype=torch.float32, device=dev))
               @ torch.as_tensor(inv.T, dtype=torch.float32, device=dev))
    coords = idx_xyz.flip(-1)
    if method == "linear":
        return sample_trilinear(to_tensor(vol.data, dev, torch.float32), coords, cval=cval)
    if method == "nearest":
        return sample_nearest(to_tensor(vol.data, dev), coords, cval=cval)
    raise ValueError(f"unknown method {method!r}")


def resample_volume(vol: Volume, new_spacing: Sequence[float] = (1.0, 1.0, 1.0), *,
                    method: str = "linear", cval: float = 0.0, on_device: bool = False,
                    device="cuda") -> Volume:
    """Resample to a new voxel spacing (same origin/direction). New size =
    round(old_size * old_spacing / new_spacing), as the reference
    (utils/qmri_utils.py:77)."""
    new_size = [int(round(osz * ospc / nspc))
                for osz, ospc, nspc in zip(vol.size, vol.spacing, new_spacing)]
    target = Volume(data=np.zeros(new_size[::-1], np.float32),
                    spacing=tuple(float(s) for s in new_spacing),
                    origin=vol.origin, direction=vol.direction)
    return resample_to_reference(vol, target, method=method, cval=cval,
                                 on_device=on_device, device=device)


def _affine_gather(data: torch.Tensor, B_T: torch.Tensor, c: torch.Tensor, cval: float,
                   shape, method: str) -> torch.Tensor:
    """Sample ``data`` at continuous (x,y,z) indices idx_ref @ B_T + c for
    every voxel of a (nz, ny, nx) target grid; the index grid is made on
    the device, per axis by broadcasting."""
    nz, ny, nx = shape
    dev = data.device
    iz = torch.arange(nz, dtype=torch.float32, device=dev)[:, None, None]
    iy = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    ix = torch.arange(nx, dtype=torch.float32, device=dev)[None, None, :]
    # column j of idx_xyz @ B_T: x * B_T[0, j] + y * B_T[1, j] + z * B_T[2, j]
    x, y, z = (((ix * B_T[0, j] + iy * B_T[1, j]) + iz * B_T[2, j]) + c[j] for j in range(3))
    if method == "linear":
        return _trilinear(data.reshape(-1), tuple(data.shape), z, y, x, cval=cval)
    if method == "nearest":
        return _nearest(data, z, y, x, cval=cval)
    raise ValueError(f"unknown method {method!r}")


def resample_to_reference(vol: Volume, ref: Volume, *, transform=None,
                          method: str = "linear", cval: float = 0.0,
                          on_device: bool = False, device="cuda") -> Volume:
    """Resample ``vol`` onto the grid of ``ref``.

    The target's voxel indices map to continuous source indices through one
    affine (inv(M_src) @ T @ M_ref), applied on ``device``.

    Args:
        transform: optional 4x4 world->world matrix mapping reference-space
            points into ``vol``'s space (a registration result): a numpy
            array, composed on the host in float64, or a tensor (e.g.
            ``RegistrationResult.matrix_device``), composed on the device
            in float32 so a registration -> warp chain never syncs.
        on_device: keep the result on ``device`` as a tensor instead of
            downloading it.
    """
    dev = resolve_device(device)
    A_ref = ref.direction_matrix @ np.diag(ref.spacing)      # idx(x,y,z)->world
    M_inv, origin = _world_to_index_matrix(vol)
    if torch.is_tensor(transform):
        f32 = dict(dtype=torch.float32, device=dev)
        T = transform.to(**f32)
        Mi = torch.as_tensor(M_inv, **f32)
        R3, t3 = T[:3, :3], T[:3, 3]
        B_T = (Mi @ R3 @ torch.as_tensor(A_ref, **f32)).T
        c = Mi @ (R3 @ torch.as_tensor(ref.origin, **f32) + t3 - torch.as_tensor(origin, **f32))
    else:
        T = np.eye(4) if transform is None else np.asarray(transform, np.float64)
        B = M_inv @ T[:3, :3] @ A_ref
        c = M_inv @ (T[:3, :3] @ np.asarray(ref.origin) + T[:3, 3] - origin)
        B_T = torch.as_tensor(np.ascontiguousarray(B.T, np.float32), device=dev)
        c = torch.as_tensor(np.asarray(c, np.float32), device=dev)
    src_dtype = np_dtype(vol.data)
    data = to_tensor(vol.data, dev, torch.float32 if method == "linear" else None)
    vals = _affine_gather(data, B_T, c, cval, tuple(int(s) for s in ref.shape), method)
    if not on_device:
        vals = vals.cpu().numpy()
        if method == "nearest":
            vals = vals.astype(src_dtype)
    return Volume(data=vals, spacing=ref.spacing, origin=ref.origin, direction=ref.direction)
