"""Gather-based volume sampling (trilinear / nearest).

The counterpart of ``fetal_t2mapping_tpu.ops.interp``: evaluate a volume at
continuous (z, y, x) voxel coordinates, the workhorse beneath resampling,
fusion and the registration warps (reference utils/qmri_utils.py:61-221).
The eight corners are gathered from the flattened volume at clipped
indices and blended; a sample is in bounds only if 0 <= c <= n-1 on every
axis and reads ``cval`` otherwise. ``F.grid_sample`` does not follow this
border rule (with ``padding_mode="zeros"`` a sample just past n-1 blends
with zeros), so this is a gather. It is differentiable in the coordinates
through the fractional weights only, which is what the registration's
autograd needs.
"""

from __future__ import annotations

import torch


def _float_dtype(t: torch.Tensor) -> torch.dtype:
    return t.dtype if t.is_floating_point() else torch.float32


def _trilinear(flat, shape, z, y, x, base=0, cval=0.0):
    """Trilinear samples of the (nz, ny, nx) block at flat offset ``base``
    of ``flat`` (a tensor broadcastable against z/y/x, or an int)."""
    nz, ny, nx = shape
    z0, y0, x0 = torch.floor(z), torch.floor(y), torch.floor(x)
    fz, fy, fx = z - z0, y - y0, x - x0
    z0i, y0i, x0i = z0.long(), y0.long(), x0.long()
    inb = (z >= 0) & (z <= nz - 1) & (y >= 0) & (y <= ny - 1) & (x >= 0) & (x <= nx - 1)
    out = torch.zeros_like(fz, dtype=_float_dtype(flat))
    for dz in (0, 1):
        wz = (1 - fz) if dz == 0 else fz
        iz = (z0i + dz).clamp(0, nz - 1) * ny
        for dy in (0, 1):
            wy = (1 - fy) if dy == 0 else fy
            izy = (iz + (y0i + dy).clamp(0, ny - 1)) * nx
            for dx in (0, 1):
                wx = (1 - fx) if dx == 0 else fx
                idx = izy + (x0i + dx).clamp(0, nx - 1)
                out = out + flat[base + idx] * (wz * wy * wx)
    # new_full fills on the device: a tensor made from the host scalar would
    # be a host->device copy on every call
    return torch.where(inb, out, out.new_full((), cval))


def sample_trilinear(volume: torch.Tensor, coords: torch.Tensor, *, cval: float = 0.0):
    """Trilinearly sample ``volume`` (Z, Y, X) at ``coords`` (..., 3) in
    (z, y, x) voxel-index space; returns (...,) values (float)."""
    return _trilinear(volume.reshape(-1), tuple(volume.shape),
                      coords[..., 0], coords[..., 1], coords[..., 2], cval=cval)


def sample_trilinear_flat(flat: torch.Tensor, shape, coords: torch.Tensor, *, base=0,
                          cval: float = 0.0):
    """Trilinear sampling from a flat buffer of equally shaped (Z, Y, X)
    blocks: ``base`` is the flat offset of the block to sample (an int or a
    tensor broadcastable against ``coords[..., 0]``, one offset per pair in
    the multi-pair registration). Index clipping is against the block
    ``shape``, so a sample never reads a neighbouring block."""
    return _trilinear(flat, tuple(int(s) for s in shape),
                      coords[..., 0], coords[..., 1], coords[..., 2], base=base, cval=cval)


def _nearest(volume, z, y, x, cval=0.0):
    nz, ny, nx = volume.shape
    iz = torch.floor(z + 0.5).long().clamp(0, nz - 1)
    iy = torch.floor(y + 0.5).long().clamp(0, ny - 1)
    ix = torch.floor(x + 0.5).long().clamp(0, nx - 1)
    inb = (z >= 0) & (z <= nz - 1) & (y >= 0) & (y <= ny - 1) & (x >= 0) & (x <= nx - 1)
    v = volume.reshape(-1)[(iz * ny + iy) * nx + ix]
    return torch.where(inb, v, v.new_full((), cval))


def sample_nearest(volume: torch.Tensor, coords: torch.Tensor, *, cval: float = 0.0):
    """Nearest-neighbour sampling (labels and masks). Rounding is
    floor(c + 0.5), the scipy/ITK convention, not round-half-to-even; the
    in-bounds envelope is the trilinear one. Keeps ``volume``'s dtype."""
    return _nearest(volume, coords[..., 0], coords[..., 1], coords[..., 2], cval=cval)
