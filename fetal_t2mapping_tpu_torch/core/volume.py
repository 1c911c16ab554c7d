"""Immutable 3-D image volume with physical-space geometry.

The geometry model mirrors what the reference pipeline propagates through
SimpleITK images (spacing / origin / direction, cf. reference
utils/t2map_utils.py:21-23 which copies exactly these three onto output maps),
but is a plain frozen dataclass over a host numpy array, or a torch tensor
while a volume moves between steps on the device.

Conventions
-----------
- ``data`` is indexed ``(z, y, x)`` — identical to
  ``sitk.GetArrayFromImage`` ordering, so masks/labels written by either
  pipeline line up voxel-for-voxel.
- ``spacing`` / ``origin`` are ``(x, y, z)`` physical (mm, LPS) — ITK order.
- ``direction`` is a row-major 3x3 cosine matrix in LPS (ITK convention).
- NIfTI files store an RAS affine; conversion lives in :mod:`.nifti`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Volume:
    """A 3-D scalar image + its physical-space placement."""

    data: np.ndarray  # (z, y, x)
    spacing: _Vec3 = (1.0, 1.0, 1.0)  # (x, y, z) mm
    origin: _Vec3 = (0.0, 0.0, 0.0)  # (x, y, z) mm, LPS
    direction: Tuple[float, ...] = (1.0, 0.0, 0.0,
                                    0.0, 1.0, 0.0,
                                    0.0, 0.0, 1.0)  # row-major 3x3, LPS

    def __post_init__(self):
        if np.ndim(self.data) != 3:
            raise ValueError(f"Volume data must be 3-D (z,y,x); got shape {np.shape(self.data)}")
        object.__setattr__(self, "spacing", tuple(float(s) for s in self.spacing))
        object.__setattr__(self, "origin", tuple(float(o) for o in self.origin))
        object.__setattr__(self, "direction", tuple(float(d) for d in self.direction))
        if len(self.spacing) != 3 or len(self.origin) != 3 or len(self.direction) != 9:
            raise ValueError("spacing/origin must be length 3, direction length 9")

    # ------------------------------------------------------------------ shape
    @property
    def shape(self) -> Tuple[int, int, int]:
        """Array shape (z, y, x)."""
        return tuple(self.data.shape)  # type: ignore[return-value]

    @property
    def size(self) -> Tuple[int, int, int]:
        """ITK-style size (x, y, z)."""
        return tuple(int(s) for s in self.data.shape[::-1])  # type: ignore[return-value]

    # ------------------------------------------------------------- geometry
    @property
    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, dtype=np.float64).reshape(3, 3)

    @property
    def affine(self) -> np.ndarray:
        """4x4 voxel-index(x,y,z) → world(LPS) affine."""
        A = np.eye(4)
        A[:3, :3] = self.direction_matrix @ np.diag(self.spacing)
        A[:3, 3] = self.origin
        return A

    def index_to_world(self, idx_xyz: np.ndarray) -> np.ndarray:
        """Map continuous voxel indices (..., 3) in (x,y,z) order to LPS mm."""
        idx = np.asarray(idx_xyz, dtype=np.float64)
        M = self.direction_matrix @ np.diag(self.spacing)
        return idx @ M.T + np.asarray(self.origin)

    def world_to_index(self, pts_xyz: np.ndarray) -> np.ndarray:
        """Map LPS mm points (..., 3) to continuous voxel indices (x,y,z)."""
        pts = np.asarray(pts_xyz, dtype=np.float64)
        M = self.direction_matrix @ np.diag(self.spacing)
        return (pts - np.asarray(self.origin)) @ np.linalg.inv(M).T

    def world_grid(self) -> np.ndarray:
        """World coordinates of every voxel centre, shape (z, y, x, 3) in (x,y,z)."""
        nz, ny, nx = self.shape
        zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
        idx = np.stack([xx, yy, zz], axis=-1).astype(np.float64)
        return self.index_to_world(idx)

    # ------------------------------------------------------------- builders
    def with_data(self, data: np.ndarray) -> "Volume":
        """Same geometry, new voxels (the ``CopyInformation`` idiom)."""
        if np.shape(data) != self.shape:
            raise ValueError(f"shape mismatch: {np.shape(data)} vs {self.shape}")
        return dataclasses.replace(self, data=data)

    def astype(self, dtype) -> "Volume":
        return dataclasses.replace(self, data=np.asarray(self.data).astype(dtype))

    def same_geometry(self, other: "Volume", tol: float = 1e-5) -> bool:
        return (
            self.shape == other.shape
            and np.allclose(self.spacing, other.spacing, atol=tol)
            and np.allclose(self.origin, other.origin, atol=tol)
            and np.allclose(self.direction, other.direction, atol=tol)
        )

    # -------------------------------------------------------------- physical
    @property
    def physical_extent(self) -> _Vec3:
        """Physical size (x,y,z) in mm spanned by the voxel grid."""
        return tuple(sp * n for sp, n in zip(self.spacing, self.size))  # type: ignore[return-value]

    def center_world(self) -> np.ndarray:
        """World coordinate of the geometric centre of the volume."""
        half_idx = (np.asarray(self.size, dtype=np.float64) - 1.0) / 2.0
        return self.index_to_world(half_idx)
