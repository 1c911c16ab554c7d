"""EchoStack — a multi-echo volume set staged for the device fit.

The reference stacks per-TE recon volumes into a (x,y,z,nTE) array, builds a
union mask, and reshapes to (N, nTE) before fanning voxels out over a process
pool (reference run_t2mapping.py:383-412). Here the same preparation produces
a device-ready padded batch: masked voxels are gathered into a dense
(N_pad, nTE) array (bucketed, as in the JAX package), fitted on the device,
and scattered back into volume-shaped maps. Host numpy only, identical to
``fetal_t2mapping_tpu.core.stack``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .volume import Volume


def pad_bucket(n: int, granule: int = 8192) -> int:
    """Round up to a bucket size (the JAX package's bucketing, kept so both
    packages fit the same padded batch).

    Above ``granule`` the buckets form a geometric series (ratio 1.1,
    snapped up to a ``granule`` multiple), NOT plain granule multiples, at
    the cost of <= 10% padded rows. Padded rows repeat the last voxel and
    their results are discarded."""
    if n <= granule:
        # small sizes: next power of two (min 256 keeps lanes busy)
        p = 256
        while p < n:
            p *= 2
        return p
    b = float(granule)
    while b < n:
        b *= 1.1
    return int(-(-b // granule) * granule)


@dataclasses.dataclass(frozen=True)
class EchoStack:
    """Multi-echo signal stack + mask on a common voxel grid.

    Attributes:
        signal: (z, y, x, nTE) float32 signal intensities.
        mask:   (z, y, x) bool fit-domain mask (union over per-TE masks,
                reference run_t2mapping.py:383-384).
        tes:    (nTE,) echo times in milliseconds.
        geometry: Volume carrying the grid placement (data unused).
    """

    signal: np.ndarray
    mask: np.ndarray
    tes: np.ndarray
    geometry: Volume

    @classmethod
    def from_volumes(
        cls,
        recons: Sequence[Volume],
        masks: Sequence[Volume],
        tes_ms: Sequence[float],
    ) -> "EchoStack":
        if not (len(recons) == len(masks) == len(tes_ms)):
            raise ValueError("recons, masks and tes must have equal length")
        ref = recons[0]
        for v in list(recons[1:]) + list(masks):
            if v.shape != ref.shape:
                raise ValueError(f"grid mismatch: {v.shape} vs {ref.shape}")
            if not v.same_geometry(ref, tol=1e-3):
                raise ValueError(
                    "physical-grid mismatch between echo volumes (spacing/"
                    "origin/direction differ): voxels would pair signals from "
                    "different anatomical locations — resample to a common "
                    "grid first")
        order = np.argsort(np.asarray(tes_ms))
        signal = np.stack([np.asarray(recons[i].data, dtype=np.float32) for i in order], axis=-1)
        union = np.zeros(ref.shape, dtype=bool)
        for i in order:
            union |= np.asarray(masks[i].data) > 0
        tes = np.asarray([float(tes_ms[i]) for i in order], dtype=np.float32)
        return cls(signal=signal, mask=union, tes=tes, geometry=ref)

    # ------------------------------------------------------------------
    @property
    def n_echoes(self) -> int:
        return int(self.signal.shape[-1])

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return tuple(self.signal.shape[:3])  # type: ignore[return-value]

    def gather(self, granule: int = 8192):
        """Flatten + gather masked voxels, padded to a bucket size.

        Returns (batch, flat_indices, n_valid):
            batch: (N_pad, nTE) float32 — padded rows repeat the last valid
                voxel so padded fits are well-conditioned (results discarded).
            flat_indices: (N,) int64 indices into the flattened volume.
            n_valid: N (number of masked voxels).
        """
        flat_sig = self.signal.reshape(-1, self.n_echoes)
        flat_idx = np.flatnonzero(self.mask.reshape(-1))
        n = int(flat_idx.size)
        if n == 0:
            raise ValueError("empty mask: nothing to fit")
        n_pad = pad_bucket(n, granule)
        batch = np.empty((n_pad, self.n_echoes), dtype=np.float32)
        batch[:n] = flat_sig[flat_idx]
        batch[n:] = batch[n - 1]
        return batch, flat_idx, n

    def scatter(self, values: np.ndarray, flat_idx: np.ndarray) -> Volume:
        """Scatter per-voxel results back into a volume-shaped map."""
        out = np.zeros(int(np.prod(self.grid_shape)), dtype=np.float32)
        out[flat_idx] = np.asarray(values, dtype=np.float32)[: flat_idx.size]
        return Volume(
            data=out.reshape(self.grid_shape),
            spacing=self.geometry.spacing,
            origin=self.geometry.origin,
            direction=self.geometry.direction,
        )
