"""Lookup-table T2 estimation: the counterpart of
``fetal_t2mapping_tpu.models.lut`` (the reference's obsolete LUT path,
rebuilt as a device op: no iteration, a table search and a linear
interpolation per voxel).

For the mono-exponential model the decay ratio r = S(te_i) / S(te_0) =
exp(-(te_i - te_0) / T2) does not depend on k, so one monotone table
T2 <-> r per echo pair suffices. The estimate averages the per-pair
inversions weighted by the later echo's signal, and
k = S(te_0) * exp(te_0 / T2).

The tables are built on the host in float64, rounded once to float32 and
copied to the device, so every device searches the same table.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def build_ratio_table(dte: float, *, t2_min: float = 5.0, t2_max: float = 3000.0,
                      n_entries: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t2_grid, ratio_grid) on the CPU for one echo spacing; the ratio
    increases with T2. Computed in float64 and rounded once to float32:
    the JAX package's float32 grid carries its own rounding (up to 13 ulps
    from this one in t2, tests/test_torch_lut.py)."""
    t2 = np.exp(np.linspace(np.log(t2_min), np.log(t2_max), n_entries))
    ratio = np.exp(-float(dte) / t2)
    return torch.from_numpy(t2.astype(np.float32)), torch.from_numpy(ratio.astype(np.float32))


def lut_t2(signal, *, te: Sequence[float], t2_min: float = 5.0, t2_max: float = 3000.0,
           n_entries: int = 2048, device="cuda") -> torch.Tensor:
    """Estimate (k, T2) for every voxel by inverting the decay ratios.

    Args:
        signal: (N, T) voxel signals, T >= 2, echoes sorted by TE (numpy or
            tensor; moved to ``device``).
        te: echo times (ms).
        device: 'cuda' (default) or 'cpu'.

    Returns:
        (N, 2) float32 tensor [k, T2] on ``device``; T2 clipped to the
        table's range.
    """
    dev = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32, device=dev)
    te = tuple(float(t) for t in te)
    s0 = torch.clamp_min(signal[:, 0], 1e-6)
    t2_est = torch.zeros_like(s0)
    w_sum = torch.zeros_like(s0)
    for i in range(1, len(te)):
        t2_grid, r_grid = (t.to(dev) for t in build_ratio_table(
            te[i] - te[0], t2_min=t2_min, t2_max=t2_max, n_entries=n_entries))
        r = torch.clamp(signal[:, i] / s0, r_grid[0], r_grid[-1])
        idx = torch.clamp(torch.searchsorted(r_grid, r), 1, n_entries - 1)
        r_lo, r_hi = r_grid[idx - 1], r_grid[idx]
        frac = (r - r_lo) / torch.clamp_min(r_hi - r_lo, 1e-12)
        t2_i = t2_grid[idx - 1] * (1 - frac) + t2_grid[idx] * frac
        w = torch.clamp_min(signal[:, i], 0.0)          # later echoes are noisier
        t2_est = t2_est + w * t2_i
        w_sum = w_sum + w
    t2_est = t2_est / torch.clamp_min(w_sum, 1e-12)
    t2_est = torch.clamp(t2_est, t2_min, t2_max)
    k = s0 * torch.exp(torch.tensor(te[0], dtype=torch.float32, device=dev) / t2_est)
    return torch.stack([k, t2_est], dim=-1)


def lut_t2_host(signal, te: Sequence[float], device="cuda", **kwargs) -> np.ndarray:
    """``lut_t2`` on any array-like, returned as a host numpy array."""
    return lut_t2(np.asarray(signal, np.float32), te=te, device=device, **kwargs).cpu().numpy()
