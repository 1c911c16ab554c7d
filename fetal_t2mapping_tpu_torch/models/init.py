"""Closed-form log-linear initializer for the voxel fit (PyTorch).

log S = log k - TE/T2 is linear in (log k, 1/T2); a weighted least-squares
line fit (weights S^2) gives the starting iterate in one fused pass — the
algebra of ``fetal_t2mapping_tpu.models.init.loglinear_init``.
"""

from __future__ import annotations

import torch

from .signal import _NOT_PORTED


def loglinear_init(signal: torch.Tensor, te, lo, hi) -> torch.Tensor:
    """Initial (k, t2) batch from a weighted log-linear fit.

    Args:
        signal: (N, T) float32 voxel signals.
        te: (T,) echo times (ms).
        lo, hi: (N, 2) or (2,) parameter bounds.

    Returns:
        x0: (N, 2) initial parameters on ``signal``'s device, clipped
        inside [lo, hi].
    """
    dev, dt = signal.device, signal.dtype
    te = torch.as_tensor(te, dtype=dt, device=dev)
    lo = torch.as_tensor(lo, dtype=dt, device=dev)
    hi = torch.as_tensor(hi, dtype=dt, device=dev)
    if lo.shape[-1] != 2:
        raise NotImplementedError(
            _NOT_PORTED.format(model=f"{lo.shape[-1]}-parameter"))
    s = torch.clamp(signal, min=1e-6)
    w = torch.square(s)
    y = torch.log(s)

    sw = torch.sum(w, dim=1)
    st = torch.sum(w * te, dim=1)
    stt = torch.sum(w * te * te, dim=1)
    sy = torch.sum(w * y, dim=1)
    sty = torch.sum(w * te * y, dim=1)

    det = sw * stt - st * st
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    b = (sw * sty - st * sy) / det          # slope = -1/T2
    a = (sy - b * st) / sw                  # intercept = log k

    t2 = torch.where(b < -1e-12, -1.0 / b, torch.full_like(b, 2000.0))
    k = torch.exp(torch.clamp(a, -30.0, 30.0))
    x0 = torch.stack([k, t2], dim=-1)
    return torch.minimum(torch.maximum(x0, lo), hi)
