"""Closed-form initializers for the voxel fit (PyTorch).

log S = log k - TE/T2 is linear in (log k, 1/T2); a weighted least-squares
line fit (weights S^2) gives the starting iterate in one fused pass — the
algebra of ``fetal_t2mapping_tpu.models.init.loglinear_init``. The T2
grid scan (``grid_init``) selects a basin for the non-convex 3-parameter
objectives.
"""

from __future__ import annotations

import torch


def _bounds(lo, hi, signal):
    dev, dt = signal.device, signal.dtype
    lo = torch.as_tensor(lo, dtype=dt, device=dev)
    lo = lo.expand(signal.shape[0], lo.shape[-1])
    hi = torch.as_tensor(hi, dtype=dt, device=dev).expand(lo.shape)
    return lo, hi


def loglinear_init(signal: torch.Tensor, te, lo, hi) -> torch.Tensor:
    """Initial parameter batch from a weighted log-linear fit.

    Args:
        signal: (N, T) float32 voxel signals.
        te: (T,) echo times (ms).
        lo, hi: (N, P) or (P,) parameter bounds; P = 2 or 3. For P = 3,
            sigma starts at the RMS residual of the log-linear prediction.

    Returns:
        x0: (N, P) initial parameters on ``signal``'s device, clipped
        inside [lo, hi].
    """
    te = torch.as_tensor(te, dtype=signal.dtype, device=signal.device)
    lo, hi = _bounds(lo, hi, signal)
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
    cols = [k, t2]
    if lo.shape[-1] == 3:
        pred = k[:, None] * torch.exp(-te[None, :] / t2[:, None])
        cols.append(torch.sqrt(torch.mean(torch.square(signal - pred), dim=1) + 1e-12))
    x0 = torch.stack(cols, dim=-1)
    return torch.minimum(torch.maximum(x0, lo), hi)


def grid_init(signal: torch.Tensor, te, lo, hi, n_grid: int = 16) -> torch.Tensor:
    """Coarse T2 grid-scan initializer (basin selection for non-convex fits).

    For each of ``n_grid`` log-spaced T2 candidates inside the bounds, the
    optimal k is <s, e>/<e, e> with e = exp(-te/T2); the candidate with the
    lowest SSE wins, vectorised as (N, G, T). For 3-parameter bounds sigma
    starts at the winner's RMS residual. Returns x0 (N, P) in [lo, hi].
    """
    te = torch.as_tensor(te, dtype=signal.dtype, device=signal.device)
    lo, hi = _bounds(lo, hi, signal)
    t2_lo = torch.clamp(lo[:, 1], min=1.0)
    t2_hi = torch.maximum(hi[:, 1], t2_lo + 1.0)
    frac = torch.linspace(0.02, 0.98, n_grid, dtype=signal.dtype, device=signal.device)
    t2_grid = torch.exp(torch.log(t2_lo)[:, None] + frac[None, :]
                        * (torch.log(t2_hi) - torch.log(t2_lo))[:, None])   # (N, G)

    e = torch.exp(-te[None, None, :] / t2_grid[:, :, None])                # (N, G, T)
    se = torch.sum(signal[:, None, :] * e, dim=-1)
    ee = torch.sum(e * e, dim=-1)
    k_grid = torch.minimum(torch.maximum(se / torch.clamp(ee, min=1e-30), lo[:, 0:1]),
                           hi[:, 0:1])
    resid = signal[:, None, :] - k_grid[:, :, None] * e
    sse = torch.mean(torch.square(resid), dim=-1)                          # (N, G)
    best = torch.argmin(sse, dim=1, keepdim=True)
    cols = [torch.gather(k_grid, 1, best)[:, 0], torch.gather(t2_grid, 1, best)[:, 0]]
    if lo.shape[-1] == 3:
        cols.append(torch.sqrt(torch.gather(sse, 1, best)[:, 0] + 1e-12))
    return torch.minimum(torch.maximum(torch.stack(cols, dim=-1), lo), hi)
