"""Frozen copy of the plain PyTorch fits that the benchmark's reference runs.

Copied from ``fetal_t2mapping_tpu_torch/models/fused_fit.py`` at commit
69168b9: ``_grid_table``, ``_scalar_consts``, ``_fit3_tables``, ``_fold``,
``_fl``, ``_loglin_tiles``, ``_stop_tests``, ``_proj_grad``,
``_gauss_fit_plain``, ``_masked_solve3``, ``_newton3_plain``,
``_loglin_start3``, ``_grid_start3``, ``_fit3_plain`` and
``_fit3_cont_plain``, with the constants they read. Two changes: the
gaussian_rician interpolant start is left out (no configuration of the
benchmark fits that model, and ``_fit3_plain`` refuses it), and so are
the interpolant's tables in ``_fit3_tables``. Everything else is as it
was, so the fits run op for op as the program's kernels are specified to.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .objectives import FGH, VALUE_E, cdiv

_LAM0 = 1e-3
_LAM_UP = 5.0
_LAM_DOWN = 0.2
_LAM_MIN = 1e-12
_LAM_MAX = 1e10
_LAM_STALL = 1e6
_XTOL_REL = 1e-6
_N_GRID = 12
_STALL_ITERS = 3


def _grid_table(te: Tuple[float, ...], lo_t2: float, hi_t2: float):
    """The 12-point T2 grid scan's static candidates, computed in float64
    exactly as the reference's Python floats and rounded to float32:
    (t2_g (G,), ee_g (G,), e_g (G, T)) with e_g = exp(-te/t2_g). Computing
    them in float32 on the device could flip basin choices."""
    t2_glo = max(lo_t2, 1.0)
    t2_ghi = max(hi_t2, t2_glo + 1.0)
    t2_g, ee_g, e_g = [], [], []
    for gidx in range(_N_GRID):
        gfrac = 0.02 + 0.96 * gidx / 11.0
        t2v = math.exp(math.log(t2_glo)
                       + gfrac * (math.log(t2_ghi) - math.log(t2_glo)))
        ev = [math.exp(-t / t2v) for t in te]
        t2_g.append(t2v)
        ee_g.append(sum(ei * ei for ei in ev))
        e_g.append(ev)
    f32 = np.float32
    return (np.asarray(t2_g, f32), np.asarray(ee_g, f32), np.asarray(e_g, f32))


def _scalar_consts(lo, hi):
    """float32 scalars shared by both versions: k's bound tolerance (when k's
    lower bound is not per-voxel) and T2's pinned-bound thresholds, rounded
    from the same float64 expressions as the reference."""
    (lo_k, lo_t2), (hi_k, hi_t2) = lo, hi
    tol_k = np.float32(1e-8) * np.float32(max(hi_k - lo_k, 1.0))
    tol_t = 1e-8 * max(hi_t2 - lo_t2, 1.0)
    return tol_k, np.float32(lo_t2 + tol_t), np.float32(hi_t2 - tol_t)


def _fit3_tables(te, lo, hi, guess) -> Dict[str, np.ndarray]:
    """Every constant of the 3-start multistart (pallas_fit.py:341-533),
    in float64 as the reference computes it and rounded to float32."""
    f32 = np.float32
    tol_b = [1e-8 * max(h - l, 1.0) for l, h in zip(lo, hi)]
    grid_t2, grid_ee, grid_e = _grid_table(te, lo[1], hi[1])
    tab = {
        "lo": np.asarray(lo, f32), "hi": np.asarray(hi, f32),
        "lo_thr": np.asarray([l + t for l, t in zip(lo, tol_b)], f32),
        "hi_thr": np.asarray([h - t for h, t in zip(hi, tol_b)], f32),
        "fb": np.asarray([min(max(g, l), h) for g, l, h in zip(guess, lo, hi)], f32),
        "grid_t2": grid_t2, "grid_ee": grid_ee, "grid_e": grid_e,
    }
    return tab


def _fold(terms):
    """Left-to-right sum (the reference's Python ``sum`` over echoes)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _fl(arr):
    """float32 table entries as Python floats (each exactly a float32)."""
    return [float(v) for v in np.asarray(arr, np.float32).ravel()]


def _loglin_tiles(s, te_f):
    """Weighted log-linear (k, t2) estimate (pallas_fit._loglin_tiles).
    Unclipped."""
    sm = [torch.clamp(st, min=1e-6) for st in s]
    y = [torch.log(v) for v in sm]
    w = [torch.square(v) for v in sm]
    sw = _fold(w)
    st_ = _fold([wt * t for wt, t in zip(w, te_f)])
    stt = _fold([wt * t * t for wt, t in zip(w, te_f)])
    sy = _fold([wt * yt for wt, yt in zip(w, y)])
    sty = _fold([wt * t * yt for wt, t, yt in zip(w, te_f, y)])
    det = sw * stt - st_ * st_
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    b = (sw * sty - st_ * sy) / det
    a = (sy - b * st_) / sw
    t2 = torch.where(b < -1e-12, -1.0 / b, torch.full_like(b, 2000.0))
    k = torch.exp(torch.clamp(a, -30.0, 30.0))
    return k, t2


def _stop_tests(f, f_new, lam, conv, scnt, step_sq, x_sq, pg, *, ftol, gtol,
                stall_iters, stall_tol):
    """The shared convergence bookkeeping of every fit body: returns
    (accept, newly, scnt). ``pg``: projected-gradient components (used
    only when gtol > 0)."""
    accept = f_new <= f
    rel_red = (f - f_new) / torch.clamp(
        torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0)
    conv_f = accept & (rel_red <= ftol) & (lam <= 1.0)
    conv_x = step_sq <= _XTOL_REL * _XTOL_REL * x_sq
    newly = conv_f | conv_x | (lam >= _LAM_STALL)
    if gtol > 0:
        pg_max = torch.abs(pg[0])
        for p in pg[1:]:
            pg_max = torch.maximum(pg_max, torch.abs(p))
        newly = newly | (pg_max <= gtol)
    newly = newly & ~conv
    if stall_iters > 0:
        # scipy-ftol-style stop: ``stall_iters`` accepted-but-slow steps
        # in a row declare convergence (rejected trials are neutral)
        slow_acc = accept & (rel_red <= stall_tol) & ~conv
        real_prog = accept & (rel_red > stall_tol)
        scnt = torch.where(conv | real_prog, torch.zeros_like(scnt),
                           torch.where(slow_acc, scnt + 1.0, scnt))
        newly = newly | ((scnt >= float(stall_iters)) & ~conv)
    return accept, newly, scnt


def _proj_grad(x, g, lo_thr, hi_thr):
    zero = torch.zeros_like(g)
    return torch.where(x <= lo_thr, torch.minimum(g, zero),
                       torch.where(x >= hi_thr, torch.maximum(g, zero), g))


def _gauss_fit_plain(signal: torch.Tensor, te, lo, hi, *, max_iters: int,
                     ftol: float, gtol: float, no_prior: bool,
                     full_budget: bool, stall_iters: int, stall_tol: float):
    """Plain PyTorch version of the gaussian fit kernel, vectorised over
    voxels: (N, T) float32 -> (k, t2, f, converged (bool), n_iter (int32)),
    each (N,).

    A Python loop over iterations with masks for frozen voxels; it stops
    early once every voxel converged (unless ``full_budget``), which does
    not change any output because converged voxels are frozen."""
    dev = signal.device
    T = len(te)
    inv_t = 1.0 / T
    c2, cm2 = 2.0 * inv_t, -2.0 * inv_t
    s = list(signal.t().contiguous())
    (lo_k, lo_t2), (hi_k, hi_t2) = lo, hi
    tol_k_c, t2_lo_thr, t2_hi_thr = _scalar_consts(lo, hi)
    t2_lo_thr, t2_hi_thr = float(t2_lo_thr), float(t2_hi_thr)
    if no_prior:
        lo_k = torch.clamp(s[0], min=lo_k)   # echoes are TE-sorted: s[0] = min TE
        tol_k = 1e-8 * torch.clamp(hi_k - lo_k, min=1.0)
        k_lo_thr, k_hi_thr = lo_k + tol_k, hi_k - tol_k
        hi_k = torch.full_like(lo_k, hi_k)
    else:
        k_lo_thr = float(np.float32(lo_k) + tol_k_c)
        k_hi_thr = float(np.float32(hi_k) - tol_k_c)
    te_f = _fl(te)

    def clip_k(x):
        return torch.clamp(x, lo_k, hi_k)

    def exps_at(t2v):
        u = -1.0 / t2v
        return [torch.exp(u * t) for t in te_f]

    def sse(kv, es):
        return _fold([torch.square(st - kv * et) for st, et in zip(s, es)]) * inv_t

    # weighted log-linear init (pallas_fit._loglin_tiles)
    k, t2 = _loglin_tiles(s, te_f)
    k = clip_k(k)
    t2 = torch.clamp(t2, lo_t2, hi_t2)
    e = exps_at(t2)
    f = sse(k, e)

    # 12-point T2 grid scan (basin selection); the divisor is a device
    # tensor so that it is a true division on every backend
    grid_t2, grid_ee, grid_e = _grid_table(te, lo_t2, hi_t2)
    for g in range(_N_GRID):
        e_g = _fl(grid_e[g])
        k_g = clip_k(cdiv(_fold([st * ei for st, ei in zip(s, e_g)]), grid_ee[g]))
        f_g = _fold([torch.square(st - k_g * ei) for st, ei in zip(s, e_g)]) * inv_t
        better = f_g < f
        k = torch.where(better, k_g, k)
        t2 = torch.where(better, torch.full_like(t2, float(grid_t2[g])), t2)
        f = torch.where(better, f_g, f)
        e = [torch.where(better, torch.full_like(ec, eg), ec)
             for eg, ec in zip(e_g, e)]

    lam = torch.full_like(f, _LAM0)
    conv = torch.zeros_like(f, dtype=torch.bool)
    scnt = torch.zeros_like(f)
    nit = torch.zeros_like(f)
    zero = torch.zeros_like(f)
    for _ in range(max_iters):
        if not full_budget and bool(conv.all()):
            break
        m = [k * et for et in e]
        r = [st - mt for st, mt in zip(s, m)]
        inv_t2 = 1.0 / t2
        inv_t2sq = inv_t2 * inv_t2
        u = [inv_t2sq * t for t in te_f]
        dm_t = [mt * ut for mt, ut in zip(m, u)]
        g_t = _fold([rt * dt for rt, dt in zip(r, dm_t)]) * cm2
        h_tt = _fold([dt * dt for dt in dm_t]) * c2
        h_kk = _fold([et * et for et in e]) * c2
        h_kt = _fold([et * ut * mt for et, ut, mt in zip(e, u, m)]) * c2
        free_k = (k > k_lo_thr) & (k < k_hi_thr)
        h_red = h_tt - torch.where(
            free_k, h_kt * h_kt / torch.clamp(h_kk, min=1e-30), zero)
        h_tt = torch.clamp(h_red, min=0.0)

        # KKT active set: pinned at a bound with outward gradient
        free_t = ~(((t2 <= t2_lo_thr) & (g_t > 0)) | ((t2 >= t2_hi_thr) & (g_t < 0)))
        ft = free_t.to(f.dtype)
        a22 = h_tt * ft + (1.0 - ft)
        a22 = a22 + lam * torch.clamp(torch.abs(a22), min=1e-12)
        p_t = -(g_t * ft) / a22

        t2_new = torch.clamp(t2 + p_t, lo_t2, hi_t2)
        e_new = exps_at(t2_new)
        num = _fold([st * et for st, et in zip(s, e_new)])
        den = _fold([et * et for et in e_new])
        k_new = clip_k(num / torch.clamp(den, min=1e-30))
        f_new = sse(k_new, e_new)

        step_sq = torch.square(k_new - k) + torch.square(t2_new - t2)
        x_sq = 1.0 + torch.square(k) + torch.square(t2)
        pg = ()
        if gtol > 0:
            g_k = _fold([rt * et for rt, et in zip(r, e)]) * cm2
            pg = (_proj_grad(k, g_k, k_lo_thr, k_hi_thr),
                  _proj_grad(t2, g_t, t2_lo_thr, t2_hi_thr))
        accept, newly, scnt = _stop_tests(
            f, f_new, lam, conv, scnt, step_sq, x_sq, pg, ftol=ftol, gtol=gtol,
            stall_iters=stall_iters, stall_tol=stall_tol)

        upd = accept & ~conv
        k = torch.where(upd, k_new, k)
        t2 = torch.where(upd, t2_new, t2)
        f = torch.where(upd, f_new, f)
        e = [torch.where(upd, en, eo) for en, eo in zip(e_new, e)]
        lam_new = torch.where(accept, lam * _LAM_DOWN, lam * _LAM_UP)
        lam = torch.where(conv, lam, torch.clamp(lam_new, _LAM_MIN, _LAM_MAX))
        nit = nit + upd.to(f.dtype)
        conv = conv | newly
    return k, t2, f, conv, nit.to(torch.int32)


def _masked_solve3(h, g, fm, lam):
    """Damped reduced 3x3 Newton solve, elementwise (pallas_fit
    ._masked_solve3): pinned coordinates (fm = 0) get identity rows and
    columns; Marquardt damping scales each diagonal by (1 + lam)."""
    a = [[h[i][j] * fm[i] * fm[j] for j in range(3)] for i in range(3)]
    for i in range(3):
        a[i][i] = a[i][i] + (1.0 - fm[i])
        a[i][i] = a[i][i] + lam * torch.clamp(torch.abs(a[i][i]), min=1e-12)
    b = [g[i] * fm[i] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = 1.0 / det
    p0 = -(c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det * fm[0]
    p1 = -(c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det * fm[1]
    p2 = -(c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det * fm[2]
    return p0, p1, p2


def _newton3_plain(model, te_f, tab, max_iters, ftol, gtol, stall_tol, s, x0,
                   convf0=None, nit0=None):
    """Bounded damped-Newton loop for one start (pallas_fit._newton3);
    x0 = (k, t2, sg). The per-echo exponentials at the current iterate
    ride along, so the gradient/Hessian pass is exp-free. convf0/nit0 make
    the loop resumable: voxels entering converged are frozen."""
    lo, hi = _fl(tab["lo"]), _fl(tab["hi"])
    lo_thr, hi_thr = _fl(tab["lo_thr"]), _fl(tab["hi_thr"])
    fgh_fn, val_e = FGH[model], VALUE_E[model]
    x = tuple(torch.clamp(xi, l, h) for xi, l, h in zip(x0, lo, hi))
    f, e = val_e(x, s, te_f)
    lam = torch.full_like(f, _LAM0)
    convf = torch.zeros_like(f) if convf0 is None else convf0
    scnt = torch.zeros_like(f)
    nit = torch.zeros_like(f) if nit0 is None else nit0
    for _ in range(max_iters):
        conv = convf > 0.5
        if bool(conv.all()):
            break
        _, g, h = fgh_fn(x, s, te_f, e)
        fm = [(~(((x[i] <= lo_thr[i]) & (g[i] > 0))
                 | ((x[i] >= hi_thr[i]) & (g[i] < 0)))).to(f.dtype) for i in range(3)]
        p = _masked_solve3(h, g, fm, lam)
        x_new = tuple(torch.clamp(x[i] + p[i], lo[i], hi[i]) for i in range(3))
        f_new, e_new = val_e(x_new, s, te_f)

        step_sq = _fold([torch.square(x_new[i] - x[i]) for i in range(3)])
        x_sq = 1.0 + _fold([torch.square(x[i]) for i in range(3)])
        pg = tuple(_proj_grad(x[i], g[i], lo_thr[i], hi_thr[i]) for i in range(3)) \
            if gtol > 0 else ()
        accept, newly, scnt = _stop_tests(
            f, f_new, lam, conv, scnt, step_sq, x_sq, pg, ftol=ftol, gtol=gtol,
            stall_iters=_STALL_ITERS, stall_tol=stall_tol)

        upd = accept & ~conv
        x = tuple(torch.where(upd, xn, xo) for xn, xo in zip(x_new, x))
        f = torch.where(upd, f_new, f)
        e = [torch.where(upd, en, eo) for en, eo in zip(e_new, e)]
        lam_new = torch.where(accept, lam * _LAM_DOWN, lam * _LAM_UP)
        lam = torch.where(conv, lam, torch.clamp(lam_new, _LAM_MIN, _LAM_MAX))
        nit = nit + upd.to(f.dtype)
        convf = torch.maximum(convf, newly.to(f.dtype))
    return x, f, convf, nit


def _loglin_start3(s, te_f, lo, hi):
    """Log-linear (k, t2) + RMS-residual sigma (pallas_fit._loglin_start3)."""
    k, t2 = _loglin_tiles(s, te_f)
    u_inv = -1.0 / torch.clamp(t2, lo[1], hi[1])
    kc = torch.clamp(k, lo[0], hi[0])
    sse = cdiv(_fold([torch.square(st - kc * torch.exp(t * u_inv))
                      for st, t in zip(s, te_f)]), float(len(te_f)))
    sg = torch.sqrt(sse + 1e-12)
    return (kc, torch.clamp(t2, lo[1], hi[1]), torch.clamp(sg, lo[2], hi[2]))


def _grid_start3(s, tab, lo, hi):
    """12-point T2 grid-scan basin selection (pallas_fit._grid_start3)."""
    T = len(s)
    g_t2, g_ee = _fl(tab["grid_t2"]), _fl(tab["grid_ee"])
    best_sse = best_k = best_t2 = None
    for gidx in range(_N_GRID):
        e = _fl(tab["grid_e"][gidx])
        k_g = torch.clamp(cdiv(_fold([st * ei for st, ei in zip(s, e)]), g_ee[gidx]),
                          lo[0], hi[0])
        sse = cdiv(_fold([torch.square(st - k_g * ei) for st, ei in zip(s, e)]), float(T))
        if best_sse is None:
            best_sse, best_k, best_t2 = sse, k_g, torch.full_like(k_g, g_t2[gidx])
        else:
            better = sse < best_sse
            best_k = torch.where(better, k_g, best_k)
            best_t2 = torch.where(better, g_t2[gidx], best_t2)
            best_sse = torch.minimum(sse, best_sse)
    sg = torch.sqrt(best_sse + 1e-12)
    return (best_k, torch.clamp(best_t2, lo[1], hi[1]), torch.clamp(sg, lo[2], hi[2]))


def _fit3_plain(signal: torch.Tensor, model: str, te, lo, hi, guess, *,
                max_iters: int, ftol: float, gtol: float, stall_tol: float):
    """Plain PyTorch version of the 3-start multistart kernel
    (pallas_fit._kernel3_body + the argmin of _fit3_tiles), vectorised
    over voxels: (N, T) float32 -> (params (3, N), stats (3, N) =
    [f, converged (0/1), n_iter]) of the start with the lowest objective
    (ties and NaN as jnp.argmin: the first minimum, the first NaN).

    Starts: log-linear, the T2 grid scan, and the clipped protocol guess
    — or, for gaussian_rician at T = 3, the interpolant (16 bisections)."""
    tab = _fit3_tables(te, lo, hi, guess)
    te_f = _fl(te)
    lo_f, hi_f = _fl(tab["lo"]), _fl(tab["hi"])
    s = list(signal.t().contiguous())
    if model == "gaussian_rician" and len(te) == 3:
        raise ValueError("the interpolant start of gaussian_rician is not copied here")
    third = tuple(torch.full_like(s[0], v) for v in _fl(tab["fb"]))
    starts = (_loglin_start3(s, te_f, lo_f, hi_f), _grid_start3(s, tab, lo_f, hi_f), third)
    best = None
    for x0 in starts:
        x, f, convf, nit = _newton3_plain(model, te_f, tab, max_iters, ftol, gtol,
                                          stall_tol, s, x0)
        cur = torch.stack([*x, f, convf, nit])
        if best is None:
            best = cur
        else:
            take = ~torch.isnan(best[3]) & (torch.isnan(f) | (f < best[3]))
            best = torch.where(take, cur, best)
    return best[:3], best[3:]


def _fit3_cont_plain(signal: torch.Tensor, model: str, te, lo, hi, guess,
                     x0: torch.Tensor, st0: torch.Tensor, *, max_iters: int,
                     ftol: float, gtol: float, stall_tol: float):
    """Plain PyTorch version of the continuation kernel
    (pallas_fit._kernel3_cont_body): resume one Newton run per voxel from
    x0 (3, N) with st0 (3, N) = [f, convf, nit] of the prefix winner.
    lam and the stall counter restart, and f0 is re-evaluated at x0."""
    tab = _fit3_tables(te, lo, hi, guess)
    s = list(signal.t().contiguous())
    x, f, convf, nit = _newton3_plain(model, _fl(te), tab, max_iters, ftol, gtol,
                                      stall_tol, s, tuple(x0), convf0=st0[1],
                                      nit0=st0[2])
    return torch.stack(x), torch.stack([f, convf, nit])
