"""Fused voxel fits: the counterpart of ``pallas_fit.fit_fused``.

The whole fit of a voxel — starts, basin selection and the damped-Newton
loop — runs in one call. Each fit has hand-written CUDA kernels used on a
CUDA tensor (one thread per voxel; the gaussian and gaussian_rician VARPRO
fits and the multistart continuation as a head and a persistent tail,
which resumes the voxels still running from a worklist so no warp waits
on one straggler), and a plain PyTorch version of the same algorithm,
vectorised over voxels, used on a CPU tensor. The choice follows the
tensor's device only: there is no fallback from a kernel to its plain
version.

| fit | kernel | plain version | replaces (pallas_fit.py) |
|---|---|---|---|
| gaussian VARPRO | ``csrc/gauss_fit.cu`` | ``_gauss_fit_plain`` | ``_gauss_kernel_body`` |
| gaussian_rician VARPRO | ``csrc/gr_varpro_fit.cu`` | ``_gr_varpro_fit_plain`` | ``_gr_varpro_kernel_body`` |
| 3-start multistart | ``csrc/fit3.cu`` ``ft2_fit3_multistart`` | ``_fit3_plain`` | ``_kernel3_body`` |
| multistart continuation | ``csrc/fit3.cu`` ``ft2_fit3_cont`` | ``_fit3_cont_plain`` | ``_kernel3_cont_body`` |

Kernels and plain versions follow the reference op for op — the same
left-to-right sums over echoes, the same float32 constants (every
expression the reference evaluates between Python floats is computed here
in float64 on the host and rounded once), NaN-propagating clips, IEEE
division — so they agree with the reference to float32 rounding, and
converged voxels freeze, so results do not depend on how voxels are
grouped.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .. import build
from ..device import resolve_device
from .fgh import FGH, VALUE_E, cdiv, rdiv
from .solver import FitResult

N_PARAMS = {"gaussian": 2, "gaussian_rician": 3, "rician": 3}

_LAM0 = 1e-3
_LAM_UP = 5.0
_LAM_DOWN = 0.2
_LAM_MIN = 1e-12
_LAM_MAX = 1e10
_LAM_STALL = 1e6
_XTOL_REL = 1e-6
_N_GRID = 12
_N_INTERP = 16       # the interpolant's static bracket grid
_STALL_ITERS = 3
_MAX_TE = 8          # the kernels are instantiated for 2..8 echoes
_MODEL_ID = {"gaussian_rician": 0, "rician": 1}   # fit3.cu's model switch

# Multistart prefix length for the 3-parameter multistart: all 3 starts run
# this many iterations, then only the per-voxel winner continues
# (pallas_fit._PREFIX3_DEFAULT). 0 disables pruning.
_PREFIX3_DEFAULT = 4
_VARPRO3_DEFAULT = 1

#: launches of each CUDA kernel in this process (each wrapper adds one per
#: launch; the plain versions never touch them)
KERNEL_LAUNCHES = 0          # gauss_fit
GR_VARPRO_LAUNCHES = 0       # gr_varpro_fit
FIT3_LAUNCHES = 0            # fit3 multistart
FIT3_CONT_LAUNCHES = 0       # fit3 continuation


def validate_fused_args(model, te, lo, hi, guess, no_prior):
    """Validate + normalize static fused-fit arguments (the JAX package's
    ``validate_fused_args``: the same inputs are rejected the same way)."""
    if model not in N_PARAMS:
        raise ValueError(f"unknown model {model!r}")
    p = N_PARAMS[model]
    if len(lo) != p or len(hi) != p:
        raise ValueError(f"{model} needs {p} bounds, got {len(lo)}/{len(hi)}")
    if no_prior and model != "gaussian":
        raise ValueError("no_prior bounds are defined for the gaussian model only")
    te_t = tuple(float(x) for x in te)
    lo_t = tuple(float(x) for x in lo)
    hi_t = tuple(float(x) for x in hi)
    if model == "rician":
        # the likelihood divides by sigma^2: keep the lower bound off zero
        lo_t = lo_t[:2] + (max(lo_t[2], 1e-2),)
    if guess is None:
        guess_t = tuple((l + h) / 2.0 for l, h in zip(lo_t, hi_t))
    else:
        guess_t = tuple(float(x) for x in guess)
    return te_t, lo_t, hi_t, guess_t


def resolve_prefix3(prefix3, max_iters: int) -> int:
    """Effective multistart prefix length. None -> the FT2_FIT3_PREFIX env
    override or the default (4); values <= 0 or >= max_iters mean no
    pruning (every start runs the full budget)."""
    if prefix3 is None:
        prefix3 = int(os.environ.get("FT2_FIT3_PREFIX", _PREFIX3_DEFAULT))
    prefix3 = int(prefix3)
    if prefix3 <= 0 or prefix3 >= max_iters:
        return 0
    return prefix3


def resolve_varpro3(varpro3, model: str) -> bool:
    """Whether gaussian_rician runs the VARPRO kernel. None -> the
    FT2_FIT3_VARPRO env override or the default (on). Only gaussian_rician
    has the reduction: rician's likelihood is not linear in (k^2, sigma^2)."""
    if model != "gaussian_rician":
        return False
    if varpro3 is None:
        varpro3 = int(os.environ.get("FT2_FIT3_VARPRO", _VARPRO3_DEFAULT))
    return bool(varpro3)


def resolve_strategy(strategy: str) -> str:
    """'auto' -> 'single', for every model.

    'single' runs one pass over every voxel. The reference's 'auto' picks
    the same for gaussian, for rician with prefix pruning and for the
    gaussian_rician VARPRO kernel. For the 3-start multistart without
    pruning (rician with prefix3=0, and gaussian_rician with varpro3=False)
    it picks 'twophase' — a short lock-step pass, then a refit from scratch
    of the unconverged tail, compacted into a buffer — because on the TPU a
    block runs until its slowest voxel converged. On the GPU a warp runs
    until its slowest lane stops, the same effect at 32 voxels (measured on
    the H100, PERF.md), and the compaction lives inside the kernels
    instead: the gaussian and gaussian_rician VARPRO fits and the rician
    continuation push the voxels still running after their head into a
    worklist that a persistent tail kernel drains, resuming the exact
    carried state. So 'auto' gives 'single'; 'twophase' is not ported and
    raises."""
    if strategy == "twophase":
        raise NotImplementedError(
            "strategy 'twophase' (refit of the straggler tail) is not ported: "
            "the kernels compact their stragglers themselves, see ROADMAP Queue 1 item 3")
    if strategy not in ("single", "auto"):
        raise ValueError(f"unknown strategy {strategy!r}")
    return "single"


# ------------------------------------------------------------ host tables
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


def _interp_table(te, lo_t2: float, hi_t2: float) -> Dict[str, np.ndarray]:
    """The T = 3 interpolant's static bracket grid (pallas_fit.py:497-503):
    16 log-spaced t2 values and, at each, the float64 differences
    E1 - E2 and E0 - E1 of E_i = exp(-2 te_i / t2), plus -2 te."""
    t2_a = max(lo_t2, 1.0)
    t2_b = max(hi_t2, t2_a * (1.0 + 1e-6))
    ts, d12, d01 = [], [], []
    for i in range(_N_INTERP):
        tv = math.exp(math.log(t2_a) + i / (_N_INTERP - 1.0)
                      * (math.log(t2_b) - math.log(t2_a)))
        e = [math.exp(-2.0 * t / tv) for t in te]
        ts.append(tv)
        d12.append(e[1] - e[2])
        d01.append(e[0] - e[1])
    f32 = np.float32
    return {"it_ts": np.asarray(ts, f32), "it_d12": np.asarray(d12, f32),
            "it_d01": np.asarray(d01, f32),
            "m2te": np.asarray([-2.0 * t for t in te], f32)}


def _gr_tables(te, lo, hi, guess) -> Dict[str, np.ndarray]:
    """Every constant of the gaussian_rician VARPRO fit, in float64 as the
    reference computes it (pallas_fit.py:568-681) and rounded to float32."""
    (lo_k, lo_t2, lo_sg), (hi_k, hi_t2, hi_sg) = lo, hi
    T = len(te)
    alo, ahi = lo_k * lo_k, hi_k * hi_k
    blo, bhi = lo_sg * lo_sg, hi_sg * hi_sg
    tol_a = 1e-8 * max(ahi - alo, 1.0)
    tol_b = 1e-8 * max(bhi - blo, 1.0)
    tol_t = 1e-8 * max(hi_t2 - lo_t2, 1.0)
    t2_glo = max(lo_t2, 1.0)
    t2_ghi = max(hi_t2, t2_glo + 1.0)
    g_t2, g_e, g_se, g_se2, g_idet = [], [], [], [], []
    for gidx in range(_N_GRID):
        gfrac = 0.02 + 0.96 * gidx / 11.0
        t2_g = math.exp(math.log(t2_glo)
                        + gfrac * (math.log(t2_ghi) - math.log(t2_glo)))
        e_g = [math.exp(-2.0 * t / t2_g) for t in te]
        se = sum(e_g)
        se2 = sum(e * e for e in e_g)
        g_t2.append(t2_g)
        g_e.append(e_g)
        g_se.append(se)
        g_se2.append(se2)
        g_idet.append(1.0 / max(T * se2 - se * se, 1e-30))
    f32 = np.float32
    tab = {
        "lo": np.asarray(lo, f32), "hi": np.asarray(hi, f32),
        "ab": np.asarray([alo, ahi, blo, bhi], f32),
        "thr": np.asarray([alo + tol_a, ahi - tol_a, blo + tol_b, bhi - tol_b,
                           lo_t2 + tol_t, hi_t2 - tol_t], f32),
        "b_init": np.asarray([min(max(guess[2] * guess[2], blo), bhi)], f32),
        "fb": np.asarray([min(max(g, l), h) for g, l, h in zip(guess, lo, hi)], f32),
        "grid_t2": np.asarray(g_t2, f32), "grid_e": np.asarray(g_e, f32),
        "grid_se": np.asarray(g_se, f32), "grid_se2": np.asarray(g_se2, f32),
        "grid_idet": np.asarray(g_idet, f32),
    }
    if T == 3:
        tab.update(_interp_table(te, lo_t2, hi_t2))
    return tab


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
    if len(te) == 3:
        tab.update(_interp_table(te, lo[1], hi[1]))
    return tab


# The kernels' parameter structs, field by field (name, float count); the
# order is the declaration order in the CUDA sources.
_GAUSS_FIELDS = (("head", 10), ("te", _MAX_TE), ("grid_t2", _N_GRID),
                 ("grid_ee", _N_GRID), ("grid_e", _N_GRID * _MAX_TE))
_GR_FIELDS = (("lo", 3), ("hi", 3), ("ab", 4), ("thr", 6), ("b_init", 1),
              ("fb", 3), ("tols", 3), ("te", _MAX_TE), ("m2te", _MAX_TE),
              ("grid_t2", _N_GRID), ("grid_e", _N_GRID * _MAX_TE),
              ("grid_se", _N_GRID), ("grid_se2", _N_GRID), ("grid_idet", _N_GRID),
              ("it_ts", _N_INTERP), ("it_d12", _N_INTERP), ("it_d01", _N_INTERP))
_FIT3_FIELDS = (("lo", 3), ("hi", 3), ("lo_thr", 3), ("hi_thr", 3), ("fb", 3),
                ("tols", 3), ("te", _MAX_TE), ("m2te", _MAX_TE),
                ("grid_t2", _N_GRID), ("grid_ee", _N_GRID),
                ("grid_e", _N_GRID * _MAX_TE),
                ("it_ts", _N_INTERP), ("it_d12", _N_INTERP), ("it_d01", _N_INTERP))


def _pack(fields, tab: Dict[str, np.ndarray]) -> np.ndarray:
    """Flatten a table into its struct's float32 layout: (G, T) arrays are
    padded to (G, 8), short vectors with zeros, missing fields are zero."""
    parts = []
    for name, size in fields:
        v = np.asarray(tab.get(name, ()), np.float32)
        if v.ndim == 2:
            pad = np.zeros((v.shape[0], _MAX_TE), np.float32)
            pad[:, :v.shape[1]] = v
            v = pad
        out = np.zeros(size, np.float32)
        out[:v.size] = v.ravel()
        parts.append(out)
    return np.concatenate(parts)


def _kernel_params(te, lo, hi, ftol, gtol, stall_tol) -> np.ndarray:
    """csrc/gauss_fit.cu's ``GaussParams`` as a flat float32 array."""
    (lo_k, lo_t2), (hi_k, hi_t2) = lo, hi
    tol_k, t2_lo_thr, t2_hi_thr = _scalar_consts(lo, hi)
    grid_t2, grid_ee, grid_e = _grid_table(te, lo_t2, hi_t2)
    head = [lo_k, hi_k, lo_t2, hi_t2, tol_k, t2_lo_thr, t2_hi_thr, ftol, gtol, stall_tol]
    return _pack(_GAUSS_FIELDS, {"head": head, "te": te, "grid_t2": grid_t2,
                                 "grid_ee": grid_ee, "grid_e": grid_e})


def _gr_kernel_params(te, lo, hi, guess, ftol, gtol, stall_tol) -> np.ndarray:
    """csrc/gr_varpro_fit.cu's ``GrParams`` as a flat float32 array."""
    tab = dict(_gr_tables(te, lo, hi, guess), te=np.asarray(te, np.float32),
               tols=np.asarray([ftol, gtol, stall_tol], np.float32))
    return _pack(_GR_FIELDS, tab)


def _fit3_kernel_params(te, lo, hi, guess, ftol, gtol, stall_tol) -> np.ndarray:
    """csrc/fit3.cu's ``Fit3Params`` as a flat float32 array."""
    tab = dict(_fit3_tables(te, lo, hi, guess), te=np.asarray(te, np.float32),
               tols=np.asarray([ftol, gtol, stall_tol], np.float32))
    return _pack(_FIT3_FIELDS, tab)


# ----------------------------------------------------------- plain versions
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


def _interp_start_gr(s, tab, lo, hi, n_bisect):
    """Exact 0-dof interpolation start for gaussian_rician at T == 3
    (pallas_fit._interp_start_gr): bracket t2 on the static 16-point grid,
    geometric bisection, then k and sigma in closed form, clipped into the
    box; the clipped protocol guess where no interpolant exists."""
    (lo_k, _, lo_sg), (hi_k, _, hi_sg) = lo, hi
    ts, t12, t01 = _fl(tab["it_ts"]), _fl(tab["it_d12"]), _fl(tab["it_d01"])
    m2te = _fl(tab["m2te"])
    sq = [st * st for st in s]
    d12 = sq[0] - sq[1]
    d23 = sq[1] - sq[2]

    def g_of(E):
        return d12 * (E[1] - E[2]) - d23 * (E[0] - E[1])

    a = torch.full_like(s[0], ts[0])
    b = torch.full_like(s[0], ts[-1])
    g_prev = d12 * t12[0] - d23 * t01[0]
    ga = g_prev
    found = torch.zeros_like(s[0], dtype=torch.bool)
    for i in range(_N_INTERP - 1):
        g_next = d12 * t12[i + 1] - d23 * t01[i + 1]
        cross = (g_prev * g_next <= 0.0) & ~found
        a = torch.where(cross, ts[i], a)
        b = torch.where(cross, ts[i + 1], b)
        ga = torch.where(cross, g_prev, ga)
        found = found | cross
        g_prev = g_next
    for _ in range(n_bisect):   # geometric bisection: rel err ~(b/a)^(2^-n)
        m = torch.sqrt(a * b)
        gm = g_of([torch.exp(rdiv(c, m)) for c in m2te])
        same = (gm > 0.0) == (ga > 0.0)
        a = torch.where(same, m, a)
        ga = torch.where(same, gm, ga)
        b = torch.where(same, b, m)
    t2r = torch.sqrt(a * b)
    E = [torch.exp(rdiv(c, t2r)) for c in m2te]
    denom = E[0] - E[1]
    k2 = d12 / torch.where(torch.abs(denom) < 1e-30, torch.full_like(denom, 1e-30), denom)
    sg2 = sq[2] - k2 * E[2]
    k = torch.clamp(torch.sqrt(torch.clamp(k2, min=0.0)), lo_k, hi_k)
    sg = torch.clamp(torch.sqrt(torch.clamp(sg2, min=0.0)), lo_sg, hi_sg)
    valid = found & (d12 > 0) & (d23 > 0) & (k2 > 0)
    fb = _fl(tab["fb"])
    return (torch.where(valid, k, fb[0]), torch.where(valid, t2r, fb[1]),
            torch.where(valid, sg, fb[2]))


def _gr_varpro_fit_plain(signal: torch.Tensor, te, lo, hi, guess, *,
                         max_iters: int, ftol: float, gtol: float,
                         full_budget: bool, stall_iters: int, stall_tol: float):
    """Plain PyTorch version of the gaussian_rician VARPRO kernel
    (pallas_fit._gr_varpro_kernel_body), vectorised over voxels:
    (N, T) float32 -> (params (3, N) = [k, t2, sigma],
    stats (3, N) = [f, converged (0/1), n_iter]).

    f = mean_t (s - sqrt(a E_t + b))^2 with (a, b) = (k^2, sigma^2) and
    E = exp(-2 te/t2): an exp-free projected 2x2 Newton profiles (a, b) at
    fixed t2 (convex), and a damped 1-D Newton walks t2's envelope. Basin
    selection: log-linear start, the T = 3 interpolant (8 bisections), a
    12-point grid scored in closed form in s^2-space, one exact polish."""
    tab = _gr_tables(te, lo, hi, guess)
    T = len(te)
    inv_t = 1.0 / T
    s = list(signal.t().contiguous())
    (lo_k, lo_t2, lo_sg), (hi_k, hi_t2, hi_sg) = lo, hi
    te_f = _fl(te)
    alo, ahi, blo, bhi = _fl(tab["ab"])
    a_lo_thr, a_hi_thr, b_lo_thr, b_hi_thr, t2_lo_thr, t2_hi_thr = _fl(tab["thr"])
    cm1, ch, cm2, c2 = -inv_t, 0.5 * inv_t, -2.0 * inv_t, 2.0 * inv_t

    def E_at(t2v):
        u = -2.0 / t2v
        return [torch.exp(t * u) for t in te_f]

    def minv_of(q):
        return torch.rsqrt(torch.clamp(q, min=1e-6))

    def free_of(x, g, lo_thr, hi_thr):
        return (~(((x <= lo_thr) & (g > 0)) | ((x >= hi_thr) & (g < 0)))).to(x.dtype)

    def inner(E, a, b, iters):
        """``iters`` projected-Newton steps on the convex (a, b) profile."""
        for _ in range(iters):
            q = [a * Ei + b for Ei in E]
            minv = [minv_of(qi) for qi in q]
            r = [st - qi * mi for st, qi, mi in zip(s, q, minv)]
            ga = cm1 * _fold([ri * Ei * mi for ri, Ei, mi in zip(r, E, minv)])
            gb = cm1 * _fold([ri * mi for ri, mi in zip(r, minv)])
            w = [st * mi * mi * mi for st, mi in zip(s, minv)]
            haa = ch * _fold([Ei * Ei * wi for Ei, wi in zip(E, w)])
            hab = ch * _fold([Ei * wi for Ei, wi in zip(E, w)])
            hbb = ch * _fold(w)
            fa = free_of(a, ga, a_lo_thr, a_hi_thr)
            fb = free_of(b, gb, b_lo_thr, b_hi_thr)
            a00 = haa * fa + (1.0 - fa)
            a11 = hbb * fb + (1.0 - fb)
            a01 = hab * fa * fb
            b0 = ga * fa
            b1 = gb * fb
            det = a00 * a11 - a01 * a01
            idet = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
            a = torch.clamp(a - (a11 * b0 - a01 * b1) * idet * fa, alo, ahi)
            b = torch.clamp(b - (a00 * b1 - a01 * b0) * idet * fb, blo, bhi)
        return a, b

    def f_of(E, a, b):
        q = [a * Ei + b for Ei in E]
        return inv_t * _fold([torch.square(st - qi * minv_of(qi))
                              for st, qi in zip(s, q)])

    # ---- basin selection: loglinear, exact interpolant, static t2 grid
    k_ll, t2_ll = _loglin_tiles(s, te_f)
    t2 = torch.clamp(t2_ll, lo_t2, hi_t2)
    a = torch.clamp(torch.square(torch.clamp(k_ll, lo_k, hi_k)), alo, ahi)
    b = torch.full_like(a, float(tab["b_init"][0]))
    E = E_at(t2)
    a, b = inner(E, a, b, 2)
    f = f_of(E, a, b)

    if T == 3:
        ki, t2i, sgi = _interp_start_gr(s, tab, lo, hi, n_bisect=8)
        Ei = E_at(t2i)
        ai, bi = inner(Ei, torch.square(ki), torch.square(sgi), 2)
        fi = f_of(Ei, ai, bi)
        better = fi < f
        t2 = torch.where(better, t2i, t2)
        a = torch.where(better, ai, a)
        b = torch.where(better, bi, b)
        f = torch.where(better, fi, f)
        E = [torch.where(better, en, eo) for en, eo in zip(Ei, E)]

    sq = [st * st for st in s]
    sq_sum = _fold(sq)
    g_t2, g_se, g_se2 = _fl(tab["grid_t2"]), _fl(tab["grid_se"]), _fl(tab["grid_se2"])
    g_idet = _fl(tab["grid_idet"])
    for gidx in range(_N_GRID):
        E_g = _fl(tab["grid_e"][gidx])
        s1 = _fold([qt * e for qt, e in zip(sq, E_g)])
        ag = torch.clamp((float(T) * s1 - g_se[gidx] * sq_sum) * g_idet[gidx], alo, ahi)
        bg = torch.clamp((g_se2[gidx] * sq_sum - g_se[gidx] * s1) * g_idet[gidx], blo, bhi)
        fg = f_of(E_g, ag, bg)
        better = fg < f
        t2 = torch.where(better, g_t2[gidx], t2)
        a = torch.where(better, ag, a)
        b = torch.where(better, bg, b)
        f = torch.where(better, fg, f)
        E = [torch.where(better, eg, ec) for eg, ec in zip(E_g, E)]
    # ONE exact polish of the winner; keep (a, b, f) consistent
    a2, b2 = inner(E, a, b, 3)
    f2 = f_of(E, a2, b2)
    keep = f2 <= f
    a = torch.where(keep, a2, a)
    b = torch.where(keep, b2, b)
    f = torch.where(keep, f2, f)

    # ---- outer damped 1-D Newton on the envelope F(t2)
    lam = torch.full_like(f, _LAM0)
    convf = torch.zeros_like(f)
    scnt = torch.zeros_like(f)
    nit = torch.zeros_like(f)
    for _ in range(max_iters):
        conv = convf > 0.5
        if not full_budget and bool(conv.all()):
            break
        q = [a * Ei + b for Ei in E]
        minv = [minv_of(qi) for qi in q]
        r = [st - qi * mi for st, qi, mi in zip(s, q, minv)]
        inv_t2 = 1.0 / t2
        inv_t2sq = inv_t2 * inv_t2
        # dM/dt2 = a E te / (t2^2 M);  dM/da = E/(2M);  dM/db = 1/(2M)
        dMt = [a * Ei * (t * inv_t2sq) * mi for Ei, t, mi in zip(E, te_f, minv)]
        dMa = [0.5 * Ei * mi for Ei, mi in zip(E, minv)]
        dMb = [0.5 * mi for mi in minv]
        g_t = cm2 * _fold([ri * di for ri, di in zip(r, dMt)])
        ga = cm2 * _fold([ri * di for ri, di in zip(r, dMa)])
        gb = cm2 * _fold([ri * di for ri, di in zip(r, dMb)])
        # Gauss-Newton pieces (PSD) for the Schur-reduced curvature
        htt = c2 * _fold([di * di for di in dMt])
        hta = c2 * _fold([dt * da for dt, da in zip(dMt, dMa)])
        htb = c2 * _fold([dt * db for dt, db in zip(dMt, dMb)])
        haa = c2 * _fold([da * da for da in dMa])
        hab = c2 * _fold([da * db for da, db in zip(dMa, dMb)])
        hbb = c2 * _fold([db * db for db in dMb])
        fa = free_of(a, ga, a_lo_thr, a_hi_thr)
        fb = free_of(b, gb, b_lo_thr, b_hi_thr)
        a00 = haa * fa + (1.0 - fa)
        a11 = hbb * fb + (1.0 - fb)
        a01 = hab * fa * fb
        det = torch.clamp(a00 * a11 - a01 * a01, min=1e-30)
        v0 = hta * fa
        v1 = htb * fb
        schur = (a11 * v0 * v0 - 2.0 * a01 * v0 * v1 + a00 * v1 * v1) / det
        h_red = torch.clamp(htt - schur, min=0.0)
        ft = free_of(t2, g_t, t2_lo_thr, t2_hi_thr)
        a22 = h_red * ft + (1.0 - ft)
        a22 = a22 + lam * torch.clamp(torch.abs(a22), min=1e-12)
        p_t = -(g_t * ft) / a22

        t2_new = torch.clamp(t2 + p_t, lo_t2, hi_t2)
        E_new = E_at(t2_new)
        a_new, b_new = inner(E_new, a, b, 3)
        f_new = f_of(E_new, a_new, b_new)

        step_sq = torch.square(t2_new - t2)
        x_sq = 1.0 + torch.square(t2)
        pg = ()
        if gtol > 0:
            # projected gradient in the original (k, t2, sg) coordinates:
            # df/dk = 2k df/da, df/dsg = 2sg df/db
            g_k = 2.0 * torch.sqrt(a) * ga
            g_s = 2.0 * torch.sqrt(b) * gb
            pg = (_proj_grad(a, g_k, a_lo_thr, a_hi_thr),
                  _proj_grad(t2, g_t, t2_lo_thr, t2_hi_thr),
                  _proj_grad(b, g_s, b_lo_thr, b_hi_thr))
        accept, newly, scnt = _stop_tests(
            f, f_new, lam, conv, scnt, step_sq, x_sq, pg, ftol=ftol, gtol=gtol,
            stall_iters=stall_iters, stall_tol=stall_tol)

        upd = accept & ~conv
        a = torch.where(upd, a_new, a)
        b = torch.where(upd, b_new, b)
        t2 = torch.where(upd, t2_new, t2)
        f = torch.where(upd, f_new, f)
        E = [torch.where(upd, en, eo) for en, eo in zip(E_new, E)]
        lam_new = torch.where(accept, lam * _LAM_DOWN, lam * _LAM_UP)
        lam = torch.where(conv, lam, torch.clamp(lam_new, _LAM_MIN, _LAM_MAX))
        nit = nit + upd.to(f.dtype)
        convf = torch.maximum(convf, newly.to(f.dtype))

    params = torch.stack([torch.clamp(torch.sqrt(a), lo_k, hi_k), t2,
                          torch.clamp(torch.sqrt(b), lo_sg, hi_sg)])
    return params, torch.stack([f, convf, nit])


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
        third = _interp_start_gr(s, tab, lo_f, hi_f, n_bisect=16)
    else:
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


# ------------------------------------------------------------- CUDA kernels
def _check_params(params: np.ndarray, n_floats: int, what: str) -> None:
    if params.size != n_floats:
        raise RuntimeError(f"{what} parameter layout differs between "
                           "fused_fit.py and its CUDA source")


def _worklist(n_rows: int, n: int, dev):
    """Device scratch of a split fit kernel: ``n_rows`` x ``n`` floats of
    worklist (one slot per voxel that may still run after the head) and
    its two counters (pushed, handed out), zeroed. The kernels allocate
    nothing themselves."""
    rows = torch.empty(n_rows * n, dtype=torch.float32, device=dev)
    return rows, torch.zeros(2, dtype=torch.int32, device=dev)


def _gauss_fit_cuda(signal: torch.Tensor, te, lo, hi, *, max_iters: int,
                    ftol: float, gtol: float, no_prior: bool,
                    full_budget: bool, stall_iters: int, stall_tol: float):
    """Launch csrc/gauss_fit.cu (its head and tail kernels; one pass with
    full_budget) on ``signal``'s device and stream; same outputs as
    ``_gauss_fit_plain``."""
    global KERNEL_LAUNCHES
    lib = build.load_lib("gauss_fit")
    n, T = signal.shape
    params = _kernel_params(te, lo, hi, ftol, gtol, stall_tol)
    _check_params(params, lib.ft2_gauss_params_floats(), "GaussParams")
    dev = signal.device
    out = torch.empty((3, n), dtype=torch.float32, device=dev)   # k, t2, f
    conv = torch.empty(n, dtype=torch.uint8, device=dev)
    nit = torch.empty(n, dtype=torch.int32, device=dev)
    # the head kernel's worklist for the tail (unused by the full-budget pass)
    rows, counters = _worklist(0 if full_budget else lib.ft2_gauss_slot_rows(T), n, dev)
    with torch.cuda.device(dev):
        err = lib.ft2_gauss_fit(
            signal.data_ptr(), n, T, params.ctypes.data, int(max_iters),
            int(stall_iters), int(no_prior), int(full_budget),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            conv.data_ptr(), nit.data_ptr(), rows.data_ptr(), counters.data_ptr(),
            build.stream(dev))
    build.check_launch(err, "gauss_fit")
    KERNEL_LAUNCHES += 1
    return out[0], out[1], out[2], conv.view(torch.bool), nit


def _gr_varpro_fit_cuda(signal: torch.Tensor, te, lo, hi, guess, *,
                        max_iters: int, ftol: float, gtol: float,
                        full_budget: bool, stall_iters: int, stall_tol: float):
    """Launch csrc/gr_varpro_fit.cu (its head and tail kernels; one pass
    with full_budget); same outputs as the plain version."""
    global GR_VARPRO_LAUNCHES
    lib = build.load_lib("gr_varpro_fit")
    n, T = signal.shape
    params = _gr_kernel_params(te, lo, hi, guess, ftol, gtol, stall_tol)
    _check_params(params, lib.ft2_gr_params_floats(), "GrParams")
    dev = signal.device
    out = torch.empty((2, 3, n), dtype=torch.float32, device=dev)
    # the head kernel's worklist for the tail (unused by the full-budget pass)
    rows, counters = _worklist(0 if full_budget else lib.ft2_gr_slot_rows(T), n, dev)
    with torch.cuda.device(dev):
        err = lib.ft2_gr_varpro_fit(
            signal.data_ptr(), n, T, params.ctypes.data, int(max_iters),
            int(stall_iters), int(full_budget), out[0].data_ptr(),
            out[1].data_ptr(), rows.data_ptr(), counters.data_ptr(), build.stream(dev))
    build.check_launch(err, "gr_varpro_fit")
    GR_VARPRO_LAUNCHES += 1
    return out[0], out[1]


def _fit3_cuda(signal: torch.Tensor, model: str, te, lo, hi, guess, *,
               max_iters: int, ftol: float, gtol: float, stall_tol: float):
    """Launch ft2_fit3_multistart (csrc/fit3.cu)."""
    global FIT3_LAUNCHES
    lib = build.load_lib("fit3")
    n, T = signal.shape
    params = _fit3_kernel_params(te, lo, hi, guess, ftol, gtol, stall_tol)
    _check_params(params, lib.ft2_fit3_params_floats(), "Fit3Params")
    dev = signal.device
    out = torch.empty((2, 3, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ft2_fit3_multistart(
            signal.data_ptr(), n, T, _MODEL_ID[model], params.ctypes.data,
            int(max_iters), out[0].data_ptr(), out[1].data_ptr(), build.stream(dev))
    build.check_launch(err, "fit3")
    FIT3_LAUNCHES += 1
    return out[0], out[1]


def _fit3_cont_cuda(signal: torch.Tensor, model: str, te, lo, hi, guess,
                    x0: torch.Tensor, st0: torch.Tensor, *, max_iters: int,
                    ftol: float, gtol: float, stall_tol: float):
    """Launch ft2_fit3_cont (csrc/fit3.cu: its sweep and tail kernels)."""
    global FIT3_CONT_LAUNCHES
    lib = build.load_lib("fit3")
    n, T = signal.shape
    for name, t in (("x0", x0), ("st0", st0)):
        if t.shape != (3, n) or t.dtype != torch.float32 or t.device != signal.device:
            raise ValueError(f"{name} must be (3, {n}) float32 on {signal.device}")
    x0, st0 = x0.contiguous(), st0.contiguous()
    params = _fit3_kernel_params(te, lo, hi, guess, ftol, gtol, stall_tol)
    _check_params(params, lib.ft2_fit3_params_floats(), "Fit3Params")
    dev = signal.device
    out = torch.empty((2, 3, n), dtype=torch.float32, device=dev)
    rows, counters = _worklist(lib.ft2_fit3_cont_slot_rows(), n, dev)
    with torch.cuda.device(dev):
        err = lib.ft2_fit3_cont(
            signal.data_ptr(), n, T, _MODEL_ID[model], params.ctypes.data,
            int(max_iters), x0.data_ptr(), st0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), rows.data_ptr(), counters.data_ptr(), build.stream(dev))
    build.check_launch(err, "fit3_cont")
    FIT3_CONT_LAUNCHES += 1
    return out[0], out[1]


def _check_signal(signal: torch.Tensor, te) -> None:
    if signal.dtype != torch.float32 or signal.dim() != 2:
        raise ValueError(f"signal must be (N, T) float32, got "
                         f"{tuple(signal.shape)} {signal.dtype}")
    n, T = signal.shape
    if T != len(te) or not 2 <= T <= _MAX_TE:
        raise ValueError(f"the fit takes 2..{_MAX_TE} echoes matching te; "
                         f"got signal T={T}, len(te)={len(te)}")
    if n == 0:
        raise ValueError("empty batch: nothing to fit")
    if signal.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {signal.device}")


def _pick(signal: torch.Tensor, te, cuda_fn, plain_fn):
    """(function, signal): the kernel for a CUDA tensor, the plain version
    for a CPU one, after checking what both take."""
    _check_signal(signal, te)
    if signal.device.type == "cuda":
        return cuda_fn, signal.contiguous()
    return plain_fn, signal


def _gauss_fit(signal: torch.Tensor, te, lo, hi, **kw):
    """The gaussian fit on ``signal``'s device (kernel or plain version)."""
    fn, signal = _pick(signal, te, _gauss_fit_cuda, _gauss_fit_plain)
    return fn(signal, te, lo, hi, **kw)


def _gr_varpro_fit(signal: torch.Tensor, te, lo, hi, guess, **kw):
    """The gaussian_rician VARPRO fit on ``signal``'s device."""
    fn, signal = _pick(signal, te, _gr_varpro_fit_cuda, _gr_varpro_fit_plain)
    return fn(signal, te, lo, hi, guess, **kw)


def _fit3(signal: torch.Tensor, model, te, lo, hi, guess, **kw):
    """The 3-start multistart on ``signal``'s device."""
    fn, signal = _pick(signal, te, _fit3_cuda, _fit3_plain)
    return fn(signal, model, te, lo, hi, guess, **kw)


def _fit3_cont(signal: torch.Tensor, model, te, lo, hi, guess, x0, st0, **kw):
    """The multistart continuation on ``signal``'s device."""
    fn, signal = _pick(signal, te, _fit3_cont_cuda, _fit3_cont_plain)
    return fn(signal, model, te, lo, hi, guess, x0, st0, **kw)


def _fit3_pruned(signal: torch.Tensor, model, te, lo, hi, guess, *,
                 prefix_iters: int, max_iters: int, **kw):
    """Prefix-pruned multistart (pallas_fit._fit3_tiles_pruned): all 3
    starts run ``prefix_iters`` iterations, the per-voxel winner is kept,
    and one continuation resumes it for the remaining budget. Two
    launches: the continuation restarts lam and the stall counter, so
    fusing the two loops would change results."""
    params1, stats1 = _fit3(signal, model, te, lo, hi, guess,
                            max_iters=prefix_iters, **kw)
    return _fit3_cont(signal, model, te, lo, hi, guess, params1, stats1,
                      max_iters=max_iters - prefix_iters, **kw)


def fit_fused(signal, te, lo, hi, *, model: str = "gaussian", guess=None,
              max_iters: int = 60, ftol: float = 1e-9, gtol: float = 0.0,
              no_prior: bool = False, strategy: str = "auto",
              full_budget: bool = False, prefix3=None, varpro3=None,
              sync: bool = True, device="cuda") -> FitResult:
    """Fused fit of every voxel in the batch.

    Args:
        signal: (N, T) float32 voxel signals (numpy or tensor); moved to
            ``device`` if it is not there (a tensor already there is used
            as is).
        te: (T,) echo times (ms), ascending (no_prior reads the first echo).
        lo, hi: scalar per-parameter bounds: (k, T2) for 'gaussian',
            (k, T2, sigma) for 'gaussian_rician' and 'rician'.
        model: 'gaussian' (VARPRO in T2), 'gaussian_rician' (VARPRO in T2
            over an exact (k^2, sigma^2) profile, or the 3-start multistart
            with varpro3=False) or 'rician' (the 3-start multistart, prefix-
            pruned by default).
        guess: protocol initial parameters of the 3-parameter fits (the
            multistart's third start, the interpolant's fallback, the
            VARPRO sigma start); defaults to the bound midpoint.
        max_iters: per-voxel iteration budget.
        ftol, gtol: stopping tolerances (gtol 0 disables the gradient test).
        no_prior: gaussian only — per-voxel k lower bound = the voxel's
            signal at the shortest TE (reference run_t2mapping.py:243-245);
            pass the scalar no-prior box in lo/hi (k upper 10000, T2 10..2000).
        strategy: 'single' or 'auto' (see resolve_strategy: always one
            call; the kernels compact their own stragglers); 'twophase'
            raises.
        full_budget: gaussian and VARPRO only — run every voxel to
            ``max_iters`` instead of stopping it once converged (a
            measurement instrument; results are identical).
        prefix3: multistart prefix (see resolve_prefix3): all 3 starts run
            this many iterations, then only each voxel's best start goes on.
            None = FT2_FIT3_PREFIX or 4; 0 = every start runs the full budget.
        varpro3: gaussian_rician only — the VARPRO kernel (see
            resolve_varpro3). None = FT2_FIT3_VARPRO or on.
        sync: wait for the device before returning.
        device: 'cuda' (default) runs the CUDA kernels, 'cpu' the plain
            versions.

    Returns:
        FitResult with x (N, P), fun, converged (bool), n_iter (int32) and
        n_overflow = 0.
    """
    te_t, lo_t, hi_t, guess_t = validate_fused_args(model, te, lo, hi, guess,
                                                    no_prior)
    prefix3 = resolve_prefix3(prefix3, max_iters)
    varpro3 = resolve_varpro3(varpro3, model)
    resolve_strategy(strategy)
    dev = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32, device=dev)
    kw = dict(max_iters=int(max_iters), ftol=float(ftol), gtol=float(gtol))
    if model == "gaussian":
        k, t2, f, conv, nit = _gauss_fit(
            signal, te_t, lo_t, hi_t, no_prior=bool(no_prior),
            full_budget=bool(full_budget), stall_iters=_STALL_ITERS,
            stall_tol=max(float(ftol), 1e-3), **kw)
        x, stats = torch.stack([k, t2], dim=1), None
    elif varpro3:
        params, stats = _gr_varpro_fit(
            signal, te_t, lo_t, hi_t, guess_t, full_budget=bool(full_budget),
            stall_iters=_STALL_ITERS, stall_tol=max(float(ftol), 1e-3), **kw)
    else:
        kw["stall_tol"] = max(float(ftol), 1e-6)
        if prefix3:
            params, stats = _fit3_pruned(signal, model, te_t, lo_t, hi_t, guess_t,
                                         prefix_iters=prefix3, **kw)
        else:
            params, stats = _fit3(signal, model, te_t, lo_t, hi_t, guess_t, **kw)
    if stats is not None:
        x, f = params.t(), stats[0]
        conv, nit = stats[1] > 0.5, stats[2].to(torch.int32)
    if sync and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return FitResult(x=x, fun=f, converged=conv, n_iter=nit, n_overflow=0)
