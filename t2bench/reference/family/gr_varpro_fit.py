"""The plain fit of ``csrc/gr_varpro_fit.cu``: the gaussian_rician model's
VARPRO fit of (k, T2, sigma) in the configuration's prior box, mean SSE of
s against sqrt(k^2 exp(-2 te / T2) + sigma^2) (Gudbjartsson & Patz 1995).

Frozen copy of ``fetal_t2mapping_tpu_torch/models/fused_fit.py`` at commit
f52ecbc: ``_interp_table``, ``_gr_tables``, ``_interp_start_gr`` and
``_gr_varpro_fit_plain``, with ``_N_INTERP``, unchanged. The helpers and
constants they read that ``fits.py`` froze at 69168b9 (``_fold``, ``_fl``,
``_loglin_tiles``, ``_stop_tests``, ``_proj_grad``, the damping constants,
``_N_GRID``) and ``objectives.rdiv`` are identical at f52ecbc, so they are
imported. ``fit_block`` calls the fit as the program's ``_fit_pass`` does.
Elementwise float operations only: no matrix product, so TF32 cannot
reach it. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .. import fit_args
from ..fits import (_LAM0, _LAM_DOWN, _LAM_MAX, _LAM_MIN, _LAM_UP, _N_GRID, _fl, _fold,
                    _loglin_tiles, _proj_grad, _stop_tests)
from ..objectives import rdiv

_N_INTERP = 16       # the interpolant's static bracket grid


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


def fit_block(config: dict, s: torch.Tensor) -> Dict[str, torch.Tensor]:
    if config["model"] != "gaussian_rician" or not config.get("varpro3", 0):
        raise ValueError("the gr_varpro_fit family fits the gaussian_rician model with "
                         f"varpro3 on, not {config['model']!r}, varpro3 {config.get('varpro3')}")
    te, lo, hi, guess = fit_args(config)
    ftol, gtol, budget = float(config["ftol"]), float(config["gtol"]), int(config["max_iters"])
    x, st = _gr_varpro_fit_plain(
        s, te, lo, hi, guess, max_iters=budget, ftol=ftol, gtol=gtol, full_budget=False,
        stall_iters=3, stall_tol=max(ftol, 1e-3))
    nit = st[2].to(torch.int32)
    return {"k": x[0], "t2": x[1], "sigma": x[2], "fun": st[0], "converged": st[1] > 0.5,
            "n_iter": nit, "steps.gr_varpro_fit": nit.double().sum()}
