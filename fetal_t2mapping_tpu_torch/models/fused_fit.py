"""Fused gaussian voxel fit: the counterpart of ``pallas_fit.fit_fused``.

The whole fit of a voxel — weighted log-linear init, a 12-point T2 grid
scan, and the VARPRO damped-Newton loop — runs in one pass, touching
device memory once per voxel (signal in, results out). On a CUDA tensor
it is the hand-written kernel ``csrc/gauss_fit.cu`` (one thread per
voxel); on a CPU tensor it is ``_gauss_fit_plain``, the same algorithm in
plain PyTorch, vectorised over voxels. The choice follows the tensor's
device only: there is no fallback from the kernel to the plain version.

Both follow ``pallas_fit._gauss_kernel_body`` op for op — the same
left-to-right sums over echoes, the same float32 constants (the grid-scan
table is built on the host in float64 and rounded, as the reference's
Python floats are), NaN-propagating clips — so they agree with the
reference to float32 rounding, and converged voxels freeze, so results do
not depend on how voxels are grouped.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .signal import require_gaussian
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
_STALL_ITERS = 3
_MAX_TE = 8          # the kernel is instantiated for 2..8 echoes

#: launches of the CUDA fit kernel in this process (the wrapper adds one
#: per launch; the plain version never touches it)
KERNEL_LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG_DIR, "csrc", "gauss_fit.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libgauss_fit.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: the kernel then rounds op by op like the
              # plain version and the reference (see the note in the source)
              "-fmad=false")


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


# ------------------------------------------------------------ host constants
def _grid_table(te: Tuple[float, ...], lo_t2: float, hi_t2: float):
    """The grid scan's static candidates, computed in float64 exactly as the
    reference's Python floats and rounded to float32: (t2_g (G,), ee_g (G,),
    e_g (G, T)). Computing them in float32 on the device could flip basin
    choices."""
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


# ----------------------------------------------------------- plain version
def _fold(terms):
    """Left-to-right sum (the reference's Python ``sum`` over echoes)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _gauss_fit_plain(signal: torch.Tensor, te, lo, hi, *, max_iters: int,
                     ftol: float, gtol: float, no_prior: bool,
                     full_budget: bool, stall_iters: int, stall_tol: float):
    """Plain PyTorch version of the fit kernel, vectorised over voxels:
    (N, T) float32 -> (k, t2, f, converged (bool), n_iter (int32)), each (N,).

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
    te_f = [float(np.float32(t)) for t in te]

    def clip_k(x):
        return torch.clamp(x, lo_k, hi_k)

    def exps_at(t2v):
        u = -1.0 / t2v
        return [torch.exp(u * t) for t in te_f]

    def sse(kv, es):
        return _fold([torch.square(st - kv * et) for st, et in zip(s, es)]) * inv_t

    # weighted log-linear init (pallas_fit._loglin_tiles)
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
    k = clip_k(k)
    t2 = torch.clamp(t2, lo_t2, hi_t2)
    e = exps_at(t2)
    f = sse(k, e)

    # 12-point T2 grid scan (basin selection); the divisor is a device
    # tensor so that it is a true division on every backend
    grid_t2, grid_ee, grid_e = _grid_table(te, lo_t2, hi_t2)
    for g in range(_N_GRID):
        e_g = [float(v) for v in grid_e[g]]
        ee = torch.tensor(grid_ee[g], dtype=torch.float32, device=dev)
        k_g = clip_k(_fold([st * ei for st, ei in zip(s, e_g)]) / ee)
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

        accept = f_new <= f
        rel_red = (f - f_new) / torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0)
        conv_f = accept & (rel_red <= ftol) & (lam <= 1.0)
        step_sq = torch.square(k_new - k) + torch.square(t2_new - t2)
        conv_x = step_sq <= (1.0 + torch.square(k) + torch.square(t2)) * (
            _XTOL_REL * _XTOL_REL)
        newly = conv_f | conv_x | (lam >= _LAM_STALL)
        if gtol > 0:
            g_k = _fold([rt * et for rt, et in zip(r, e)]) * cm2
            pg_k = torch.where(k <= k_lo_thr, torch.minimum(g_k, zero),
                               torch.where(k >= k_hi_thr, torch.maximum(g_k, zero), g_k))
            pg_t = torch.where(t2 <= t2_lo_thr, torch.minimum(g_t, zero),
                               torch.where(t2 >= t2_hi_thr, torch.maximum(g_t, zero), g_t))
            newly = newly | (torch.maximum(torch.abs(pg_k), torch.abs(pg_t)) <= gtol)
        newly = newly & ~conv
        if stall_iters > 0:
            # scipy-ftol-style stop: ``stall_iters`` accepted-but-slow steps
            # in a row declare convergence (rejected trials are neutral)
            slow_acc = accept & (rel_red <= stall_tol) & ~conv
            real_prog = accept & (rel_red > stall_tol)
            scnt = torch.where(conv | real_prog, zero,
                               torch.where(slow_acc, scnt + 1.0, scnt))
            newly = newly | ((scnt >= float(stall_iters)) & ~conv)

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


# ------------------------------------------------------------- CUDA kernel
def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_kernel() -> str:
    """Compile ``csrc/gauss_fit.cu`` with nvcc for sm_90a into ``_build/``
    unless the library is newer than the source; returns the library path.
    A failed build raises; nothing falls back to the plain version."""
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(KERNEL_SOURCE)):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a private name and rename: concurrent builders never
    # load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


@functools.lru_cache(maxsize=None)
def _load_lib():
    lib = ctypes.CDLL(build_kernel())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ft2_gauss_fit.argtypes = [vp, i64, i32, vp, i32, i32, i32, i32,
                                  vp, vp, vp, vp, vp, vp]
    lib.ft2_gauss_fit.restype = i32
    lib.ft2_gauss_params_floats.argtypes = []
    lib.ft2_gauss_params_floats.restype = i32
    return lib


def _kernel_params(te, lo, hi, ftol, gtol, stall_tol) -> np.ndarray:
    """The kernel's ``GaussParams`` struct as a flat float32 array (field
    order as declared in csrc/gauss_fit.cu)."""
    (lo_k, lo_t2), (hi_k, hi_t2) = lo, hi
    tol_k, t2_lo_thr, t2_hi_thr = _scalar_consts(lo, hi)
    te_pad = np.zeros(_MAX_TE, np.float32)
    te_pad[:len(te)] = te
    grid_t2, grid_ee, grid_e = _grid_table(te, lo_t2, hi_t2)
    grid_e_pad = np.zeros((_N_GRID, _MAX_TE), np.float32)
    grid_e_pad[:, :len(te)] = grid_e
    head = np.asarray([lo_k, hi_k, lo_t2, hi_t2, tol_k, t2_lo_thr, t2_hi_thr,
                       ftol, gtol, stall_tol], np.float32)
    return np.concatenate([head, te_pad, grid_t2, grid_ee, grid_e_pad.ravel()])


def _gauss_fit_cuda(signal: torch.Tensor, te, lo, hi, *, max_iters: int,
                    ftol: float, gtol: float, no_prior: bool,
                    full_budget: bool, stall_iters: int, stall_tol: float):
    """Launch the fit kernel on ``signal``'s device and stream; same
    outputs as ``_gauss_fit_plain``."""
    global KERNEL_LAUNCHES
    lib = _load_lib()
    n, T = signal.shape
    params = _kernel_params(te, lo, hi, ftol, gtol, stall_tol)
    if params.size != lib.ft2_gauss_params_floats():
        raise RuntimeError("GaussParams layout differs between "
                           "fused_fit.py and csrc/gauss_fit.cu")
    dev = signal.device
    out = torch.empty((3, n), dtype=torch.float32, device=dev)   # k, t2, f
    conv = torch.empty(n, dtype=torch.uint8, device=dev)
    nit = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ft2_gauss_fit(
            signal.data_ptr(), n, T, params.ctypes.data, int(max_iters),
            int(stall_iters), int(no_prior), int(full_budget),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            conv.data_ptr(), nit.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gauss_fit kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out[0], out[1], out[2], conv.view(torch.bool), nit


def _gauss_fit(signal: torch.Tensor, te, lo, hi, **kw):
    """Dispatch on the tensor's device: the kernel on CUDA, the plain
    version on CPU. Checks what the kernel takes and raises otherwise."""
    if signal.dtype != torch.float32 or signal.dim() != 2:
        raise ValueError(f"signal must be (N, T) float32, got "
                         f"{tuple(signal.shape)} {signal.dtype}")
    n, T = signal.shape
    if T != len(te) or not 2 <= T <= _MAX_TE:
        raise ValueError(f"the fit takes 2..{_MAX_TE} echoes matching te; "
                         f"got signal T={T}, len(te)={len(te)}")
    if n == 0:
        raise ValueError("empty batch: nothing to fit")
    if signal.device.type == "cuda":
        return _gauss_fit_cuda(signal.contiguous(), te, lo, hi, **kw)
    if signal.device.type == "cpu":
        return _gauss_fit_plain(signal, te, lo, hi, **kw)
    raise ValueError(f"unsupported device {signal.device}")


def fit_fused(signal, te, lo, hi, *, model: str = "gaussian", max_iters: int = 60,
              ftol: float = 1e-9, gtol: float = 0.0, no_prior: bool = False,
              strategy: str = "single", full_budget: bool = False,
              sync: bool = True, device="cuda") -> FitResult:
    """Fused fit of every voxel in the batch.

    Args:
        signal: (N, T) float32 voxel signals (numpy or tensor); moved to
            ``device`` if it is not there (a tensor already there is used
            as is).
        te: (T,) echo times (ms), ascending (no_prior reads the first echo).
        lo, hi: scalar per-parameter bounds, (k, T2).
        model: 'gaussian'; the 3-parameter models are validated as in the
            reference and then raise NotImplementedError (not ported yet).
        max_iters: per-voxel iteration budget.
        ftol, gtol: stopping tolerances (gtol 0 disables the gradient test).
        no_prior: per-voxel k lower bound = the voxel's signal at the
            shortest TE (reference run_t2mapping.py:243-245); pass the
            scalar no-prior box in lo/hi (k upper 10000, T2 10..2000).
        strategy: 'single' (or 'auto', which is 'single'): one pass with
            the full budget, each voxel stopping on its own. 'twophase'
            (straggler compaction) is not ported and raises.
        full_budget: run every voxel to ``max_iters`` instead of stopping
            it once converged (a measurement instrument; results are
            identical because converged voxels are frozen).
        sync: wait for the device before returning.
        device: 'cuda' (default) runs the CUDA kernel, 'cpu' the plain
            version.

    Returns:
        FitResult with x (N, 2) = [k, T2], fun, converged (bool),
        n_iter (int32) and n_overflow = 0.
    """
    te_t, lo_t, hi_t, _ = validate_fused_args(model, te, lo, hi, None, no_prior)
    require_gaussian(model)
    if strategy == "twophase":
        raise NotImplementedError(
            "strategy 'twophase' (straggler compaction) is not ported: each "
            "GPU thread stops on its own, see ROADMAP Queue 1 item 3")
    if strategy not in ("single", "auto"):
        raise ValueError(f"unknown strategy {strategy!r}")
    dev = resolve_device(device)
    signal = torch.as_tensor(signal, dtype=torch.float32, device=dev)
    k, t2, f, conv, nit = _gauss_fit(
        signal, te_t, lo_t, hi_t, max_iters=int(max_iters), ftol=float(ftol),
        gtol=float(gtol), no_prior=bool(no_prior), full_budget=bool(full_budget),
        stall_iters=_STALL_ITERS, stall_tol=max(float(ftol), 1e-3))
    if sync and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return FitResult(x=torch.stack([k, t2], dim=1), fun=f, converged=conv,
                     n_iter=nit, n_overflow=0)
