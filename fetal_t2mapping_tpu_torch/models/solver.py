"""Batched box-constrained damped-Newton voxel fit (PyTorch).

The counterpart of ``fetal_t2mapping_tpu.models.solver``: every voxel is an
independent 2- or 3-parameter minimization, and all voxels iterate together
as (N, ...) tensors — gradient + Hessian (hand-fused for gaussian, autodiff
for the 3-parameter models), a projected (active-set) Newton step with
Levenberg-Marquardt damping, a closed-form 2x2/3x3 solve and bounds by
clipping. Converged voxels are frozen, so per-voxel results do not depend
on the batch they run in.

``models.t2map.fit_stack`` draws its sampled convergence traces from
``fit_batch_traced``, runs no-prior 3-parameter configurations through
``fit_batch_multistart`` and configurations that start from the protocol
guess (``loglinear_init=False``) through ``fit_batch_twophase``; every
other full-volume fit goes through ``models.fused_fit``.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Union

import torch

from .. import graphs
from .signal import make_objective, make_value_grad_hess

_LAM0 = 1e-3
_LAM_UP = 5.0
_LAM_DOWN = 0.2
_LAM_MIN = 1e-12
_LAM_MAX = 1e10
_LAM_STALL = 1e6  # damping this high means no fp32-visible descent remains: stop
_XTOL_REL = 1e-6  # accepted-step size (relative to |x|) that counts as converged


class FitResult(NamedTuple):
    x: torch.Tensor          # (N, P) final parameters (last iterate if unconverged)
    fun: torch.Tensor        # (N,) final objective value
    converged: torch.Tensor  # (N,) bool
    n_iter: torch.Tensor     # (N,) int32 accepted-step count
    # unconverged voxels denied a refit slot: a () int32 tensor from
    # fit_batch_twophase, 0 on the fused single-pass paths, where every
    # voxel gets the full budget, None elsewhere
    n_overflow: Optional[Union[int, torch.Tensor]] = None


def _solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form solve of (N, P, P) systems A x = b, b (N, P), P in {2, 3}
    (the reference's ``_solve_posdef_small``: Cramer via the adjugate)."""
    def guard(det):
        return torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)

    if A.shape[-1] == 2:
        a, c = A[:, 0, 0], A[:, 0, 1]
        d, c10 = A[:, 1, 1], A[:, 1, 0]
        det = guard(a * d - c * c10)
        x0 = (d * b[:, 0] - c * b[:, 1]) / det
        x1 = (a * b[:, 1] - c10 * b[:, 0]) / det
        return torch.stack([x0, x1], dim=-1)
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = (
        [A[:, i, j] for j in range(3)] for i in range(3))
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = guard(a00 * c00 + a01 * c01 + a02 * c02)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def _step(fgh, obj, x, f, lam, conv, n_iter, te, signal, lo, hi, ftol, gtol):
    """One damped projected-Newton update of every voxel (the JAX package's
    ``_make_voxel_step``, batched). Returns the new state + step norms."""
    _, g, H = fgh(x, te, signal)

    tol_b = 1e-8 * torch.clamp(hi - lo, min=1.0)
    at_lo = x <= lo + tol_b
    at_hi = x >= hi - tol_b
    # KKT-active coordinates: pinned at a bound, gradient pointing outward
    free = ~((at_lo & (g > 0)) | (at_hi & (g < 0)))
    fm = free.to(x.dtype)

    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    # reduced system: identity rows/cols for pinned coords
    outer = fm[:, :, None] * fm[:, None, :]
    Hr = H * outer + eye * (1.0 - fm)[:, None, :]
    gr = g * fm

    diag = torch.abs(torch.diagonal(Hr, dim1=-2, dim2=-1))
    Hd = Hr + eye * (lam[:, None] * torch.clamp(diag, min=1e-12))[:, None, :]
    p = -_solve_small(Hd, gr) * fm
    x_new = torch.minimum(torch.maximum(x + p, lo), hi)
    f_new = obj(x_new, te, signal)

    accept = f_new <= f  # non-strict; NaN-safe (NaN <= f is False)
    # L-BFGS-B-style relative reduction test
    rel_red = (f - f_new) / torch.clamp(torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0)
    conv_f = accept & (rel_red <= ftol) & (lam <= 1.0)
    # a vanishing attempted step — accepted or not — counts as converged
    step_sq = torch.sum(torch.square(x_new - x), dim=-1)
    conv_x = step_sq <= _XTOL_REL ** 2 * (1.0 + torch.sum(torch.square(x), dim=-1))
    newly = conv_f | conv_x | (lam >= _LAM_STALL)
    if gtol > 0:
        zero = torch.zeros_like(g)
        pg = torch.where(at_lo, torch.minimum(g, zero),
                         torch.where(at_hi, torch.maximum(g, zero), g))
        newly = newly | (torch.amax(torch.abs(pg), dim=-1) <= gtol)
    newly = newly & ~conv

    upd = accept & ~conv
    x_out = torch.where(upd[:, None], x_new, x)
    f_out = torch.where(upd, f_new, f)
    lam_new = torch.where(accept, lam * _LAM_DOWN, lam * _LAM_UP)
    lam_out = torch.where(conv, lam, torch.clamp(lam_new, _LAM_MIN, _LAM_MAX))
    n_out = n_iter + upd.to(torch.int32)
    step_norm = torch.where(upd, torch.linalg.vector_norm(x_new - x, dim=-1),
                            torch.zeros_like(f))
    return x_out, f_out, lam_out, conv | newly, n_out, step_norm


def _prep(signal, te, x0, lo, hi):
    signal = torch.as_tensor(signal, dtype=torch.float32)
    dev = signal.device
    te = torch.as_tensor(te, dtype=torch.float32, device=dev)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    n, p = x0.shape
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev).expand(n, p)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev).expand(n, p)
    lam = torch.full((n,), _LAM0, dtype=torch.float32, device=dev)
    conv = torch.zeros(n, dtype=torch.bool, device=dev)
    nit = torch.zeros(n, dtype=torch.int32, device=dev)
    return signal, te, x0, lo, hi, lam, conv, nit


def fit_batch(signal, te, x0, lo, hi, *, model: str, max_iters: int = 60,
              ftol: float = 1e-9, gtol: float = 0.0) -> FitResult:
    """Fit every voxel in the batch, on ``signal``'s device.

    On the CPU as the eager loop (``_fit_batch_loop``, the plain version);
    on a CUDA tensor as one step captured as a CUDA graph and replayed per
    iteration (``_fit_batch_steps``; the reference's ``lax.while_loop``),
    with the same results: the host reads "every voxel converged" every
    ``_CHECK_EVERY`` iterations, and the steps run past a stop change
    nothing (a converged voxel is frozen).

    Args:
        signal: (N, T) measured intensities (a tensor fixes the device).
        te: (T,) echo times (ms).
        x0: (N, P) initial parameters (see init.loglinear_init).
        lo, hi: (P,) or (N, P) box constraints.
        model: 'gaussian' | 'gaussian_rician' | 'rician'.
        max_iters: iteration cap (stops early once every voxel converged).
        ftol/gtol: per-voxel stopping tolerances.
    """
    kw = dict(model=model, max_iters=max_iters, ftol=ftol, gtol=gtol)
    if torch.is_tensor(signal) and signal.device.type == "cuda":
        return _fit_batch_steps(signal, te, x0, lo, hi, graph=True, **kw)
    return _fit_batch_loop(signal, te, x0, lo, hi, **kw)


def _fit_batch_loop(signal, te, x0, lo, hi, *, model, max_iters, ftol, gtol) -> FitResult:
    """fit_batch as an eager Python loop over ``_step``, the stop read
    every iteration."""
    obj, fgh = make_objective(model), make_value_grad_hess(model)
    signal, te, x, lo, hi, lam, conv, nit = _prep(signal, te, x0, lo, hi)
    f = obj(x, te, signal)
    for _ in range(max_iters):
        if bool(conv.all()):
            break
        x, f, lam, conv, nit, _ = _step(fgh, obj, x, f, lam, conv, nit, te,
                                        signal, lo, hi, ftol, gtol)
    return FitResult(x=x, fun=f, converged=conv, n_iter=nit)


# fit_batch's in-place steps read "every voxel converged" from the device
# this often: a step leaves converged voxels unchanged, so the steps run
# between a stop and its read change nothing
_CHECK_EVERY = 10


def _batch_step(b, fgh, obj, ftol, gtol):
    """One ``_step`` on the buffers ``b``, in place, the iteration counter
    ``b["it"]`` on the device: the step reads nothing from the host."""
    x, f, lam, conv, nit, _ = _step(fgh, obj, b["x"], b["f"], b["lam"], b["conv"], b["nit"],
                                    b["te"], b["signal"], b["lo"], b["hi"], ftol, gtol)
    for name, new in (("x", x), ("f", f), ("lam", lam), ("conv", conv), ("nit", nit)):
        b[name].copy_(new)
    b["it"].add_(1)


def _fit_batch_steps(signal, te, x0, lo, hi, *, model, max_iters, ftol, gtol,
                     graph) -> FitResult:
    """fit_batch through the in-place ``_batch_step``: driven eagerly
    (``graph=False``), or on the card captured once as a CUDA graph (the
    first iteration runs eagerly as the capture's warm-up) and replayed
    for every further iteration. The host reads ``conv.all()`` before
    iterations 0, 10, 20, ... (``graphs.read``)."""
    obj, fgh = make_objective(model), make_value_grad_hess(model)
    signal, te, x0, lo, hi, lam, conv, nit = _prep(signal, te, x0, lo, hi)
    b = dict(signal=signal, te=te, lo=lo, hi=hi, x=x0.clone(), f=obj(x0, te, signal), lam=lam,
             conv=conv, nit=nit, it=torch.zeros((), dtype=torch.int64, device=signal.device))

    def step():
        _batch_step(b, fgh, obj, ftol, gtol)

    run = graphs.stepper(step, signal.device, graph)
    for i in range(max_iters):
        if i % _CHECK_EVERY == 0 and graphs.read(b["conv"].all()):
            break
        run()
    return FitResult(x=b["x"], fun=b["f"], converged=b["conv"], n_iter=b["nit"])


def _tail_partition(conv: torch.Tensor, capacity: int):
    """Stable partition on the device, no host sync: indices of up to
    ``capacity`` unconverged voxels, unconverged first (a stable sort of the
    converged flags). Returns (tail_idx (capacity,) int64, n_tail () int32).
    Slots past n_tail point at converged voxels (or, where capacity > N, at
    voxel 0); callers mask them with n_tail."""
    order = torch.argsort(conv.to(torch.int32), stable=True)
    if capacity > order.shape[0]:
        order = torch.nn.functional.pad(order, (0, capacity - order.shape[0]))
    return order[:capacity], torch.sum(~conv, dtype=torch.int32)


def fit_batch_twophase(signal, te, x0, lo, hi, *, model: str, phase1_iters: int = 12,
                       max_iters: int = 60, ftol: float = 1e-9, gtol: float = 0.0,
                       tail_frac: float = 0.0625) -> FitResult:
    """Two-phase fit (the reference's ``fit_batch_twophase``): a short
    lock-step pass over every voxel, then a refit of the unconverged tail.

    Phase 1 runs ``phase1_iters`` iterations from ``x0``. Up to
    ``tail_frac`` of N unconverged voxels (a multiple of 128, at least 128,
    at most N) are gathered, unconverged first in a stable order, and
    refit from phase 1's x for the rest of the budget, with lambda
    restarted. Their x, objective and flag are replaced and their
    accepted steps added; voxels beyond that capacity keep phase 1's
    result and are counted in ``n_overflow`` (a () int32 tensor). Runs on
    ``signal``'s device."""
    signal, te, x0, lo, hi, *_ = _prep(signal, te, x0, lo, hi)
    n = x0.shape[0]
    r1 = fit_batch(signal, te, x0, lo, hi, model=model, max_iters=phase1_iters,
                   ftol=ftol, gtol=gtol)
    capacity = min(n, max(128, int(n * tail_frac) // 128 * 128))
    tail_idx, n_tail = _tail_partition(r1.converged, capacity)
    r2 = fit_batch(signal[tail_idx], te, r1.x[tail_idx], lo[tail_idx], hi[tail_idx],
                   model=model, max_iters=max(max_iters - phase1_iters, 0),
                   ftol=ftol, gtol=gtol)

    # merge: slots at or past n_tail go to a spare row n, dropped after
    valid = torch.arange(capacity, device=signal.device) < n_tail
    safe_idx = torch.where(valid, tail_idx, torch.full_like(tail_idx, n))

    def merged(a, b, accumulate=False):
        out = torch.cat([a, a[:1]])
        out.index_put_((safe_idx,), b, accumulate=accumulate)
        return out[:n]

    return FitResult(x=merged(r1.x, r2.x), fun=merged(r1.fun, r2.fun),
                     converged=merged(r1.converged, r2.converged),
                     n_iter=merged(r1.n_iter, r2.n_iter, accumulate=True),
                     n_overflow=torch.clamp(n_tail - capacity, min=0))


def fit_batch_multistart(signal, te, x0s, lo, hi, *, model: str,
                         max_iters: int = 60, ftol: float = 1e-9,
                         gtol: float = 0.0) -> FitResult:
    """fit_batch from S starting points per voxel; keep the best minimum.

    The 3-parameter objectives are non-convex: a single start can converge
    to a poorer local minimum. The starts are folded into the batch axis
    (one solver run of S*N rows), then a per-voxel argmin over the final
    objective values picks the result.

    Args:
        x0s: (S, N, P) starting points.
    """
    signal = torch.as_tensor(signal, dtype=torch.float32)
    x0s = torch.as_tensor(x0s, dtype=torch.float32, device=signal.device)
    s_starts, n, p = x0s.shape
    lo = torch.as_tensor(lo, dtype=torch.float32, device=signal.device).expand(n, p)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=signal.device).expand(n, p)
    rep = lambda a: a.repeat((s_starts,) + (1,) * (a.dim() - 1))   # noqa: E731
    res = fit_batch(rep(signal), te, x0s.reshape(s_starts * n, p), rep(lo), rep(hi),
                    model=model, max_iters=max_iters, ftol=ftol, gtol=gtol)
    best = torch.argmin(res.fun.reshape(s_starts, n), dim=0)
    rows = best * n + torch.arange(n, device=signal.device)
    return FitResult(x=res.x[rows], fun=res.fun[rows],
                     converged=res.converged[rows], n_iter=res.n_iter[rows])


def fit_batch_traced(signal, te, x0, lo, hi, *, model: str, max_iters: int = 60,
                     ftol: float = 1e-9, gtol: float = 0.0):
    """Like fit_batch but records per-iteration convergence traces.

    Intended for a small sampled voxel subset (the reference records
    f_val/step_size per iteration via an L-BFGS-B callback). Runs exactly
    ``max_iters`` iterations on ``signal``'s device: on the CPU as the
    eager loop (``_fit_batch_traced_loop``, the plain version); on a CUDA
    tensor as one step captured as a CUDA graph and replayed per iteration
    (``_fit_batch_traced_steps``; the reference's ``lax.scan``), with the
    same results. The graph and its buffers are kept for later calls of
    the same model, shapes, budget, tolerances and device.

    Returns:
        (FitResult, traces) where traces is a dict of (iters, N) tensors:
        'f_val', 'step_size' and 'active' (bool; False once the voxel has
        converged).
    """
    if torch.is_tensor(signal) and signal.device.type == "cuda":
        return _fit_batch_traced_steps(signal, te, x0, lo, hi, model=model,
                                       max_iters=max_iters, ftol=ftol, gtol=gtol, graph=True)
    return _fit_batch_traced_loop(signal, te, x0, lo, hi, model=model, max_iters=max_iters,
                                  ftol=ftol, gtol=gtol)


def _fit_batch_traced_loop(signal, te, x0, lo, hi, *, model, max_iters, ftol, gtol):
    """fit_batch_traced as an eager Python loop over ``_step``."""
    obj, fgh = make_objective(model), make_value_grad_hess(model)
    signal, te, x, lo, hi, lam, conv, nit = _prep(signal, te, x0, lo, hi)
    f = obj(x, te, signal)
    f_val, step_size, active = [], [], []
    for _ in range(max_iters):
        active.append(~conv)
        x, f, lam, conv, nit, step_norm = _step(fgh, obj, x, f, lam, conv, nit,
                                                te, signal, lo, hi, ftol, gtol)
        f_val.append(f)
        step_size.append(step_norm)
    traces = {"f_val": torch.stack(f_val), "step_size": torch.stack(step_size),
              "active": torch.stack(active)}
    return FitResult(x=x, fun=f, converged=conv, n_iter=nit), traces


# the trace sampler's CUDA graphs and their buffers, by (model, N, T, P,
# iterations, ftol, gtol, device); a call holds the lock from its inputs'
# copy to its outputs' clone
_TRACE_GRAPHS: dict = {}
_TRACE_GRAPHS_MAX = 16
_TRACE_LOCK = threading.Lock()


def _trace_buffers(n, t, p, iters, dev):
    """The traced loop's state and inputs, preallocated for in-place steps."""
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        signal=torch.empty((n, t), **f32), te=torch.empty((t,), **f32),
        lo=torch.empty((n, p), **f32), hi=torch.empty((n, p), **f32),
        x=torch.empty((n, p), **f32), f=torch.empty((n,), **f32), lam=torch.empty((n,), **f32),
        conv=torch.empty((n,), dtype=torch.bool, device=dev),
        nit=torch.empty((n,), dtype=torch.int32, device=dev),
        it=torch.empty((), dtype=torch.int64, device=dev),
        f_val=torch.zeros((iters, n), **f32), step_size=torch.zeros((iters, n), **f32),
        active=torch.zeros((iters, n), dtype=torch.bool, device=dev))


def _traced_step(b, fgh, obj, ftol, gtol):
    """One iteration of the traced loop on the buffers ``b``, in place: the
    trace planes take row ``b["it"]`` (a device counter), so the step reads
    nothing from the host and can be replayed as a graph."""
    row = b["it"].view(1)
    b["active"].index_copy_(0, row, ~b["conv"][None])
    x, f, lam, conv, nit, step_norm = _step(fgh, obj, b["x"], b["f"], b["lam"], b["conv"],
                                            b["nit"], b["te"], b["signal"], b["lo"], b["hi"],
                                            ftol, gtol)
    b["f_val"].index_copy_(0, row, f[None])
    b["step_size"].index_copy_(0, row, step_norm[None])
    for name, new in (("x", x), ("f", f), ("lam", lam), ("conv", conv), ("nit", nit)):
        b[name].copy_(new)
    b["it"].add_(1)


def _fit_batch_traced_steps(signal, te, x0, lo, hi, *, model, max_iters, ftol, gtol, graph):
    """fit_batch_traced through the in-place ``_traced_step``: driven
    eagerly (``graph=False``), or on the card captured once as a CUDA graph
    (the first iteration runs eagerly as the capture's warm-up) and
    replayed for every further iteration, the graph kept for later calls."""
    obj, fgh = make_objective(model), make_value_grad_hess(model)
    signal, te, x0, lo, hi, *_ = _prep(signal, te, x0, lo, hi)
    (n, p), t, dev = x0.shape, te.shape[0], signal.device
    key = (model, n, t, p, max_iters, ftol, gtol, dev)
    with _TRACE_LOCK:
        buf, step_graph = _TRACE_GRAPHS.get(key, (None, None)) if graph else (None, None)
        if buf is None:
            buf = _trace_buffers(n, t, p, max_iters, dev)
        for name, src in (("signal", signal), ("te", te), ("lo", lo), ("hi", hi), ("x", x0)):
            buf[name].copy_(src)
        buf["f"].copy_(obj(x0, te, signal))
        buf["lam"].fill_(_LAM0)
        buf["conv"].zero_()
        buf["nit"].zero_()
        buf["it"].zero_()

        def step():
            _traced_step(buf, fgh, obj, ftol, gtol)

        done = 0
        if graph and step_graph is None and max_iters > 0:
            step_graph, done = graphs.capture(step, step, dev), 1
            if len(_TRACE_GRAPHS) >= _TRACE_GRAPHS_MAX:
                _TRACE_GRAPHS.pop(next(iter(_TRACE_GRAPHS)))
            _TRACE_GRAPHS[key] = (buf, step_graph)
        for _ in range(done, max_iters):
            step_graph() if graph else step()
        res = FitResult(x=buf["x"].clone(), fun=buf["f"].clone(),
                        converged=buf["conv"].clone(), n_iter=buf["nit"].clone())
        traces = {name: buf[name].clone() for name in ("f_val", "step_size", "active")}
    return res, traces
