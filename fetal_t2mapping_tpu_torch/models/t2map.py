"""High-level volume fit: EchoStack -> T2/k/sigma/residual maps (PyTorch).

The counterpart of ``fetal_t2mapping_tpu.models.t2map``: masked gather ->
one host->device upload -> fused fit (``fused_fit.fit_fused``: the CUDA
kernels on a GPU, their plain versions on the CPU) -> signed-mean residual
on the device -> ONE packed (C, N) download -> scatter back to volume
maps, plus the sampled per-iteration traces for the convergence figures.
All three noise models run; as in the reference, no-prior 3-parameter
configurations go through the batched multistart solver, and
configurations that start from the protocol guess
(``loglinear_init=False``) through the two-phase solver.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from ..config import FitConfig, NO_PRIOR_K_UPPER, NO_PRIOR_T2_BOUNDS
from ..core.stack import EchoStack
from ..core.volume import Volume
from ..device import resolve_device
from ..utils.profiling import profiler
from .fused_fit import fit_fused
from .init import grid_init, loglinear_init
from .signal import check_model, predict_signal
from .solver import fit_batch_multistart, fit_batch_traced, fit_batch_twophase


@dataclasses.dataclass
class T2FitOutput:
    t2: Volume
    k: Volume
    sigma: Volume
    res: Volume
    converged: Volume          # 1.0 where the voxel fit converged
    n_iter: Volume             # accepted Newton steps per voxel
    fun: Volume                # final objective value per voxel
    traces: Dict[str, np.ndarray]  # sampled per-iteration traces
    trace_t2: np.ndarray       # fitted T2 of the sampled voxels
    n_voxels: int
    fit_seconds: float
    # rows of the fitted batch the two-phase refit had no room for
    # (loglinear_init=False): the solver's count over the batch as gathered,
    # whose rows past n_voxels repeat the last voxel; 0 on the other paths
    n_overflow: int = 0


def _bounds_for(cfg: FitConfig, batch: np.ndarray):
    """Per-voxel (N, P) bound arrays, honouring the no-prior rule.

    no-prior (reference run_t2mapping.py:243-245): k lower bound = the
    voxel's signal at the shortest TE, k upper 10000; T2 bounds (10, 2000).
    """
    n = batch.shape[0]
    lo = np.tile(np.asarray(cfg.lower, np.float32), (n, 1))
    hi = np.tile(np.asarray(cfg.upper, np.float32), (n, 1))
    if not cfg.prior:
        lo[:, 0] = batch[:, 0]
        hi[:, 0] = NO_PRIOR_K_UPPER
        lo[:, 1], hi[:, 1] = NO_PRIOR_T2_BOUNDS
    return lo, hi


def _guess_start(cfg: FitConfig, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The protocol initial guess clipped into each voxel's box: (N, P)."""
    guess = torch.tensor(cfg.initial_guess, dtype=torch.float32, device=lo.device)
    return torch.minimum(torch.maximum(guess.expand_as(lo), lo), hi)


def _init_for(cfg: FitConfig, batch: torch.Tensor, te: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """The solver's start: the log-linear estimate, or with
    ``loglinear_init=False`` the clipped protocol guess."""
    if cfg.loglinear_init:
        return loglinear_init(batch, te, lo, hi)
    return _guess_start(cfg, lo, hi)


def _fused_bounds(cfg: FitConfig):
    """(lo, hi, no_prior flag) for the fused fit, which derives the per-voxel
    no-prior k bound itself from the signal."""
    if cfg.prior:
        return cfg.lower, cfg.upper, False
    lo_f = (0.0, NO_PRIOR_T2_BOUNDS[0])
    hi_f = (NO_PRIOR_K_UPPER, NO_PRIOR_T2_BOUNDS[1])
    return lo_f, hi_f, True


def _residual_mean(model: str, x: torch.Tensor, te: torch.Tensor,
                   batch: torch.Tensor) -> torch.Tensor:
    """Signed mean-over-TEs residual on the device: (N, P), (T,), (N, T) ->
    (N,), so N floats cross to the host instead of the (N, T) prediction."""
    cols = tuple(x[:, i:i + 1] for i in range(x.shape[1]))
    pred = predict_signal(model, cols, te[None, :])
    return torch.mean(batch - pred, dim=1)


def _pack_outputs(x, res, converged, n_iter, fun) -> torch.Tensor:
    """All per-voxel outputs as one (C, N) float32 stack: one download."""
    cols = [x[:, i] for i in range(x.shape[1])]
    cols += [res, converged.to(torch.float32), n_iter.to(torch.float32), fun]
    return torch.stack(cols, dim=0)


def fit_stack(
    stack: EchoStack,
    cfg: FitConfig,
    *,
    trace_samples: int = 50,
    seed: int = 0,
    granule: int = 8192,
    device="cuda",
) -> T2FitOutput:
    """Fit every masked voxel of the stack on ``device`` and assemble maps.

    From the log-linear start (``cfg.loglinear_init``, the default), with
    prior bounds every model runs the fused fit; without them, the
    3-parameter models run the batched multistart solver from the
    log-linear start, the T2 grid-scan basin and the protocol guess
    (reference t2map.py:209-220), and gaussian derives its per-voxel k
    bound inside the fused fit. With ``loglinear_init=False`` every model
    runs the two-phase solver from the protocol guess clipped into each
    voxel's box (reference t2map.py:221-225), and the traces start there
    too; ``n_overflow`` counts the gathered rows its refit had no room for."""
    check_model(cfg.model)
    dev = resolve_device(device)
    batch, flat_idx, n = stack.gather(granule=granule)
    te = np.asarray(stack.tes, np.float32)

    if cfg.norm:
        # per-voxel max-normalization (reference run_t2mapping.py:236-240)
        batch = batch / np.maximum(batch.max(axis=1, keepdims=True), 1e-12)

    t0 = time.time()
    # ONE host->device upload of the batch, shared by the fit and the
    # residual below
    batch_dev = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(dev)
    te_dev = torch.from_numpy(te).to(dev)
    solver_kw = dict(model=cfg.model, max_iters=cfg.max_iters, ftol=cfg.ftol, gtol=cfg.gtol)
    if not cfg.loglinear_init or (cfg.n_params == 3 and not cfg.prior):
        # the batched solvers, on (N, P) per-voxel boxes
        lo, hi = (torch.from_numpy(b).to(dev) for b in _bounds_for(cfg, batch))
        if not cfg.loglinear_init:
            result = fit_batch_twophase(batch_dev, te_dev, _guess_start(cfg, lo, hi), lo, hi,
                                        **solver_kw)
        else:
            # non-convex 3-parameter objectives with per-voxel bounds: keep
            # the best of three starts per voxel
            x0s = torch.stack([loglinear_init(batch_dev, te_dev, lo, hi),
                               grid_init(batch_dev, te_dev, lo, hi), _guess_start(cfg, lo, hi)])
            result = fit_batch_multistart(batch_dev, te_dev, x0s, lo, hi, **solver_kw)
    else:
        lo_f, hi_f, np_flag = _fused_bounds(cfg)
        result = fit_fused(batch_dev, te, lo_f, hi_f, model=cfg.model,
                           guess=cfg.initial_guess, max_iters=cfg.max_iters,
                           ftol=cfg.ftol, gtol=cfg.gtol, no_prior=np_flag,
                           sync=False, device=dev)
    # signed-mean residual over TEs (reference utils/t2map_utils.py:62-89
    # computes the mean, whatever its README says)
    res_dev = _residual_mean(cfg.model, result.x, te_dev, batch_dev)
    with profiler.stage("t2map.fit.download"):
        packed = _pack_outputs(result.x, res_dev, result.converged,
                               result.n_iter, result.fun).cpu().numpy()
    fit_seconds = time.time() - t0

    p = cfg.n_params
    k_v, t2_v = packed[0, :n], packed[1, :n]
    sigma_v = packed[2, :n] if p == 3 else np.zeros(n, np.float32)
    res_v, conv_v, niter_v, fun_v = (packed[p + i, :n] for i in range(4))

    # sampled per-iteration traces for convergence observability
    with profiler.stage("t2map.fit.traces"):
        rng = np.random.default_rng(seed)
        n_tr = min(trace_samples, n)
        tr_sel = rng.choice(n, size=n_tr, replace=False)
        tr_batch = torch.from_numpy(np.ascontiguousarray(batch[tr_sel])).to(dev)
        tr_lo, tr_hi = (torch.from_numpy(b).to(dev)
                        for b in _bounds_for(cfg, batch[tr_sel]))
        _, traces = fit_batch_traced(
            tr_batch, te_dev, _init_for(cfg, tr_batch, te_dev, tr_lo, tr_hi), tr_lo, tr_hi,
            **solver_kw)
        # one download for the three trace planes
        tr_packed = torch.stack([traces["f_val"], traces["step_size"],
                                 traces["active"].to(torch.float32)]).cpu().numpy()
        traces = {"f_val": tr_packed[0], "step_size": tr_packed[1],
                  "active": tr_packed[2] > 0.5}

    return T2FitOutput(
        t2=stack.scatter(t2_v, flat_idx),
        k=stack.scatter(k_v, flat_idx),
        sigma=stack.scatter(sigma_v, flat_idx),
        res=stack.scatter(res_v, flat_idx),
        converged=stack.scatter(conv_v, flat_idx),
        n_iter=stack.scatter(niter_v, flat_idx),
        fun=stack.scatter(fun_v, flat_idx),
        traces=traces,
        trace_t2=t2_v[tr_sel],
        n_voxels=n,
        fit_seconds=fit_seconds,
        n_overflow=0 if result.n_overflow is None else int(result.n_overflow),
    )
