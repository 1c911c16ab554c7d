"""Differentiable multi-resolution image registration (rigid & affine).

The counterpart of ``fetal_t2mapping_tpu.recon.registration``, replacing
the reference's external registration engines: SimpleElastix rigid
registration (reference utils/qmri_utils.py:159-165) for orientation-to-
orientation and echo-to-echo alignment, and FSL FLIRT affine registration
of MNI152 to subject space (:1011-1037).

- The warp is a trilinear gather (ops.interp), differentiable in the
  sample coordinates, so the gradient of the metric in the 6/12 transform
  parameters comes from autograd. The fixed grid is stride-subsampled per
  level (``_LEVEL_SAMPLES``), with the same deterministic sample set as the
  JAX package.
- Four metrics, masked to in-bounds samples: 'ncc', 'mse', Parzen-window
  mutual information 'mi' and the correlation ratio 'cr'. The histograms of
  mi and cr are matmuls of soft bin weights, not scatters: a histogram by
  atomic float adds would change from run to run on the card.
- A Gaussian image pyramid, Adam on physically scaled parameters, and per
  level either a fixed budget or a plateau early exit that returns the
  best iterate.
- Rotations are about the fixed-image centre (CenteredTransformInitializer
  GEOMETRY).

Every solve has an explicit pair axis: ``register_rigid`` is the
multi-pair engine with one pair, so the two cannot drift apart. The pairs
share the fixed image; the movings sit zero-padded in one flat buffer with
per-pair bases and true extents. ``lax.while_loop`` becomes a Python loop
whose state is frozen on the device by a level-wide active flag once every
pair has gone ``stop_window`` iterations without a meaningful new best (as
the reference's ``_level_while_multi``: a pair that plateaus first keeps
stepping while another still improves). The host reads that flag every
``_CHECK_EVERY`` iterations; the steps taken after the stop are not
committed, so the stop iteration and the result are those of a test every
iteration.

The returned transform is a 4x4 world->world matrix T mapping fixed-space
points into moving space: registered(w) = moving(T @ w).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device
from ..ops.filtering import smooth_subsample
from ..ops.interp import _trilinear
from .resample import resample_to_reference, to_tensor

_AFFINE_T_SCALE = 50.0

# Per-level metric sample budgets: lean coarse levels, a dense finest level
# (the JAX package's _LEVEL_SAMPLES; 2^14 is still ~5x denser than
# Elastix's few-thousand random samples per iteration)
_LEVEL_SAMPLES = (1 << 14, 1 << 14, 1 << 16)

# the plateau exit's host read of the active flag, every this many
# iterations of a level
_CHECK_EVERY = 10

_N_BINS = 32


# --------------------------------------------------------------------- math
def _mat3(rows) -> torch.Tensor:
    """3x3 nested list of (P,) tensors -> (P, 3, 3)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _euler_zxy(rx, ry, rz) -> torch.Tensor:
    """(P,) angles -> (P, 3, 3) rotations (ITK Euler3DTransform: Rz @ Rx @ Ry)."""
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)
    Rx = _mat3([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = _mat3([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = _mat3([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return Rz @ Rx @ Ry


def _rigid_matrix(params, center, scale):
    """params (P, 6), rotations multiplied by the image radius so Adam sees
    comparable magnitudes (``scale`` undoes that) -> R (P, 3, 3), offset
    (P, 3) with the rotation about ``center``."""
    rot = params[:, :3] / scale
    t = params[:, 3:]
    R = _euler_zxy(rot[:, 0], rot[:, 1], rot[:, 2])
    return R, center - (R @ center[:, None])[..., 0] + t


def _affine_matrix(params, center):
    """params (P, 12): 9 matrix perturbations of identity + 3 translations."""
    M = torch.eye(3, dtype=params.dtype, device=params.device) + params[:, :9].reshape(-1, 3, 3)
    return M, center - (M @ center[:, None])[..., 0] + params[:, 9:]


def _transform_fn(mode: str, center, scale):
    if mode == "rigid":
        return lambda p: _rigid_matrix(p, center, scale)
    # translations need mm-scale steps: scaled up inside the transform
    return lambda p: _affine_matrix(torch.cat([p[:, :9], p[:, 9:] * _AFFINE_T_SCALE], 1), center)


def _matrix_4x4(params, center, scale, mode: str) -> torch.Tensor:
    """(P, dof) solved params -> (P, 4, 4) float32 world transforms."""
    R, offset = _transform_fn(mode, center, scale)(params)
    T = torch.zeros((params.shape[0], 4, 4), dtype=torch.float32, device=params.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = offset
    T[:, 3, 3] = 1.0
    return T


# ----------------------------------------------------------------- pyramid
def _device_pyramid(data: torch.Tensor, spacing, levels: Sequence[int],
                    sigmas: Sequence[float]):
    """Every pyramid level from the one uploaded base volume."""
    out = []
    for factor, sigma in zip(levels, sigmas):
        lvl = data if (factor == 1 and sigma <= 0) else smooth_subsample(data, sigma, factor)
        # voxel (0,0,0) centre moves < spacing/2 under subsampling; negligible
        out.append((lvl, tuple(s * factor for s in spacing)))
    return out


def _mask_pyramid(mask: np.ndarray, levels: Sequence[int]):
    """Per-level fixed-image metric masks (host numpy, bool): the block-OR
    of the full-resolution mask over each level's strided grid."""
    base = np.asarray(mask) > 0
    out = []
    for factor in levels:
        factor = int(factor)
        if factor == 1:
            out.append(base)
            continue
        lvl_shape = tuple(len(range(0, s, factor)) for s in base.shape)
        lvl = np.zeros(lvl_shape, bool)
        for dz in range(factor):
            for dy in range(factor):
                for dx in range(factor):
                    sub = base[dz::factor, dy::factor, dx::factor]
                    lvl[:sub.shape[0], :sub.shape[1], :sub.shape[2]] |= sub
        out.append(lvl)
    return out


def _fixed_mask_pyramid(fixed: Volume, fixed_data: torch.Tensor, fixed_mask,
                        levels: Sequence[int]):
    """A fixed-image metric mask (Volume | array | "auto" | None) as one
    bool array per pyramid level (all None when unmasked). "auto" builds it
    from the fixed image with ops.build_slice_mask, as the reference's
    ``registration_itk`` does before ``SetMetricFixedMask``
    (utils/qmri_utils.py:186-197,223-252)."""
    if fixed_mask is None:
        return (None,) * len(levels)
    if isinstance(fixed_mask, str):
        if fixed_mask != "auto":
            raise ValueError(f"fixed_mask must be an array, a Volume, "
                             f"'auto' or None; got {fixed_mask!r}")
        from ..ops.morphology import build_slice_mask

        fixed_mask = build_slice_mask(fixed_data)
    arr = fixed_mask.data if isinstance(fixed_mask, Volume) else fixed_mask
    arr = arr.cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
    if arr.shape != tuple(fixed.shape):
        raise ValueError(f"fixed_mask shape {arr.shape} != fixed image shape {fixed.shape}")
    if not (arr > 0).any():
        raise ValueError("fixed_mask is empty")
    return _mask_pyramid(arr, levels)


# ------------------------------------------------------------- sample sets
def _level_samples(samples, n_levels: int):
    """None -> lean coarse levels + a dense finest level; an explicit
    sequence must cover every level."""
    if samples is None:
        return (_LEVEL_SAMPLES[0],) * (n_levels - 1) + (_LEVEL_SAMPLES[-1],)
    samples = tuple(int(s) for s in samples)
    if len(samples) != n_levels:
        raise ValueError(f"samples has {len(samples)} entries for {n_levels} pyramid levels")
    return samples


def _fixed_level_operands(fixed_vol: Volume, fixed_data: torch.Tensor, fixed_spacing,
                          max_points: int, mask_level=None):
    """Fixed-side metric operands (world sample points, values) of one level.

    The fixed grid is stride-subsampled to at most ~max_points samples;
    with ``mask_level`` the samples are exactly ``max_points`` mask voxels
    by even resampling of the raster-ordered mask-voxel list. The points are
    computed on the host exactly as the JAX package does, so both evaluate
    the metric on the same points."""
    dev = fixed_data.device
    shape = tuple(int(s) for s in fixed_data.shape)
    A = fixed_vol.direction_matrix @ np.diag(fixed_spacing)   # world from (x,y,z)
    if mask_level is not None:
        mask_level = np.asarray(mask_level)
        if mask_level.shape != shape:
            raise ValueError(f"fixed_mask level shape {mask_level.shape} != level image "
                             f"shape {shape}")
        mvox = np.argwhere(mask_level)                 # (M, 3) in (z,y,x)
        if mvox.shape[0] == 0:
            raise ValueError("fixed_mask selects no voxels at this pyramid level")
        take = np.linspace(0, mvox.shape[0] - 1, num=int(max_points))
        mvox = mvox[take.round().astype(np.int64)]
        world = (mvox[:, ::-1].astype(np.float32) @ A.T
                 + np.asarray(fixed_vol.origin)).astype(np.float32)
        idx = torch.as_tensor(mvox, device=dev)
        fixed_vals = fixed_data[idx[:, 0], idx[:, 1], idx[:, 2]]
    else:
        npts = int(np.prod(shape))
        stride = 1
        if npts > max_points:
            stride = int(np.ceil((npts / max_points) ** (1.0 / 3.0)))
        idx = np.stack(np.meshgrid(
            *[np.arange(0, s, stride, dtype=np.float32) for s in shape],
            indexing="ij"), axis=-1)                   # (gz, gy, gx, 3) in (z,y,x)
        world = (idx[..., ::-1] @ A.T + np.asarray(fixed_vol.origin)).astype(np.float32)
        world = world.reshape(-1, 3)
        fixed_vals = fixed_data[::stride, ::stride, ::stride].reshape(-1)
    return torch.as_tensor(np.ascontiguousarray(world), device=dev), fixed_vals


def _moving_level_operands(movings: Sequence[Volume], pyramids, level: int):
    """One pyramid level of every moving volume, zero-padded to the shared
    largest shape in one flat buffer. Padding leaves the metric unchanged:
    a sample reads 0 outside the true volume, the true extents ride along
    for the in-bounds test, and the MI intensity window is reduced over
    each unpadded volume."""
    datas = [pyr[level][0] for pyr in pyramids]
    dev = datas[0].device
    block = tuple(max(int(d.shape[i]) for d in datas) for i in range(3))
    buf = torch.zeros((len(datas),) + block, dtype=torch.float32, device=dev)
    invs, origins, dims, los, rngs = [], [], [], [], []
    for p, (mov, pyr) in enumerate(zip(movings, pyramids)):
        d, sp = pyr[level]
        buf[p, :d.shape[0], :d.shape[1], :d.shape[2]] = d
        invs.append(np.linalg.inv(mov.direction_matrix @ np.diag(sp)).T)
        origins.append(mov.origin)
        dims.append(d.shape)
        lo = d.min()
        los.append(lo)
        rngs.append(torch.clamp(d.max() - lo, min=1e-6))
    f32 = dict(dtype=torch.float32, device=dev)
    n_block = block[0] * block[1] * block[2]
    return dict(
        flat=buf.reshape(-1), block=block,
        base=torch.arange(len(datas), device=dev)[:, None] * n_block,
        inv=torch.as_tensor(np.stack(invs), **f32),
        origin=torch.as_tensor(np.asarray(origins), **f32),
        dims=torch.as_tensor(np.asarray(dims), **f32),
        lo=torch.stack(los), rng=torch.stack(rngs))


# ------------------------------------------------------------------ metric
def _make_metric_fn(kind: str, transform_fn, fixed_pts, fixed_vals, mov):
    """metric(params (P, dof)) -> (P,) for P movings against one fixed image."""
    if kind not in ("ncc", "mse", "mi", "cr"):
        raise ValueError(kind)
    dims = mov["dims"]
    nz, ny, nx = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
    n_all = float(fixed_pts.shape[0])
    if kind in ("mi", "cr"):
        # the FIXED image's soft bin weights are constant across iterations:
        # 32 bins, Parzen window a Gaussian one bin wide (smooth, so the
        # metric is differentiable through the moving values)
        f_lo = fixed_vals.min()
        f_rng = torch.clamp(fixed_vals.max() - f_lo, min=1e-6)
        centers = torch.arange(_N_BINS, dtype=torch.float32, device=fixed_vals.device)
        zf = (fixed_vals - f_lo) / f_rng * (_N_BINS - 1)
        wf = torch.exp(-0.5 * torch.square(zf[:, None] - centers[None, :]))
        wf = wf / (wf.sum(1, keepdim=True) + 1e-12)                  # (N, B)
        nb = wf.sum(0)                                                # (B,)
        m_lo, m_rng = mov["lo"][:, None], mov["rng"][:, None]

    def metric(params):
        R, offset = transform_fn(params)
        w = fixed_pts @ R.transpose(1, 2) + offset[:, None, :]        # (P, N, 3)
        idx_xyz = (w - mov["origin"][:, None, :]) @ mov["inv"]
        x, y, z = idx_xyz[..., 0], idx_xyz[..., 1], idx_xyz[..., 2]
        vals = _trilinear(mov["flat"], mov["block"], z, y, x, base=mov["base"])
        inb = ((z >= 0) & (z <= nz - 1) & (y >= 0) & (y <= ny - 1)
               & (x >= 0) & (x <= nx - 1)).to(torch.float32)
        n = torch.clamp(inb.sum(-1), min=1.0)
        if kind in ("mi", "cr"):
            # EVERY fixed sample contributes; out-of-bounds moving samples
            # read as background (0) rather than being dropped, so the
            # optimizer cannot game the metric by shrinking the overlap
            vals_bg = vals * inb
            if kind == "cr":
                # FLIRT's default cost (correlation ratio, Roche 1998):
                # 1 - E_b[Var(moving | fixed-bin b)] / Var(moving)
                s1 = vals_bg @ wf                                     # (P, B)
                s2 = (vals_bg * vals_bg) @ wf
                mm_all = s1.sum(-1) / n_all
                var_all = torch.clamp(s2.sum(-1) / n_all - mm_all ** 2, min=1e-12)
                mean_b = s1 / torch.clamp(nb, min=1e-6)
                var_b = torch.clamp(s2 / torch.clamp(nb, min=1e-6) - mean_b ** 2, min=0.0)
                return (nb * var_b).sum(-1) / (n_all * var_all) - 1.0
            # Parzen joint histogram (Mattes/Viola): one (B, N) x (N, B)
            # matmul per pair
            zm = (vals_bg - m_lo) / m_rng * (_N_BINS - 1)
            wm = torch.exp(-0.5 * torch.square(zm[..., None] - centers))
            wm = wm / (wm.sum(-1, keepdim=True) + 1e-12)              # (P, N, B)
            joint = wf.T @ wm                                         # (P, B, B)
            joint = joint / torch.clamp(joint.sum((-2, -1)), min=1e-12)[:, None, None]
            pf = joint.sum(-1)
            pm = joint.sum(-2)
            mi = (joint * (torch.log(joint + 1e-12)
                           - torch.log(pf[:, :, None] * pm[:, None, :] + 1e-12))).sum((-2, -1))
            return -mi
        mf = (fixed_vals * inb).sum(-1) / n
        mm = (vals * inb).sum(-1) / n
        df = (fixed_vals - mf[:, None]) * inb
        dm = (vals - mm[:, None]) * inb
        if kind == "ncc":
            cov = (df * dm).sum(-1)
            denom = torch.sqrt((df * df).sum(-1) * (dm * dm).sum(-1)) + 1e-8
            return -cov / denom
        return torch.square(df - dm).sum(-1) / n

    return metric


def _value_and_grad(metric, params):
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        f = metric(p)
        (g,) = torch.autograd.grad(f.sum(), p)
    return f.detach(), g


# --------------------------------------------------------------- optimizer
def _adam_step(f_g, params, m, v, t: int, lr):
    """One Adam(0.9, 0.999) step at step index ``t`` (counted from 1)."""
    f, g = f_g(params)
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    one = torch.ones((), dtype=torch.float32, device=params.device)
    mhat = m / (1 - (0.9 * one) ** t)
    vhat = v / (1 - (0.999 * one) ** t)
    return f, params - lr * mhat / (torch.sqrt(vhat) + 1e-8), m, v


def _best_improved(f, best_f, f0, stop_tol):
    """Did this iterate beat the best so far by more than ``stop_tol`` of
    the level's total descent (floored at 1%% of the metric's magnitude)?
    See the JAX package's ``_best_improved``."""
    scale = torch.maximum(f0 - best_f, 0.01 * torch.abs(best_f))
    return f < best_f - stop_tol * torch.clamp(scale, min=1e-12)


def _level_scan(f_g, params, lr, iters: int):
    """A fixed-budget level: ``iters`` Adam steps, the last iterate."""
    m = v = torch.zeros_like(params)
    hist = []
    for t in range(1, iters + 1):
        f, params, m, v = _adam_step(f_g, params, m, v, t, lr)
        hist.append(f)
    return params, torch.stack(hist)


def _level_while(f_g, params, lr, iters: int, stop_tol: float, stop_window: int):
    """A level with the plateau early exit. Returns the best iterate, the
    (iters, P) metric history (its tail past the stop reads the best
    metric), the executed iteration count, the best metric and the number
    of host reads."""
    dev = params.device
    P = params.shape[0]
    m = v = torch.zeros_like(params)
    best_f = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    best_p = params
    t_best = torch.zeros((P,), dtype=torch.int64, device=dev)
    t_end = torch.zeros((), dtype=torch.int64, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    tol = torch.tensor(stop_tol, dtype=torch.float32, device=dev)
    hist, f0, syncs = [], None, 0
    for i in range(iters):
        if i and i % _CHECK_EVERY == 0:
            syncs += 1
            if not bool(active):
                break
        t1 = i + 1
        f, new_params, new_m, new_v = _adam_step(f_g, params, m, v, t1, lr)
        f0 = f if f0 is None else f0
        # track the best iterate: a warm start AT the optimum makes Adam
        # wander, so return where the metric was best
        new_t_best = torch.where(_best_improved(f, best_f, f0, tol), t1, t_best)
        better = f < best_f
        new_best_f = torch.where(better, f, best_f)
        new_best_p = torch.where(better[:, None], params, best_p)
        running = torch.any((t1 - new_t_best) < stop_window)
        params, m, v = (torch.where(active, a, b) for a, b in
                        ((new_params, params), (new_m, m), (new_v, v)))
        t_best = torch.where(active, new_t_best, t_best)
        best_f = torch.where(active, new_best_f, best_f)
        best_p = torch.where(active, new_best_p, best_p)
        hist.append(torch.where(active, f, best_f))
        t_end = t_end + active.to(torch.int64)
        active = active & running
    hist = torch.stack(hist + [best_f] * (iters - len(hist)))
    hist = torch.where(torch.arange(iters, device=dev)[:, None] >= t_end, best_f[None, :], hist)
    return best_p, hist, t_end, best_f, syncs


def _resolve_stop_window(stop_window, metric: str) -> int:
    """None -> per-metric patience: the histogram metrics descend noisily
    and need a longer window (40) than ncc/mse (20)."""
    if stop_window is None:
        return 40 if metric in ("mi", "cr") else 20
    return int(stop_window)


# -------------------------------------------------------------------- API
class RegistrationResult:
    """World->world transform (fixed space -> moving space) + diagnostics.

    Lazy on the device: the solve's outputs stay there until a host field
    is touched. ``matrix`` / ``params`` / ``final_metric`` /
    ``metric_history`` download on first access and are cached; chained
    consumers use ``matrix_device`` (warps) and ``params_device`` (warm
    starts) and never sync. ``host_syncs`` counts the plateau exit's host
    reads in the solve."""

    def __init__(self, matrix=None, final_metric=None, metric_history=None,
                 params=None, *, _solve=None):
        # _solve: dict(params, center, scale, hist, mode, n_exec, final_f, host_syncs)
        self._matrix = matrix
        self._final_metric = final_metric
        self._metric_history = metric_history
        self._params = None if params is None else np.asarray(params, np.float32)
        self._solve = _solve

    @property
    def host_syncs(self) -> int:
        return 0 if self._solve is None else self._solve["host_syncs"]

    # ---- device views (no host sync)
    @property
    def params_device(self) -> torch.Tensor:
        if self._solve is not None:
            return self._solve["params"]
        return torch.as_tensor(self.params, dtype=torch.float32)

    @property
    def matrix_device(self) -> torch.Tensor:
        """4x4 world->world transform as a float32 tensor on the device."""
        if self._solve is None:
            return torch.as_tensor(self.matrix, dtype=torch.float32)
        s = self._solve
        return _matrix_4x4(s["params"][None], s["center"], s["scale"], s["mode"])[0]

    # ---- host fields (sync + cache on first access)
    @property
    def matrix(self) -> np.ndarray:
        if self._matrix is None:
            self._matrix = self.matrix_device.cpu().numpy().astype(np.float64)
        return self._matrix

    @property
    def final_metric(self) -> float:
        if self._final_metric is None:
            if self._solve is not None and self._solve["final_f"] is not None:
                # early-exit solve: the metric of the RETURNED (best) iterate
                self._final_metric = float(self._solve["final_f"])
            else:
                self._final_metric = float(self.metric_history[-1])
        return self._final_metric

    @property
    def metric_history(self) -> np.ndarray:
        if self._metric_history is None:
            self._metric_history = np.concatenate(
                [h.cpu().numpy() for h in self._solve["hist"]])
        return self._metric_history

    @property
    def params(self) -> np.ndarray:
        """Raw optimizer parameters (6 rigid / 12 affine): feed back as
        ``init_params`` to warm-start a related registration."""
        if self._params is None:
            self._params = (np.zeros(0, np.float32) if self._solve is None
                            else self._solve["params"].cpu().numpy())
        return self._params

    @property
    def iters_run(self):
        """Per-level iteration counts of the early-exit optimizer, or None
        for the fixed-budget path (stop_tol=None)."""
        if self._solve is None or self._solve["n_exec"] is None:
            return None
        return np.asarray([int(t) for t in self._solve["n_exec"]])


def _register(fixed: Volume, movings: Sequence[Volume], *, mode: str, levels, sigmas,
              iters, samples, lr, metric, init_params, fixed_mask, stop_tol,
              stop_window, mesh, device):
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the sharded registration) is not ported; ROADMAP Queue 1 item 10")
    if len(movings) == 0:
        return []
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    center_np = np.asarray(fixed.center_world(), np.float32)
    if mode == "rigid":
        radius = float(np.linalg.norm(np.asarray(fixed.physical_extent)) / 2.0) or 1.0
        scale_np, dof = np.float32(radius), 6   # rotations optimized in radius*mm units
    else:
        scale_np, dof = np.float32(1.0), 12
    P = len(movings)
    if init_params is None:
        params = torch.zeros((P, dof), **f32)
    else:
        params = to_tensor(init_params, dev, torch.float32)
        if tuple(params.shape) != (P, dof):
            raise ValueError(f"init_params shape {tuple(params.shape)} != ({P}, {dof}) for "
                             f"{P} moving volumes ({mode})")
    samples = _level_samples(samples, len(levels))
    if len(sigmas) != len(levels) or len(iters) != len(levels):
        raise ValueError(f"levels/sigmas/iters lengths differ: {len(levels)}/"
                         f"{len(sigmas)}/{len(iters)}")
    fixed_data = to_tensor(fixed.data, dev, torch.float32)
    mask_pyr = _fixed_mask_pyramid(fixed, fixed_data, fixed_mask, levels)
    f_pyr = _device_pyramid(fixed_data, fixed.spacing, levels, sigmas)
    m_pyrs = [_device_pyramid(to_tensor(m.data, dev, torch.float32), m.spacing, levels, sigmas)
              for m in movings]
    center = torch.as_tensor(center_np, **f32)
    scale = torch.as_tensor(scale_np, **f32)
    tf = _transform_fn(mode, center, scale)
    lr_t = torch.as_tensor(np.float32(lr), **f32)
    window = _resolve_stop_window(stop_window, metric)
    hist, n_exec, final_f, syncs = [], ([] if stop_tol is not None else None), None, 0
    for li, ((f_dat, f_sp), n_smp, mlvl) in enumerate(zip(f_pyr, samples, mask_pyr)):
        fixed_pts, fixed_vals = _fixed_level_operands(fixed, f_dat, f_sp, int(n_smp), mlvl)
        mov = _moving_level_operands(movings, m_pyrs, li)
        met = _make_metric_fn(metric, tf, fixed_pts, fixed_vals, mov)
        f_g = lambda p, met=met: _value_and_grad(met, p)
        if stop_tol is None:
            params, h = _level_scan(f_g, params, lr_t, int(iters[li]))
        else:
            params, h, t_end, final_f, k = _level_while(
                f_g, params, lr_t, int(iters[li]), float(stop_tol), window)
            n_exec.append(t_end)
            syncs += k
        hist.append(h)
    return [RegistrationResult(_solve=dict(
        params=params[p], center=center, scale=scale, hist=[h[:, p] for h in hist],
        mode=mode, n_exec=n_exec, final_f=None if final_f is None else final_f[p],
        host_syncs=syncs)) for p in range(P)]


def _one_pair(init_params):
    """A single solve's (dof,) start as the engine's (1, dof)."""
    if init_params is None:
        return None
    if torch.is_tensor(init_params):
        return init_params.reshape(1, -1)
    return np.asarray(init_params, np.float32).reshape(1, -1)


def register_rigid(fixed: Volume, moving: Volume, *,
                   levels: Sequence[int] = (4, 2, 1),
                   sigmas: Sequence[float] = (2.0, 1.0, 0.0),
                   iters: Sequence[int] = (150, 100, 50),
                   samples: Optional[Sequence[int]] = None,
                   lr: float = 0.5, metric: str = "ncc",
                   init_params=None, fixed_mask=None,
                   stop_tol: Optional[float] = 1e-3,
                   stop_window: Optional[int] = None,
                   mesh=None, device="cuda") -> RegistrationResult:
    """6-DOF rigid registration of ``moving`` onto ``fixed`` on ``device``.

    ``fixed_mask`` (a Volume, a bool array on the fixed grid, or "auto")
    restricts the metric to mask voxels (the reference's
    ``SetMetricFixedMask``, utils/qmri_utils.py:194-197). ``stop_tol``
    enables the per-level plateau early exit (None: the exact fixed-budget
    optimizer); ``iters`` is the per-level budget either way. ``mesh`` is
    not ported and raises."""
    return _register(fixed, [moving], mode="rigid", levels=levels, sigmas=sigmas,
                     iters=iters, samples=samples, lr=lr, metric=metric,
                     init_params=_one_pair(init_params), fixed_mask=fixed_mask, stop_tol=stop_tol,
                     stop_window=stop_window, mesh=mesh, device=device)[0]


def register_affine(fixed: Volume, moving: Volume, *,
                    levels: Sequence[int] = (4, 2, 1),
                    sigmas: Sequence[float] = (2.0, 1.0, 0.0),
                    iters: Sequence[int] = (200, 120, 60),
                    samples: Optional[Sequence[int]] = None,
                    lr: float = 0.02, metric: str = "ncc",
                    init_params=None, fixed_mask=None,
                    stop_tol: Optional[float] = 1e-3,
                    stop_window: Optional[int] = None,
                    mesh=None, device="cuda") -> RegistrationResult:
    """12-DOF affine registration (the FLIRT replacement): the 9 matrix
    entries are perturbations of identity, translations are scaled up
    inside the transform. Options as :func:`register_rigid`."""
    return _register(fixed, [moving], mode="affine", levels=levels, sigmas=sigmas,
                     iters=iters, samples=samples, lr=lr, metric=metric,
                     init_params=_one_pair(init_params), fixed_mask=fixed_mask, stop_tol=stop_tol,
                     stop_window=stop_window, mesh=mesh, device=device)[0]


def register_rigid_multi(fixed: Volume, movings: Sequence[Volume], *,
                         levels: Sequence[int] = (4, 2, 1),
                         sigmas: Sequence[float] = (2.0, 1.0, 0.0),
                         iters: Sequence[int] = (150, 100, 50),
                         samples: Optional[Sequence[int]] = None,
                         lr: float = 0.5, metric: str = "ncc",
                         init_params=None, fixed_mask=None,
                         stop_tol: Optional[float] = 1e-3,
                         stop_window: Optional[int] = None,
                         mesh=None, device="cuda") -> List[RegistrationResult]:
    """Register P moving volumes onto ONE fixed volume in lock-step: the
    pair axis batches every gather, histogram and Adam step. The reference
    runs these as sequential Elastix processes (cor->ax and sag->ax per
    echo, utils/qmri_utils.py:91; echo->first echo, :378-383). Movings may
    differ in shape. ``init_params`` is optionally (P, 6)."""
    return _register(fixed, list(movings), mode="rigid", levels=levels, sigmas=sigmas,
                     iters=iters, samples=samples, lr=lr, metric=metric,
                     init_params=init_params, fixed_mask=fixed_mask, stop_tol=stop_tol,
                     stop_window=stop_window, mesh=mesh, device=device)


def register_affine_multi(fixed: Volume, movings: Sequence[Volume], *,
                          levels: Sequence[int] = (4, 2, 1),
                          sigmas: Sequence[float] = (2.0, 1.0, 0.0),
                          iters: Sequence[int] = (200, 120, 60),
                          samples: Optional[Sequence[int]] = None,
                          lr: float = 0.02, metric: str = "ncc",
                          init_params=None, fixed_mask=None,
                          stop_tol: Optional[float] = 1e-3,
                          stop_window: Optional[int] = None,
                          mesh=None, device="cuda") -> List[RegistrationResult]:
    """Batched 12-DOF affine registration (see :func:`register_rigid_multi`)."""
    return _register(fixed, list(movings), mode="affine", levels=levels, sigmas=sigmas,
                     iters=iters, samples=samples, lr=lr, metric=metric,
                     init_params=init_params, fixed_mask=fixed_mask, stop_tol=stop_tol,
                     stop_window=stop_window, mesh=mesh, device=device)


def register_and_resample(fixed: Volume, moving: Volume, *, mode: str = "rigid",
                          method: str = "linear", device="cuda", **kwargs) -> Volume:
    """Register, then resample onto the fixed grid (the reference's
    ``registration_elastix`` call shape, utils/qmri_utils.py:159-165)."""
    fn = register_rigid if mode == "rigid" else register_affine
    reg = fn(fixed, moving, device=device, **kwargs)
    return resample_to_reference(moving, fixed, transform=reg.matrix, method=method,
                                 device=device)
