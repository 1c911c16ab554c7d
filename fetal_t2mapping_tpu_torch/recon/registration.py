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
iteration. On one card each level's step (metric, autograd, Adam, best
tracking, history row, the freeze) is captured once as a CUDA graph
(``graphs``) and replayed once per iteration, with the step index a device
counter: the reference's ``lax.while_loop`` / ``lax.scan`` as one graph
launch per iteration, with the eager loop's results. On the CPU, and over
a ``mesh`` (whose metric adds partial sums across devices), the levels run
as eager loops.

The returned transform is a 4x4 world->world matrix T mapping fixed-space
points into moving space: registered(w) = moving(T @ w).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import graphs
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
def _shard_samples(fixed_pts, fixed_vals, mesh):
    """A level's fixed samples for a ``mesh`` of d devices: a count that d
    does not divide is evenly resampled down to the largest multiple of d
    (the reference's ``_shard_level_ops``; it drops < d samples of
    thousands)."""
    n, ndev = int(fixed_pts.shape[0]), mesh.size
    if n < ndev:
        raise ValueError(f"level has {n} metric samples for a {ndev}-device mesh")
    if n % ndev:
        keep = np.round(np.linspace(0, n - 1, num=n - n % ndev)).astype(np.int64)
        keep = torch.as_tensor(keep, device=fixed_pts.device)
        fixed_pts, fixed_vals = fixed_pts[keep], fixed_vals[keep]
    return fixed_pts, fixed_vals


def _make_metric_fn(kind: str, transform_fn, fixed_pts, fixed_vals, mov, mesh=None):
    """metric(params (P, dof)) -> (P,) for P movings against one fixed image.

    With ``mesh`` (a ``parallel.VoxelMesh``) the fixed-image sample axis is
    split into one contiguous chunk per mesh device, and the moving
    operands are replicated: each shard samples the movings at its points
    and computes its partial sums on its own device (the NCC/MSE moments,
    CR's binned moments, MI's joint histogram); the partial sums are added
    on the first device, where the metric is formed, and autograd carries
    the gradient back across the devices. Without a mesh the whole sample
    set is one shard, so the single-device metric is the same code."""
    if kind not in ("ncc", "mse", "mi", "cr"):
        raise ValueError(kind)
    dev0 = fixed_pts.device
    n_all = float(fixed_pts.shape[0])
    wf = None
    if kind in ("mi", "cr"):
        # the FIXED image's soft bin weights are constant across iterations:
        # 32 bins, Parzen window a Gaussian one bin wide (smooth, so the
        # metric is differentiable through the moving values)
        f_lo = fixed_vals.min()
        f_rng = torch.clamp(fixed_vals.max() - f_lo, min=1e-6)
        centers = torch.arange(_N_BINS, dtype=torch.float32, device=dev0)
        zf = (fixed_vals - f_lo) / f_rng * (_N_BINS - 1)
        wf = torch.exp(-0.5 * torch.square(zf[:, None] - centers[None, :]))
        wf = wf / (wf.sum(1, keepdim=True) + 1e-12)                  # (N, B)
        nb = wf.sum(0)                                                # (B,)
    devices = (dev0,) if mesh is None else mesh.devices
    m = int(fixed_pts.shape[0]) // len(devices)
    shards = []
    for i, dev in enumerate(devices):
        sl = slice(i * m, (i + 1) * m)
        sh = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in mov.items()}
        sh.update(pts=fixed_pts[sl].to(dev), vals=fixed_vals[sl].to(dev),
                  wf=None if wf is None else wf[sl].to(dev),
                  centers=torch.arange(_N_BINS, dtype=torch.float32, device=dev))
        dims = sh["dims"]
        sh["nz"], sh["ny"], sh["nx"] = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        shards.append(sh)

    def total(parts):
        """Partial sums added on the first device (one part: itself)."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(dev0)
        return out

    def sample(sh, R, offset):
        """(moving values (P, n), in-bounds (P, n)) at the shard's points."""
        dev = sh["pts"].device
        w = sh["pts"] @ R.to(dev).transpose(1, 2) + offset.to(dev)[:, None, :]   # (P, n, 3)
        idx_xyz = (w - sh["origin"][:, None, :]) @ sh["inv"]
        x, y, z = idx_xyz[..., 0], idx_xyz[..., 1], idx_xyz[..., 2]
        vals = _trilinear(sh["flat"], sh["block"], z, y, x, base=sh["base"])
        inb = ((z >= 0) & (z <= sh["nz"] - 1) & (y >= 0) & (y <= sh["ny"] - 1)
               & (x >= 0) & (x <= sh["nx"] - 1)).to(torch.float32)
        return vals, inb

    def metric(params):
        R, offset = transform_fn(params)
        sampled = [sample(sh, R, offset) for sh in shards]
        if kind in ("mi", "cr"):
            # EVERY fixed sample contributes; out-of-bounds moving samples
            # read as background (0) rather than being dropped, so the
            # optimizer cannot game the metric by shrinking the overlap
            vals_bg = [vals * inb for vals, inb in sampled]
            if kind == "cr":
                # FLIRT's default cost (correlation ratio, Roche 1998):
                # 1 - E_b[Var(moving | fixed-bin b)] / Var(moving)
                s1 = total([v @ sh["wf"] for v, sh in zip(vals_bg, shards)])        # (P, B)
                s2 = total([(v * v) @ sh["wf"] for v, sh in zip(vals_bg, shards)])
                mm_all = s1.sum(-1) / n_all
                var_all = torch.clamp(s2.sum(-1) / n_all - mm_all ** 2, min=1e-12)
                mean_b = s1 / torch.clamp(nb, min=1e-6)
                var_b = torch.clamp(s2 / torch.clamp(nb, min=1e-6) - mean_b ** 2, min=0.0)
                return (nb * var_b).sum(-1) / (n_all * var_all) - 1.0
            # Parzen joint histogram (Mattes/Viola): one (B, n) x (n, B)
            # matmul per pair and shard
            joints = []
            for v, sh in zip(vals_bg, shards):
                zm = (v - sh["lo"][:, None]) / sh["rng"][:, None] * (_N_BINS - 1)
                wm = torch.exp(-0.5 * torch.square(zm[..., None] - sh["centers"]))
                wm = wm / (wm.sum(-1, keepdim=True) + 1e-12)              # (P, n, B)
                joints.append(sh["wf"].T @ wm)                            # (P, B, B)
            joint = total(joints)
            joint = joint / torch.clamp(joint.sum((-2, -1)), min=1e-12)[:, None, None]
            pf = joint.sum(-1)
            pm = joint.sum(-2)
            mi = (joint * (torch.log(joint + 1e-12)
                           - torch.log(pf[:, :, None] * pm[:, None, :] + 1e-12))).sum((-2, -1))
            return -mi
        n = torch.clamp(total([inb.sum(-1) for _, inb in sampled]), min=1.0)
        mf = total([(sh["vals"] * inb).sum(-1) for (_, inb), sh in zip(sampled, shards)]) / n
        mm = total([(vals * inb).sum(-1) for vals, inb in sampled]) / n
        diffs = []
        for (vals, inb), sh in zip(sampled, shards):
            dev = vals.device
            diffs.append(((sh["vals"] - mf.to(dev)[:, None]) * inb,
                          (vals - mm.to(dev)[:, None]) * inb))
        if kind == "ncc":
            cov = total([(df * dm).sum(-1) for df, dm in diffs])
            denom = torch.sqrt(total([(df * df).sum(-1) for df, _ in diffs])
                               * total([(dm * dm).sum(-1) for _, dm in diffs])) + 1e-8
            return -cov / denom
        return total([torch.square(df - dm).sum(-1) for df, dm in diffs]) / n

    return metric


def _value_and_grad(metric, params):
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        f = metric(p)
        (g,) = torch.autograd.grad(f.sum(), p)
    return f.detach(), g


# --------------------------------------------------------------- optimizer
def _bias_denominators(t: int, dev):
    """Adam's bias corrections 1 - 0.9^t and 1 - 0.999^t at step ``t``, as
    0-dim tensors on ``dev``."""
    one = torch.ones((), dtype=torch.float32, device=dev)
    return 1 - (0.9 * one) ** t, 1 - (0.999 * one) ** t


def _adam(g, params, m, v, den1, den2, lr):
    """Adam(0.9, 0.999) from gradient ``g`` with bias-correction
    denominators ``den1``, ``den2``: (new params, m, v)."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat = m / den1
    vhat = v / den2
    return params - lr * mhat / (torch.sqrt(vhat) + 1e-8), m, v


def _adam_step(f_g, params, m, v, t: int, lr):
    """One Adam step at step index ``t`` (counted from 1)."""
    f, g = f_g(params)
    return (f,) + _adam(g, params, m, v, *_bias_denominators(t, params.device), lr)


def _best_improved(f, best_f, f0, stop_tol):
    """Did this iterate beat the best so far by more than ``stop_tol`` of
    the level's total descent (floored at 1%% of the metric's magnitude)?
    See the JAX package's ``_best_improved``."""
    scale = torch.maximum(f0 - best_f, 0.01 * torch.abs(best_f))
    return f < best_f - stop_tol * torch.clamp(scale, min=1e-12)


def _track_best(f, params, best_f, best_p, t_best, f0, t1, tol, stop_window: int):
    """The plateau exit's bookkeeping after the iterate ``params`` scored
    ``f`` at step ``t1`` (a Python int or a device counter): (new t_best,
    best_f, best_p, running). A warm start AT the optimum makes Adam
    wander, so the level returns where the metric was best."""
    new_t_best = torch.where(_best_improved(f, best_f, f0, tol), t1, t_best)
    better = f < best_f
    new_best_f = torch.where(better, f, best_f)
    new_best_p = torch.where(better[:, None], params, best_p)
    running = torch.any((t1 - new_t_best) < stop_window)
    return new_t_best, new_best_f, new_best_p, running


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
        new_t_best, new_best_f, new_best_p, running = _track_best(
            f, params, best_f, best_p, t_best, f0, t1, tol, stop_window)
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


# ------------------------------------------------- the levels as graph steps
# The two level loops above, rewritten as a step that updates preallocated
# buffers in place, with the step index a device counter: on the card the
# step is captured once per level as a CUDA graph and replayed once per
# iteration (the JAX package's lax.while_loop / lax.scan); the CPU tests
# drive the same step eagerly against the loops above.
_BIAS_TABLES: dict = {}


def _bias_table(iters: int, dev) -> torch.Tensor:
    """(iters, 2) Adam bias-correction denominators for steps 1..iters, each
    row computed by ``_bias_denominators`` itself, so a step that looks its
    row up by a device counter divides by the eager loop's bits (no
    ``pow`` by a tensor exponent, whose rounding need not match ``pow`` by
    a Python int). Kept per device; a longer table serves a shorter level."""
    table = _BIAS_TABLES.get(dev)
    if table is None or table.shape[0] < iters:
        table = torch.stack([torch.stack(_bias_denominators(t, dev))
                             for t in range(1, iters + 1)])
        _BIAS_TABLES[dev] = table
    return table


def _level_buffers(params, iters: int):
    """The level loop's state: the iterate, Adam's moments, the step
    counter and the (iters, P) history, plus the plateau exit's state."""
    dev, P = params.device, params.shape[0]
    return dict(
        params=params.clone(), m=torch.zeros_like(params), v=torch.zeros_like(params),
        t=torch.zeros((), dtype=torch.int64, device=dev),
        hist=torch.zeros((iters, P), dtype=torch.float32, device=dev),
        best_f=torch.full((P,), float("inf"), dtype=torch.float32, device=dev),
        best_p=params.clone(), t_best=torch.zeros((P,), dtype=torch.int64, device=dev),
        t_end=torch.zeros((), dtype=torch.int64, device=dev),
        active=torch.ones((), dtype=torch.bool, device=dev),
        f0=torch.zeros((P,), dtype=torch.float32, device=dev))


def _adam_on_buffers(b, f_g, table, lr):
    """One Adam step on the buffers; returns (f, new params, m, v) and
    leaves the buffers unchanged."""
    f, g = f_g(b["params"])
    # index_select, not table[t]: indexing by a 0-dim tensor reads it on the host
    den = table.index_select(0, b["t"].view(1))[0]
    return (f,) + _adam(g, b["params"], b["m"], b["v"], den[0], den[1], lr)


def _scan_step(b, f_g, table, lr):
    """One iteration of ``_level_scan`` on the buffers ``b``, in place."""
    f, params, m, v = _adam_on_buffers(b, f_g, table, lr)
    b["hist"].index_copy_(0, b["t"].view(1), f[None])
    for name, new in (("params", params), ("m", m), ("v", v)):
        b[name].copy_(new)
    b["t"].add_(1)


def _while_step(b, f_g, table, lr, tol, stop_window: int, first: bool):
    """One iteration of ``_level_while`` on the buffers ``b``, in place
    (``first``: the level's first step, which sets f0)."""
    f, new_params, new_m, new_v = _adam_on_buffers(b, f_g, table, lr)
    if first:
        b["f0"].copy_(f)
    t1 = b["t"] + 1
    active = b["active"]
    new_t_best, new_best_f, new_best_p, running = _track_best(
        f, b["params"], b["best_f"], b["best_p"], b["t_best"], b["f0"], t1, tol, stop_window)
    for name, new in (("params", new_params), ("m", new_m), ("v", new_v),
                      ("t_best", new_t_best), ("best_f", new_best_f), ("best_p", new_best_p)):
        b[name].copy_(torch.where(active, new, b[name]))
    b["hist"].index_copy_(0, b["t"].view(1), torch.where(active, f, b["best_f"])[None])
    b["t_end"].add_(active.to(torch.int64))
    active.logical_and_(running)
    b["t"].add_(1)


def _run_steps(first, step, n: int, graph: bool, dev, stop=None):
    """Run a level's ``n`` iterations: ``first()`` then ``step()`` for the
    rest, eagerly, or with ``graph`` as ``first`` on a side stream, then
    ``step`` captured and replayed. ``stop`` (a 0-dim bool tensor that is
    False once the level has stopped) is read on the host every
    ``_CHECK_EVERY`` iterations; returns the number of those reads."""
    if n == 0:
        return 0
    syncs = 0
    if graph and n > 1:
        step = graphs.capture(step, first, dev)
    else:
        first()
    for i in range(1, n):
        if stop is not None and i % _CHECK_EVERY == 0:
            syncs += 1
            if not bool(stop):
                break
        step()
    return syncs


def _level_scan_steps(f_g, params, lr, iters: int, graph: bool):
    """``_level_scan`` through the in-place ``_scan_step`` (``graph``: one
    CUDA graph per level, replayed per iteration)."""
    b = _level_buffers(params, iters)
    table = _bias_table(iters, params.device)

    def step():
        _scan_step(b, f_g, table, lr)

    _run_steps(step, step, iters, graph, params.device)
    return b["params"], b["hist"]


def _level_while_steps(f_g, params, lr, iters: int, stop_tol: float, stop_window: int,
                       graph: bool):
    """``_level_while`` through the in-place ``_while_step``, with the same
    host read of the active flag every ``_CHECK_EVERY`` iterations and the
    same results (``graph``: one CUDA graph per level, replayed per
    iteration; its first step runs eagerly, as the capture's warm-up)."""
    dev = params.device
    b = _level_buffers(params, iters)
    table = _bias_table(iters, dev)
    tol = torch.tensor(stop_tol, dtype=torch.float32, device=dev)
    syncs = _run_steps(lambda: _while_step(b, f_g, table, lr, tol, stop_window, True),
                       lambda: _while_step(b, f_g, table, lr, tol, stop_window, False),
                       iters, graph, dev, stop=b["active"])
    hist = torch.where(torch.arange(iters, device=dev)[:, None] >= b["t_end"],
                       b["best_f"][None, :], b["hist"])
    return b["best_p"], hist, b["t_end"], b["best_f"], syncs


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
    if len(movings) == 0:
        return []
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
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
    # a level on one card runs as a CUDA graph of one step; a mesh's metric
    # adds partial sums across devices, so its levels stay eager loops
    graph = mesh is None and dev.type == "cuda"
    hist, n_exec, final_f, syncs = [], ([] if stop_tol is not None else None), None, 0
    for li, ((f_dat, f_sp), n_smp, mlvl) in enumerate(zip(f_pyr, samples, mask_pyr)):
        fixed_pts, fixed_vals = _fixed_level_operands(fixed, f_dat, f_sp, int(n_smp), mlvl)
        if mesh is not None:
            fixed_pts, fixed_vals = _shard_samples(fixed_pts, fixed_vals, mesh)
        mov = _moving_level_operands(movings, m_pyrs, li)
        met = _make_metric_fn(metric, tf, fixed_pts, fixed_vals, mov, mesh)
        f_g = lambda p, met=met: _value_and_grad(met, p)
        if stop_tol is None:
            params, h = (_level_scan_steps(f_g, params, lr_t, int(iters[li]), graph=True)
                         if graph else _level_scan(f_g, params, lr_t, int(iters[li])))
        else:
            params, h, t_end, final_f, k = (
                _level_while_steps(f_g, params, lr_t, int(iters[li]), float(stop_tol), window,
                                   graph=True) if graph else
                _level_while(f_g, params, lr_t, int(iters[li]), float(stop_tol), window))
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
    optimizer); ``iters`` is the per-level budget either way. ``mesh`` (a
    ``parallel.VoxelMesh``) splits the metric's fixed-image samples over
    its devices (see ``_make_metric_fn``) and replaces ``device``: the
    solve and its result live on the mesh's first device. On one CUDA
    device each pyramid level runs as one captured CUDA graph step replayed
    per iteration; over a mesh the levels run as eager loops."""
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
