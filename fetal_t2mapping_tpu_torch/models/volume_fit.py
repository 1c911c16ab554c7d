"""Masked volume fit on the device: a 4-D echo volume in, parameter maps out.

The counterpart of ``fetal_t2mapping_tpu.models.volume_fit`` (the serving
wrapper). ``fit_stack`` gathers masked voxels on the host, fits them and
scatters the results back on the host; a serving loop instead uploads the
echo volume once, selects the masked voxels on the device, runs the fused
fit (``fused_fit.fit_fused``: the CUDA kernels on a CUDA tensor) and
builds dense maps there, without a host round trip.

Three layouts give the same per-voxel results (each kernel freezes a voxel
once it has converged, so grouping never changes an iterate):

- dense (``compact=False``): every voxel of the volume is fitted, with a
  trivially convergent filler signal outside the mask; no partition, no
  gather, no scatter;
- block compaction (``compact=True``, ``block`` 32): the masked blocks of
  ``block`` consecutive flat voxels are moved to the front by a stable
  device partition (``solver._tail_partition``) into a buffer of static
  capacity (``mask_frac`` of the volume), fitted with the filler in their
  unmasked voxels, and scattered back a block per row;
- voxel-exact (``compact=True, block=1``): the same with one voxel per
  block.

``compact='auto'`` picks between dense and block compaction per model from
the mask fraction (``resolve_compact``), at crossovers measured on an H100
(``chip_smoke.py`` phase 13; ``PERF.md``). Masked blocks beyond the
capacity are left unfitted (map 0, converged False) and their masked
voxels counted in ``n_overflow``. Nothing here reads the device from the
host, except the optional capacity check (one 4-byte read) and, with
``strategy='twophase'``, the fit's rounds (one 4-byte read each), both
through ``profiler.host_read``.

Under a profiler a request records its spans (``utils.profiling``): the
root ``fit_volume`` (model, layout, grid_voxels, capacity_rows), then
``fit_volume.prepare`` (arguments, inputs to the device, ``compact``, the
capacity check ``fit_volume.capacity_check`` with its ``host_read``, the
filler), ``fit_volume.compact`` or ``fit_volume.dense_select``,
``fit_fused`` and ``fit_volume.scatter``.

Over a voxel mesh (``mesh=``, a ``parallel.VoxelMesh``) the partition,
gather, filler and scatter stay on the mesh's first device, and only the
dense batch the layout built is split: padded with filler rows to
``pad_to_devices`` and fitted by ``fit_fused_sharded``, one contiguous
shard per mesh entry. The volume is not cut into z slabs, which would leave
the end shards of an ellipsoidal brain mask nearly empty. Capacity stays
global, so under 'single' every map, ``n_masked`` and ``n_overflow`` equal
the single-device call's bitwise; under 'twophase' each shard runs its own
refit rounds.
"""

from __future__ import annotations

import warnings
from math import gcd
from math import prod
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import NO_SPAN, profiler
from .fused_fit import (fit_fused, resolve_strategy, resolve_varpro3,
                        validate_fused_args)
from .solver import _tail_partition


class VolumeFitResult(NamedTuple):
    """Dense maps on the fit's device: 0 (False) outside the mask."""
    t2: torch.Tensor          # (Z, Y, X) float32
    k: torch.Tensor           # (Z, Y, X)
    sigma: torch.Tensor       # (Z, Y, X); zeros for the 2-parameter model
    fun: torch.Tensor         # (Z, Y, X) final objective
    converged: torch.Tensor   # (Z, Y, X) bool
    n_iter: torch.Tensor      # (Z, Y, X) int32
    n_masked: torch.Tensor    # () int32: voxels selected by the mask
    n_overflow: torch.Tensor  # () int32: masked voxels beyond capacity (unfitted)


# mask_frac from which the dense layout is as fast as block compaction, per
# fit: measured on an NVIDIA H100 80GB HBM3 at 700 W over 240^3 x 3-TE
# requests with ~5%, 22% and ~50% ellipsoid masks, mask_frac 6% above the
# touched blocks (chip_smoke.py phase 13; PERF.md section 6). The
# dense layout costs about the same at any mask (every voxel goes through
# the fits' first pass); compaction grows with the mask. The JAX package's
# crossovers were measured on a TPU and are not carried over.
_DENSE_CROSSOVER_FRAC = {"gaussian": 0.30, "gaussian_rician": 0.44, "rician": 0.67}
_DENSE_CROSSOVER_VARPRO_GR = 0.29


def resolve_compact(compact, model: str, mask_frac: float, varpro3=None) -> bool:
    """Resolve fit_volume's ``compact`` knob ('auto' | bool) -> bool.

    ``varpro3`` mirrors fit_volume's knob (None = env/default): the
    gaussian_rician VARPRO kernel has its own crossover."""
    if compact == "auto":
        if model == "gaussian_rician" and resolve_varpro3(varpro3, model):
            cross = _DENSE_CROSSOVER_VARPRO_GR
        else:
            cross = _DENSE_CROSSOVER_FRAC[model]
        return float(mask_frac) < cross
    if isinstance(compact, bool):
        return compact
    raise ValueError(f"compact must be 'auto' or a bool; got {compact!r}")


def _capacity(n: int, mask_frac: float) -> int:
    """Masked-voxel budget: int(n * mask_frac) rounded up to a multiple of
    128 (rounding down would leave some masks uncoverable at any
    mask_frac <= 1)."""
    return max(128, -(-int(n * float(mask_frac)) // 128) * 128)


def _block_capacity(n: int, mask_frac: float, block: int) -> int:
    """Block-buffer size: enough ``block``-voxel blocks to hold the voxel
    budget, rounded so that blk_cap * block is a multiple of 128 (the
    reference's batch granularity, kept so both packages fit the same
    batch)."""
    blk_cap = -(-_capacity(n, mask_frac) // block)
    quantum = 128 // gcd(block, 128)
    return -(-blk_cap // quantum) * quantum


def _count_touched_blocks(mask: torch.Tensor, n: int, block: int) -> torch.Tensor:
    """() int32 device count of the ``block``-voxel blocks holding a masked voxel."""
    flat = mask.reshape(n) > 0
    n_pad = -(-n // block) * block
    if n_pad != n:
        flat = torch.nn.functional.pad(flat, (0, n_pad - n))
    return flat.reshape(n_pad // block, block).any(dim=1).sum(dtype=torch.int32)


def _min_mask_frac(n: int, n_blocks: int, block: int) -> float:
    """Smallest mask_frac whose _block_capacity covers ``n_blocks`` blocks
    (n_masked / n undercounts: capacity is taken by whole blocks)."""
    needed = -(-n_blocks * block // 128) * 128
    frac = min(needed / n, 1.0)
    if _block_capacity(n, frac, block) * block < min(needed, n_blocks * block):
        raise AssertionError("block capacity does not cover the blocks it was sized for")
    return frac


def _filler(te, lo, hi, guess, dev: torch.device) -> torch.Tensor:
    """The signal fitted in unmasked voxels of kept blocks and of the dense
    layout: the exact decay at the bound-clamped guess, so it converges in
    a step or two and its (discarded) fit costs almost nothing. Computed on
    the host and written with scalar fills: a host-to-device copy of
    pageable memory would wait for the device."""
    fk = min(max(guess[0], lo[0], 1.0), hi[0])
    ft2 = min(max(guess[1], lo[1], 1e-3), hi[1])
    te32 = np.asarray(te, np.float32)
    values = np.float32(fk) * np.exp(-te32 / np.float32(ft2))
    out = torch.empty(len(te), dtype=torch.float32, device=dev)
    for i, value in enumerate(values):
        out[i] = float(value)
    return out


def _batch_buffer(rows: int, t_axis: int, filler: torch.Tensor, mesh) -> torch.Tensor:
    """The (N', T) fit batch: N' = ``rows``, or over a mesh the padded
    count ``pad_to_devices(rows, mesh)`` with the filler in rows >= rows.
    The caller writes rows [0, rows); every write is on the caller's
    stream, which the shards' streams wait for."""
    n_fit = rows
    if mesh is not None:
        from ..parallel.mesh import pad_to_devices

        n_fit = pad_to_devices(rows, mesh)
    buf = torch.empty((n_fit, t_axis), dtype=torch.float32, device=filler.device)
    if n_fit != rows:
        buf[rows:] = filler
    return buf


def _fit(batch: torch.Tensor, rows: int, fit_kw: dict, mesh):
    """The fused fit of a device batch, without waiting for the device, on
    its device or sharded over ``mesh``: (t2, k, sigma, fun, converged,
    n_iter), each of the first ``rows`` rows, and the fit's own n_overflow
    (0 for 'single'; a () int32 tensor for 'twophase', summed over shards)."""
    if mesh is None:
        res = fit_fused(batch, sync=False, device=batch.device, **fit_kw)
    else:
        from ..parallel.mesh import fit_fused_sharded

        res = fit_fused_sharded(batch, mesh=mesh, sync=False, **fit_kw)
    x = res.x[:rows]
    sigma = x[:, 2] if x.shape[1] == 3 else torch.zeros_like(x[:, 0])
    return (x[:, 1], x[:, 0], sigma, res.fun[:rows], res.converged[:rows],
            res.n_iter[:rows]), res.n_overflow


def _fit_dense(signal, sel, filler, fit_kw, mesh) -> VolumeFitResult:
    """Every voxel through the fit, filler outside the mask; results come
    back in voxel order and the maps are masked reshapes."""
    zyx = signal.shape[:3]
    n = sel.shape[0]
    with profiler.span("fit_volume.dense_select"):
        flat = signal.reshape(n, signal.shape[3])
        batch = _batch_buffer(n, signal.shape[3], filler, mesh)
        torch.where(sel[:, None], flat, filler, out=batch[:n])
    (t2, k, sigma, fun, conv, nit), inner_overflow = _fit(batch, n, fit_kw, mesh)
    with profiler.span("fit_volume.scatter"):
        selz = sel.reshape(zyx)

        def chan(v):
            return torch.where(selz, v.reshape(zyx), 0)

        return VolumeFitResult(
            t2=chan(t2), k=chan(k), sigma=chan(sigma), fun=chan(fun),
            converged=conv.reshape(zyx) & selz, n_iter=chan(nit),
            n_masked=sel.sum(dtype=torch.int32),
            # no capacity to overflow; the filler converges at once, so what
            # a 'twophase' fit could not refit is masked voxels
            n_overflow=torch.zeros((), dtype=torch.int32, device=signal.device)
            + inner_overflow)


def _fit_compact(signal, sel, filler, fit_kw, mesh, *, blk_cap: int,
                 block: int) -> VolumeFitResult:
    """Block compaction: the masked blocks (up to the static capacity of
    ``blk_cap`` blocks) are gathered in a stable order, fitted, and
    scattered back one block per row. Buffer slots past the number of
    masked blocks write to a spare row that is dropped, so no row is
    written twice with different data."""
    zyx = signal.shape[:3]
    t_axis = signal.shape[3]
    n = prod(zyx)
    n_pad = -(-n // block) * block
    nb = n_pad // block
    rows = blk_cap * block
    with profiler.span("fit_volume.compact"):
        flat = signal.reshape(n, t_axis)
        if n_pad != n:
            flat = torch.nn.functional.pad(flat, (0, 0, 0, n_pad - n), value=1.0)
            sel = torch.nn.functional.pad(sel, (0, n_pad - n))
        # _tail_partition puts the unconverged first: masked blocks play that role
        bidx, nb_sel = _tail_partition(~sel.reshape(nb, block).any(dim=1), blk_cap)
        batch = flat.reshape(nb, block * t_axis)[bidx].reshape(blk_cap, block, t_axis)
        mb = sel.reshape(nb, block)[bidx]                         # (blk_cap, block)
        buf = _batch_buffer(rows, t_axis, filler, mesh)
        torch.where(mb[..., None], batch, filler, out=buf[:rows].view(blk_cap, block, t_axis))
    (t2, k, sigma, fun, conv, nit), inner_overflow = _fit(buf, rows, fit_kw, mesh)

    with profiler.span("fit_volume.scatter"):
        valid_blk = torch.arange(blk_cap, device=signal.device) < nb_sel
        keep = mb & valid_blk[:, None]
        upd = torch.stack([t2, k, sigma, fun, conv.to(torch.float32),
                           nit.to(torch.float32)], dim=1)
        upd = torch.where(keep.reshape(-1, 1), upd, 0.0)
        safe_bidx = torch.where(valid_blk, bidx, nb)              # nb: the spare row
        dense = torch.zeros((nb + 1, block * 6), dtype=torch.float32, device=signal.device)
        dense.index_copy_(0, safe_bidx, upd.reshape(blk_cap, block * 6))
        dense = dense[:nb].reshape(nb, block, 6)

        def chan(c):
            return dense[:, :, c].reshape(n_pad)[:n].reshape(zyx)

        n_masked = sel.sum(dtype=torch.int32)
        return VolumeFitResult(
            t2=chan(0), k=chan(1), sigma=chan(2), fun=chan(3),
            converged=chan(4) > 0.5, n_iter=chan(5).to(torch.int32),
            # masked voxels beyond the buffer, plus those the fit's own
            # 'twophase' rounds could not refit
            n_masked=n_masked,
            n_overflow=n_masked - keep.sum(dtype=torch.int32) + inner_overflow)


def _fit_device(mesh, device) -> torch.device:
    """fit_volume's device: ``device`` ('cuda' by default), or with a mesh
    its first device, which a ``device`` given beside it must name."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    dev0 = mesh.devices[0]

    def indexed(d: torch.device) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device()) \
            if d.type == "cuda" and d.index is None else d

    if device is not None:
        dev = resolve_device(device)
        if indexed(dev) != indexed(dev0):
            raise ValueError(f"device {str(dev)!r} is not the mesh's first device "
                             f"{str(dev0)!r}, where fit_volume(mesh=) returns its maps")
    return dev0


def fit_volume(signal, mask, te, lo, hi, *, model: str = "gaussian",
               guess: Sequence[float] | None = None, max_iters: int = 60,
               ftol: float = 1e-9, gtol: float = 0.0, no_prior: bool = False,
               mask_frac: float = 0.25, block: int = 32, compact="auto",
               check_capacity: bool = True, prefix3=None, varpro3=None,
               strategy: str = "auto", phase1_iters: int = 10, tail_frac=None,
               mesh=None, device=None) -> VolumeFitResult:
    """Fit every masked voxel of a (Z, Y, X, T) echo volume on the device.

    Args:
        signal: (Z, Y, X, T) float32 echo volume (numpy or tensor); moved to
            ``device`` if it is not there.
        mask: (Z, Y, X) boolean / {0, 1} mask.
        te / lo / hi / model / guess / max_iters / ftol / gtol / no_prior /
            prefix3 / varpro3 / strategy / phase1_iters / tail_frac: as in
            ``fused_fit.fit_fused`` (the 'twophase' rounds at their default
            count and block; their host reads are the only ones the call
            makes besides ``check_capacity``'s).
        mask_frac: static capacity of the compacted buffer as a fraction of
            the volume. Partially masked blocks take whole-block capacity,
            so budget above the exact masked fraction (the capacity warning
            states what is needed).
        block: compaction granularity in flat voxels; 1 is voxel-exact.
        compact: 'auto' (default) | bool. False fits every voxel, with the
            filler outside the mask, and has no capacity to overflow.
            'auto' goes dense above the model's measured crossover
            (``resolve_compact``). Per-voxel results are identical.
        check_capacity: compacted layouts only — count the touched blocks
            and warn before fitting if they exceed the capacity (one 4-byte
            read from the device). Pipelined loops pass False and watch
            ``result.n_overflow``.
        mesh: a ``parallel.VoxelMesh``: the layout's batch is fitted
            sharded over it (``fit_fused_sharded``) and everything else runs
            on ``mesh.devices[0]``. Under 'single' the result equals the
            single-device call's bitwise; under 'twophase' each shard runs
            its own refit rounds, so the refit part of ``n_overflow`` is
            per shard.
        device: 'cuda' (the default without a mesh) runs the CUDA kernels,
            'cpu' their plain versions. With a mesh it defaults to, and
            must be, ``mesh.devices[0]``.

    Returns:
        VolumeFitResult of dense maps on the fit's device (``device`` or
        ``mesh.devices[0]``) and the () int32 counts n_masked and
        n_overflow, without waiting for the device.
    """
    with profiler.request("fit_volume", model=model) as request:
        with profiler.span("fit_volume.prepare"):
            te_t, lo_t, hi_t, guess_t = validate_fused_args(model, te, lo, hi, guess, no_prior)
            resolve_strategy(strategy)
            if block < 1:
                raise ValueError(f"block must be >= 1; got {block}")
            dev = _fit_device(mesh, device)
            signal = torch.as_tensor(signal, dtype=torch.float32, device=dev)
            if signal.dim() != 4:
                raise ValueError(f"signal must be (Z, Y, X, T); got {tuple(signal.shape)}")
            mask = torch.as_tensor(mask, device=dev)
            if tuple(mask.shape) != tuple(signal.shape[:3]):
                raise ValueError(f"mask {tuple(mask.shape)} != volume grid "
                                 f"{tuple(signal.shape[:3])}")
            n = prod(signal.shape[:3])
            compact = resolve_compact(compact, model, mask_frac, varpro3)
            blk_cap = _block_capacity(n, mask_frac, block) if compact else 0
            if request is not NO_SPAN:
                request.set(layout="block" if compact else "dense", grid_voxels=n,
                            capacity_rows=blk_cap * block if compact else n)
            if check_capacity and compact:
                # before the mask and filler kernels below: the read waits for
                # the device, which then runs those while the host goes on
                with profiler.span("fit_volume.capacity_check"):
                    n_blocks = profiler.host_read(_count_touched_blocks(mask, n, block))
                    if n_blocks > blk_cap:
                        warnings.warn(
                            f"mask touches {n_blocks} blocks of {block} voxels but "
                            f"mask_frac={mask_frac} caps the fit buffer at {blk_cap} "
                            f"blocks: masked voxels in {n_blocks - blk_cap} blocks will "
                            f"be left unfitted (n_overflow); raise mask_frac to "
                            f">= {_min_mask_frac(n, n_blocks, block):.6f}", stacklevel=2)
            fit_kw = dict(te=te_t, lo=lo_t, hi=hi_t, model=model, guess=guess_t,
                          max_iters=max_iters, ftol=ftol, gtol=gtol, no_prior=no_prior,
                          strategy=strategy, prefix3=prefix3, varpro3=varpro3,
                          phase1_iters=phase1_iters, tail_frac=tail_frac)
            sel = mask.reshape(n) > 0
            filler = _filler(te_t, lo_t, hi_t, guess_t, dev)
        if not compact:
            return _fit_dense(signal, sel, filler, fit_kw, mesh)
        return _fit_compact(signal, sel, filler, fit_kw, mesh, blk_cap=blk_cap,
                            block=int(block))
