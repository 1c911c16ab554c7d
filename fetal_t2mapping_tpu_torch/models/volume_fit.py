"""Masked volume fit on the device: a 4-D echo volume in, parameter maps out.

The counterpart of ``fetal_t2mapping_tpu.models.volume_fit`` (the serving
wrapper). ``fit_stack`` gathers masked voxels on the host, fits them and
scatters the results back on the host; a serving loop instead uploads the
echo volume once, selects the masked voxels on the device, runs the fused
fit (``fused_fit.fit_fused``: the CUDA kernels on a CUDA tensor) and
builds dense maps there, without a host round trip.

One layout, block compaction: each block of ``block`` (32) consecutive
flat voxels holding a masked voxel gets the next slot of a fit buffer, in
ascending block order (a stable partition), with a filler signal in the
blocks' unmasked voxels (``_filler_values``), and the maps are written
through the same block -> slot map. ``block=1`` is voxel-exact. On a CUDA
tensor both halves are hand-written kernels
(``csrc/volume_layout.cu``: the compaction and the scatter, counted in
``volume_layout.compact.launches`` and ``volume_layout.scatter.launches``);
on a CPU tensor their plain versions ``_compact_plain`` / ``_scatter_plain``.
Each kernel freezes a voxel once it has converged, so the grouping never
changes an iterate: every block size and capacity gives the same bits.

The buffer has one of two capacities:

- ``mask_frac`` of the volume (``compact`` True or 'auto'): masked blocks
  beyond it are left unfitted (map 0, converged False) and their masked
  voxels counted in ``n_overflow``; the optional capacity check reads the
  touched-block count (one 4-byte read) and warns before the fit;
- every block of the grid (``compact=False``): nothing can overflow, so
  there is no check and no read.

On one device under 'single' the fit stops at the touched blocks' rows: it
reads the compaction's count on the device (``fit_fused``'s live-row
bound), so the slots past it, which no map reads, are not fitted. A pass
of the 3-start multistart (``fused_fit.takes_row_list``: rician, or
gaussian_rician with ``varpro3`` off, as resolved) takes a row list
instead: the compaction also lists the buffer rows that take a kept
masked voxel, the rows the scatter reads, and the fit runs densely over
that list, so the filler inside the touched blocks is not fitted either. Nothing here reads the
device from the host, except the capacity check and, with
``strategy='twophase'``, the fit's rounds (one 4-byte read each), both
through ``profiler.host_read``.

Under a profiler a request records its spans (``utils.profiling``): the
root ``fit_volume`` (model, grid_voxels, capacity_rows, and with the
capacity check live_rows, the rows of the touched blocks, and fitted_rows,
the rows the fit runs over: the row list's length where there is one,
else live_rows; both from the check's read), then
``fit_volume.prepare`` (arguments, inputs to the device),
``fit_volume.compact``, the capacity check ``fit_volume.capacity_check``
with its one ``host_read`` of the compaction's touched-block count (under
a span, of its first three counts: touched blocks, masked voxels, masked
voxels kept), ``fit_fused`` and ``fit_volume.scatter``.

Over a voxel mesh (``mesh=``, a ``parallel.VoxelMesh``) the compaction,
filler and scatter stay on the mesh's first device, and only the
buffer is split: padded with filler rows to ``pad_to_devices`` and fitted
by ``fit_fused_sharded``, one contiguous shard per mesh entry. The volume
is not cut into z slabs, which would leave the end shards of an
ellipsoidal brain mask nearly empty. Capacity stays global, so under
'single' every map, ``n_masked`` and ``n_overflow`` equal the
single-device call's bitwise; under 'twophase' each shard runs its own
refit rounds.
"""

from __future__ import annotations

import functools
import warnings
from math import gcd
from math import prod
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import build
from ..device import resolve_device
from ..utils.profiling import NO_SPAN, profiler
from .fused_fit import (_MAX_TE, fit_fused, resolve_strategy, takes_row_list,
                        validate_fused_args)
from .solver import FitResult


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


def _min_mask_frac(n: int, n_blocks: int, block: int) -> float:
    """Smallest mask_frac whose _block_capacity covers ``n_blocks`` blocks
    (n_masked / n undercounts: capacity is taken by whole blocks)."""
    needed = -(-n_blocks * block // 128) * 128
    frac = min(needed / n, 1.0)
    if _block_capacity(n, frac, block) * block < min(needed, n_blocks * block):
        raise AssertionError("block capacity does not cover the blocks it was sized for")
    return frac


@functools.lru_cache(maxsize=64)
def _filler_values(te: tuple, lo: tuple, hi: tuple, guess: tuple) -> np.ndarray:
    """The signal in the unmasked voxels of kept blocks and in a mesh's
    padding rows, (T,) float32 on the host: the exact decay at the
    bound-clamped guess. No map reads its fit, but it is not cheap under
    every box: under the 1.5 T rician prior box it runs all 4 prefix
    iterations of all 3 starts and stops at n_iter 6. So the 3-start
    multistart on one device does not fit it (the compaction's row list);
    the gaussian and VARPRO kernels and a mesh still do."""
    fk = min(max(guess[0], lo[0], 1.0), hi[0])
    ft2 = min(max(guess[1], lo[1], 1e-3), hi[1])
    te32 = np.asarray(te, np.float32)
    values = np.float32(fk) * np.exp(-te32 / np.float32(ft2))
    values.setflags(write=False)
    return values


def _filler(te, lo, hi, guess, dev: torch.device) -> torch.Tensor:
    """``_filler_values`` on ``dev``, written with scalar fills: a
    host-to-device copy of pageable memory would wait for the device."""
    values = _filler_values(tuple(te), tuple(lo), tuple(hi), tuple(guess))
    out = torch.empty(len(values), dtype=torch.float32, device=dev)
    for i, value in enumerate(values):
        out[i] = float(value)
    return out


def _batch_buffer(rows: int, t_axis: int, dev: torch.device, mesh, filler_args) -> torch.Tensor:
    """The (N', T) fit batch: N' = ``rows``, or over a mesh the padded count
    ``pad_to_devices(rows, mesh)``, whose rows >= rows hold the filler. The
    caller writes rows [0, rows); every write is on the caller's stream,
    which the shards' streams wait for."""
    if mesh is None:
        return torch.empty((rows, t_axis), dtype=torch.float32, device=dev)
    from ..parallel.mesh import pad_to_devices

    buf = torch.empty((pad_to_devices(rows, mesh), t_axis), dtype=torch.float32, device=dev)
    if buf.shape[0] != rows:
        buf[rows:] = _filler(*filler_args, dev)
    return buf


def _fit(batch: torch.Tensor, fit_kw: dict, mesh, row_bound=None, row_list=None) -> FitResult:
    """The fused fit of a device batch, without waiting for the device, on
    its device or sharded over ``mesh``. Its n_overflow is 0 for 'single'
    and a () int32 tensor for 'twophase' (summed over shards).
    ``row_bound``, ``row_list``: fit_fused's live-row bound and row list
    (one device only)."""
    if mesh is None:
        return fit_fused(batch, sync=False, device=batch.device, _row_bound=row_bound,
                         _row_list=row_list, **fit_kw)
    from ..parallel.mesh import fit_fused_sharded

    return fit_fused_sharded(batch, mesh=mesh, sync=False, **fit_kw)


# ------------------------------------------------- the block layout's two halves
def _compact_plain(flat, mask, filler, blk_cap: int, block: int, buf, row_list=None):
    """Plain version of ``ft2_layout_compact`` (csrc/volume_layout.cu).

    ``flat``: (n, T) echoes; ``mask``: (n,), nonzero = masked; ``filler``:
    (T,) host float32. Each block of ``block`` consecutive voxels holding a
    masked voxel gets the next slot in ascending block order (a stable
    partition), up to ``blk_cap`` slots; buffer row ``slot * block + j``
    takes voxel ``j`` of the slot's block where it is masked, the filler
    elsewhere, past n on a ragged last block and in slots past the touched
    count (slots past the last block hold block 0, as the stable
    partition's order was padded). Writes ``buf[:blk_cap * block]`` and,
    given ``row_list`` (>= blk_cap * block int32), the buffer rows that
    take a kept masked voxel, the rows the scatter reads, ascending into
    ``row_list[:counts[2]]``; returns (the block -> slot map, (nb,) int32,
    -1 for a block not in the buffer; counts, (3,) int32: touched blocks,
    masked voxels, masked voxels kept)."""
    n = flat.shape[0]
    dev = flat.device
    nb = -(-n // block)
    sel = torch.nn.functional.pad(mask.reshape(n) != 0, (0, nb * block - n))
    cnt = sel.reshape(nb, block).sum(dim=1, dtype=torch.int32)
    touched = cnt > 0
    order = torch.cumsum(touched, 0, dtype=torch.int32) - touched.to(torch.int32)
    kept = touched & (order < blk_cap)
    slot = torch.where(kept, order, -1)
    src = torch.full((blk_cap,), -1, dtype=torch.int64, device=dev)
    src[slot[kept].long()] = torch.arange(nb, device=dev)[kept]
    src[nb:] = 0
    v = (src.clamp(min=0)[:, None] * block + torch.arange(block, device=dev)).reshape(-1)
    take = (src >= 0).repeat_interleave(block) & sel[v]
    torch.where(take[:, None], flat[v.clamp(max=n - 1)],
                torch.tensor(filler.tolist(), dtype=torch.float32, device=dev),
                out=buf[:blk_cap * block])
    if row_list is not None:     # slots past the last block repeat block 0: not read
        listed = torch.nonzero(take[:min(blk_cap, nb) * block]).reshape(-1)
        row_list[:listed.numel()] = listed.to(torch.int32)
    counts = torch.stack([touched.sum(dtype=torch.int32), cnt.sum(dtype=torch.int32),
                          (cnt * kept).sum(dtype=torch.int32)])
    return slot, counts


def _compact_cuda(flat, mask, filler, blk_cap: int, block: int, buf, row_list=None):
    """Launch ``ft2_layout_compact`` (csrc/volume_layout.cu: a memset and
    two kernels) on ``flat``'s device and stream; same outputs as
    ``_compact_plain``, the counts a view of the kernels' scratch, and
    the same rows in ``row_list[:counts[2]]``, in no set order."""
    lib = build.load_lib("volume_layout")
    n, t_axis = flat.shape
    dev = flat.device
    if t_axis > _MAX_TE:
        raise ValueError(f"the block layout takes up to {_MAX_TE} echoes; got {t_axis}")
    if (flat.dtype != torch.float32 or mask.dtype not in (torch.bool, torch.uint8)
            or mask.shape != (n,) or mask.device != dev):
        raise ValueError(f"need (n, T) float32 echoes and an (n,) byte mask on one device; "
                         f"got {flat.dtype} {tuple(flat.shape)}, {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if (buf.dtype != torch.float32 or not buf.is_contiguous() or buf.device != dev
            or buf.dim() != 2 or buf.shape[0] < blk_cap * block or buf.shape[1] != t_axis):
        raise ValueError(f"the buffer must be contiguous float32 of >= {blk_cap * block} "
                         f"rows of {t_axis} on {dev}")
    if row_list is not None and (row_list.dtype != torch.int32 or row_list.device != dev
                                 or not row_list.is_contiguous()
                                 or row_list.numel() < blk_cap * block):
        raise ValueError(f"the row list must be contiguous int32 of >= {blk_cap * block} "
                         f"entries on {dev}")
    work_ints = lib.ft2_layout_work_ints(n, block, blk_cap)
    if work_ints < 0:
        raise ValueError(f"the block layout takes grids and buffers under 2^31 voxels; got "
                         f"{n} voxels, {blk_cap} blocks of {block}")
    flat, mask = flat.contiguous(), mask.contiguous()
    slot = torch.empty(-(-n // block), dtype=torch.int32, device=dev)
    work = torch.empty(work_ints, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ft2_layout_compact(
            flat.data_ptr(), mask.data_ptr(), n, t_axis, block, blk_cap, filler.ctypes.data,
            buf.data_ptr(), slot.data_ptr(), work.data_ptr(), work_ints,
            None if row_list is None else row_list.data_ptr(), build.stream(dev))
    build.check_launch(err, "volume_layout compact")
    profiler.count("volume_layout.compact.launches")
    return slot, work[:4]


def _scatter_plain(mask, block: int, slot, res: FitResult, counts, zyx) -> VolumeFitResult:
    """Plain version of ``ft2_layout_scatter``: the six maps of the grid
    ``zyx``, a kept masked voxel (its block's ``slot`` >= 0) taking its fit
    row ``slot * block + j``, every other voxel 0 / False; n_masked and
    n_overflow (masked voxels not kept, plus the fit's own)."""
    n = prod(zyx)
    dev = mask.device
    vslot = slot.repeat_interleave(block)[:n]
    keep = (vslot >= 0) & (mask.reshape(n) != 0)
    row = torch.where(keep, vslot.long() * block + torch.arange(n, device=dev) % block, 0)

    def take(col, zero):
        return torch.where(keep, col[row], zero).reshape(zyx)

    x = res.x
    sigma = take(x[:, 2], 0.0) if x.shape[1] == 3 else torch.zeros(zyx, device=dev)
    return VolumeFitResult(
        t2=take(x[:, 1], 0.0), k=take(x[:, 0], 0.0), sigma=sigma, fun=take(res.fun, 0.0),
        converged=take(res.converged, False), n_iter=take(res.n_iter, 0),
        n_masked=counts[1], n_overflow=counts[1] - counts[2] + res.n_overflow)


def _scatter_cuda(mask, block: int, slot, res: FitResult, counts, zyx) -> VolumeFitResult:
    """Launch ``ft2_layout_scatter`` (csrc/volume_layout.cu, one kernel)
    on ``mask``'s device and stream: ``_scatter_plain``'s maps, written as
    fresh contiguous tensors; n_masked and n_overflow views of ``counts``,
    the compaction's scratch."""
    lib = build.load_lib("volume_layout")
    dev = mask.device
    x, inner = res.x, res.n_overflow
    for name, t, dtype in (("x", x, torch.float32), ("fun", res.fun, torch.float32),
                           ("converged", res.converged, torch.bool),
                           ("n_iter", res.n_iter, torch.int32)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"fit {name} must be {dtype} on {dev}; got {t.dtype} on {t.device}")
    if x.dim() != 2 or x.shape[1] not in (2, 3):
        raise ValueError(f"fit x must be (N, 2) or (N, 3); got {tuple(x.shape)}")
    if (mask.dtype not in (torch.bool, torch.uint8) or mask.dim() != 1
            or not mask.is_contiguous() or slot.dtype != torch.int32
            or slot.shape != (-(-mask.numel() // block),) or counts.dtype != torch.int32
            or counts.numel() < 4 or not counts.is_contiguous()):
        raise ValueError("mask, slot and counts must be the flat byte mask, the block map "
                         "and the scratch that _compact_cuda took and returned")
    inner_ptr, inner_value = None, 0
    if torch.is_tensor(inner):
        if inner.dtype != torch.int32 or inner.device != dev or inner.numel() != 1:
            raise ValueError(f"fit n_overflow must be a () int32 tensor on {dev}")
        inner_ptr = inner.data_ptr()
    else:
        inner_value = int(inner)
    maps = [torch.empty(zyx, dtype=dtype, device=dev) for dtype in
            (torch.float32,) * 4 + (torch.bool, torch.int32)]
    with torch.cuda.device(dev):
        err = lib.ft2_layout_scatter(
            mask.data_ptr(), mask.numel(), block, slot.data_ptr(), x.data_ptr(), x.stride(0),
            x.stride(1), x.shape[1], res.fun.data_ptr(), res.fun.stride(0),
            res.converged.data_ptr(), res.converged.stride(0), res.n_iter.data_ptr(),
            res.n_iter.stride(0), inner_ptr, inner_value, *[m.data_ptr() for m in maps],
            counts.data_ptr(), build.stream(dev))
    build.check_launch(err, "volume_layout scatter")
    profiler.count("volume_layout.scatter.launches")
    t2, k, sigma, fun, conv, nit = maps
    return VolumeFitResult(t2=t2, k=k, sigma=sigma, fun=fun, converged=conv, n_iter=nit,
                           n_masked=counts[1], n_overflow=counts[3])


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
        mask_frac: static capacity of the block buffer as a fraction of
            the volume. Partially masked blocks take whole-block capacity,
            so budget above the exact masked fraction (the capacity warning
            states what is needed).
        block: compaction granularity in flat voxels; 1 is voxel-exact.
        compact: 'auto' (default) or True: the buffer holds ``mask_frac``
            of the volume. False: it holds every block of the grid, so
            nothing can overflow and ``mask_frac`` and ``check_capacity``
            are not read. Per-voxel results are identical.
        check_capacity: count the touched blocks and warn before fitting if
            they exceed the capacity (one 4-byte read from the device).
            Pipelined loops pass False and watch ``result.n_overflow``.
        mesh: a ``parallel.VoxelMesh``: the buffer is fitted sharded over
            it (``fit_fused_sharded``) and everything else runs on
            ``mesh.devices[0]``. Under 'single' the result equals the
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
            if compact != "auto" and not isinstance(compact, bool):
                raise ValueError(f"compact must be 'auto' or a bool; got {compact!r}")
            dev = _fit_device(mesh, device)
            signal = torch.as_tensor(signal, dtype=torch.float32, device=dev)
            if signal.dim() != 4:
                raise ValueError(f"signal must be (Z, Y, X, T); got {tuple(signal.shape)}")
            mask = torch.as_tensor(mask, device=dev)
            if tuple(mask.shape) != tuple(signal.shape[:3]):
                raise ValueError(f"mask {tuple(mask.shape)} != volume grid "
                                 f"{tuple(signal.shape[:3])}")
            zyx, t_axis = signal.shape[:3], signal.shape[3]
            n, block = prod(zyx), int(block)
            if compact is False:         # a buffer over every block: nothing to check
                mask_frac, check_capacity = 1.0, False
            blk_cap = _block_capacity(n, mask_frac, block)
            rows = blk_cap * block
            if request is not NO_SPAN:
                request.set(grid_voxels=n, capacity_rows=rows)
            fit_kw = dict(te=te_t, lo=lo_t, hi=hi_t, model=model, guess=guess_t,
                          max_iters=max_iters, ftol=ftol, gtol=gtol, no_prior=no_prior,
                          strategy=strategy, prefix3=prefix3, varpro3=varpro3,
                          phase1_iters=phase1_iters, tail_frac=tail_frac)
            if mask.dtype not in (torch.bool, torch.uint8):
                mask = mask > 0      # the layout reads a mask of bytes, nonzero = masked
            filler_args = (te_t, lo_t, hi_t, guess_t)
            single = mesh is None and resolve_strategy(strategy) == "single"
            # the 3-start multistart runs over the kept masked voxels alone
            listed = single and takes_row_list(model, varpro3)
        cuda = dev.type == "cuda"
        with profiler.span("fit_volume.compact"):
            flat_mask = mask.reshape(n)
            buf = _batch_buffer(rows, t_axis, dev, mesh, filler_args)
            row_list = torch.empty(rows, dtype=torch.int32, device=dev) if listed else None
            slot, counts = (_compact_cuda if cuda else _compact_plain)(
                signal.reshape(n, t_axis), flat_mask, _filler_values(*filler_args), blk_cap,
                block, buf, row_list)
        if check_capacity:
            with profiler.span("fit_volume.capacity_check"):
                # one read; under a span it also takes the kept masked count
                if request is NO_SPAN:
                    n_blocks = profiler.host_read(counts[0])
                else:
                    n_blocks, _, n_kept = profiler.host_read(counts[:3])
                    live_rows = min(n_blocks, blk_cap) * block
                    request.set(live_rows=live_rows,
                                fitted_rows=n_kept if listed else live_rows)
                if n_blocks > blk_cap:
                    warnings.warn(
                        f"mask touches {n_blocks} blocks of {block} voxels but "
                        f"mask_frac={mask_frac} caps the fit buffer at {blk_cap} "
                        f"blocks: masked voxels in {n_blocks - blk_cap} blocks will "
                        f"be left unfitted (n_overflow); raise mask_frac to "
                        f">= {_min_mask_frac(n, n_blocks, block):.6f}", stacklevel=2)
        res = _fit(buf, fit_kw, mesh, (counts[0], block) if single and not listed else None,
                   (row_list, counts[2]) if listed else None)
        with profiler.span("fit_volume.scatter"):
            return (_scatter_cuda if cuda else _scatter_plain)(flat_mask, block, slot, res,
                                                               counts, zyx)
