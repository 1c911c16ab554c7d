"""Voxel-parallel execution over several devices (PyTorch).

The counterpart of ``fetal_t2mapping_tpu.parallel.mesh``. A mesh is a 1-D
sequence of ``torch.device``s along one axis, ``VOXEL_AXIS``; the fits
split the voxel axis into contiguous shards, one per mesh entry. The fit
is voxel-elementwise, so each shard runs the single-device fit on its own
device with no traffic between devices until the results are gathered onto
the first device; ``n_overflow`` is the sum over shards.

Each shard runs on a CUDA stream of its own (created once per mesh and
device entry). The fused fits issue each shard from a host thread of its
own, so the launches of every shard are issued before the caller waits on
any of them, and a 'twophase' round's read waits only on its own shard.
The batch solvers (``fit_batch``, the multistart) read their stop flag
every iteration and differentiate with ``torch.func``, which must not run
on two threads at once: their shards run one after another.

A device may appear more than once (``voxel_mesh(devices=["cuda:0",
"cuda:0"])``): its shards then run on two streams of one card. That is how one card, or the CPU
(``devices=["cpu"] * 4``), exercises the sharding; a mesh never leaves the
devices it names.

The registration (``recon.registration``, the fixed-image sample axis) and
the U-Net (``labels.unet3d``, the z axis) take a mesh too; they run each
shard on its device's current stream, in turn, and combine on the first
device.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.solver import FitResult

VOXEL_AXIS = "vox"


class VoxelMesh:
    """A 1-D device mesh along ``VOXEL_AXIS``: ``devices`` (a tuple of
    ``torch.device``, repeats allowed) and ``size``."""

    axis_names = (VOXEL_AXIS,)

    def __init__(self, devices: Sequence):
        if len(devices) == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(resolve_device(d) for d in devices)
        self._streams = None
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"VoxelMesh({[str(d) for d in self.devices]})"

    def streams(self) -> List[Optional[torch.cuda.Stream]]:
        """One CUDA stream per shard (None for a CPU entry), made once."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                                 for d in self.devices]
            return self._streams


def voxel_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> VoxelMesh:
    """1-D mesh over the voxel axis: ``devices`` as given, or the first
    ``n_devices`` visible CUDA devices (all of them by default)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("voxel_mesh: no CUDA device is visible; pass "
                               "devices=[...] (e.g. ['cpu'] * 4) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    return VoxelMesh(devices)


def mesh_from_flag(n_devices: Optional[int]) -> Optional[VoxelMesh]:
    """CLI ``--mesh N`` -> a voxel mesh over the first N visible CUDA
    devices. None / 0 / 1 mean one device (no mesh); more devices than are
    visible is a user error, raised with the visible count."""
    if not n_devices or n_devices <= 1:
        return None
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices > avail:
        raise ValueError(f"--mesh {n_devices}: only {avail} CUDA device(s) visible to torch")
    return voxel_mesh(n_devices)


def pad_to_devices(n: int, mesh: VoxelMesh, lane: int = 128) -> int:
    """Smallest N' >= n divisible by (#devices * lane) for clean sharding."""
    q = mesh.size * lane
    return ((n + q - 1) // q) * q


def _check_divisible(n: int, mesh: VoxelMesh) -> int:
    if n % mesh.size:
        raise ValueError(f"voxel count {n} not divisible by mesh size {mesh.size}")
    return n // mesh.size


def shard_voxels(array, mesh: VoxelMesh) -> List[torch.Tensor]:
    """An (N, ...) array as one contiguous leading-axis chunk per shard,
    each on its shard's device (N must be divisible by the mesh size)."""
    t = torch.as_tensor(array)
    m = _check_divisible(t.shape[0], mesh)
    return [t[i * m:(i + 1) * m].to(d) for i, d in enumerate(mesh.devices)]


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def run_sharded(mesh: VoxelMesh, fn: Callable, parts: Sequence, *,
                threads: bool = True) -> list:
    """``fn(part, device)`` for each shard, on its device and its own CUDA
    stream, from one host thread per shard (``threads``), so every shard's
    launches are issued before the caller waits, or one shard after another
    on the calling thread (``torch.func`` transforms, which the 3-parameter
    solvers use, must not run on two threads at once). Each stream first
    waits for the caller's current stream on that device (the inputs'
    producer).
    Returns the results; before it does, each device's current stream
    (the caller's) waits for its shards' streams, and every tensor in a
    result is recorded on it, so the caller uses them as its own."""
    streams = mesh.streams()
    devices = mesh.devices
    producers = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]

    def one(i):
        dev, s = devices[i], streams[i]
        if s is None:
            return fn(parts[i], dev), None
        with torch.cuda.device(dev), torch.cuda.stream(s):
            s.wait_stream(producers[i])
            out = fn(parts[i], dev)
            return out, s.record_event()

    if threads:
        with ThreadPoolExecutor(max_workers=mesh.size, thread_name_prefix="ft2-shard") as ex:
            done = [f.result() for f in [ex.submit(one, i) for i in range(mesh.size)]]
    else:
        done = [one(i) for i in range(mesh.size)]
    results = []
    for (out, ev), prod in zip(done, producers):
        if ev is not None:
            prod.wait_event(ev)
            for t in _tensors(out):
                if t.device.type == "cuda":
                    t.record_stream(prod)
        results.append(out)
    return results


def _gather(results: Sequence[FitResult], dev: torch.device) -> FitResult:
    """Shards' FitResults concatenated on ``dev``; n_overflow summed."""
    cat = lambda name: torch.cat([getattr(r, name).to(dev) for r in results])  # noqa: E731
    overflow = [r.n_overflow for r in results]
    if all(o is None for o in overflow):
        n_overflow = None
    elif all(isinstance(o, int) for o in overflow):
        n_overflow = sum(overflow)
    else:
        n_overflow = sum(torch.as_tensor(o, dtype=torch.int32).to(dev) for o in overflow)
    return FitResult(x=cat("x"), fun=cat("fun"), converged=cat("converged"),
                     n_iter=cat("n_iter"), n_overflow=n_overflow)


def _rows(a, i: int, m: int):
    """Rows [i*m, (i+1)*m) of a host or device array (a view, no copy)."""
    return a[i * m:(i + 1) * m]


def _solver_sharded(solver, signal, te, x0, lo, hi, mesh: VoxelMesh, *, start_axis: int,
                    **fit_kwargs) -> FitResult:
    """A ``models.solver`` batch solve with the voxel axis (axis 0 of
    signal/lo/hi, ``start_axis`` of x0) split over the mesh."""
    sig = torch.as_tensor(signal, dtype=torch.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=sig.device)
    n = sig.shape[0]
    m = _check_divisible(n, mesh)
    shape = (n, x0.shape[-1])
    lo = torch.as_tensor(lo, dtype=torch.float32, device=sig.device).expand(shape)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=sig.device).expand(shape)
    te = torch.as_tensor(te, dtype=torch.float32)
    x0_rows = x0 if start_axis == 0 else x0.movedim(start_axis, 0)

    def one(i, dev):
        x0_i = _rows(x0_rows, i, m).to(dev)
        if start_axis:
            x0_i = x0_i.movedim(0, start_axis)
        return solver(_rows(sig, i, m).to(dev), te.to(dev), x0_i, _rows(lo, i, m).to(dev),
                      _rows(hi, i, m).to(dev), **fit_kwargs)

    results = run_sharded(mesh, one, list(range(mesh.size)), threads=False)
    return _gather(results, mesh.devices[0])


def fit_batch_sharded(signal, te, x0, lo, hi, mesh: VoxelMesh, **fit_kwargs) -> FitResult:
    """``models.solver.fit_batch`` with the voxel axis sharded over the
    mesh; results gathered on the mesh's first device. The voxel count
    must be divisible by the mesh size (``pad_to_devices``)."""
    from ..models.solver import fit_batch

    return _solver_sharded(fit_batch, signal, te, x0, lo, hi, mesh, start_axis=0,
                           **fit_kwargs)


def fit_batch_multistart_sharded(signal, te, x0s, lo, hi, mesh: VoxelMesh,
                                 **fit_kwargs) -> FitResult:
    """``models.solver.fit_batch_multistart`` (x0s (S, N, P)) with the
    voxel axis sharded over the mesh, as :func:`fit_batch_sharded`."""
    from ..models.solver import fit_batch_multistart

    return _solver_sharded(fit_batch_multistart, signal, te, x0s, lo, hi, mesh,
                           start_axis=1, **fit_kwargs)


def fit_fused_sharded(signal, te, lo, hi, mesh: VoxelMesh, *, model: str = "gaussian",
                      guess=None, phase1_iters: int = 10, max_iters: int = 60,
                      ftol: float = 1e-9, gtol: float = 0.0, tail_frac=None,
                      tail_rounds: int = 2, no_prior: bool = False, tail_block=None,
                      strategy: str = "auto", prefix3=None, varpro3=None,
                      sync: bool = True) -> FitResult:
    """``models.fused_fit.fit_fused`` with the voxel axis sharded over the
    mesh: each shard runs the whole fused fit (and under 'twophase' its
    own rounds) on its device and stream; results are gathered on the
    mesh's first device, ``n_overflow`` summed over shards (always 0 under
    'single'). Per-voxel results equal the single-device fit's bitwise
    (each kernel freezes a voxel once it converges). The voxel count must
    be divisible by the mesh size (``pad_to_devices``). ``sync`` waits for
    the first device before returning."""
    from ..models.fused_fit import fit_resolved, resolve_fused

    fit_pass, strategy, two = resolve_fused(
        te, lo, hi, model=model, guess=guess, max_iters=max_iters, ftol=ftol, gtol=gtol,
        no_prior=no_prior, strategy=strategy, full_budget=False, prefix3=prefix3,
        varpro3=varpro3, phase1_iters=phase1_iters, tail_frac=tail_frac,
        tail_rounds=tail_rounds, tail_block=tail_block)
    sig = signal if torch.is_tensor(signal) else np.asarray(signal, np.float32)
    m = _check_divisible(sig.shape[0], mesh)

    def one(i, dev):
        part = torch.as_tensor(_rows(sig, i, m), dtype=torch.float32).to(dev)
        return fit_resolved(part.contiguous(), te, fit_pass, strategy, two)

    result = _gather(run_sharded(mesh, one, list(range(mesh.size))), mesh.devices[0])
    dev0 = mesh.devices[0]
    if sync and dev0.type == "cuda":
        torch.cuda.current_stream(dev0).synchronize()
    return result
