"""Cold-start prewarm: run the stage-2 device steps once on a background
thread, on synthetic data of the session's shapes, while the pipeline's
opening host work (input reads) runs.

The counterpart of ``fetal_t2mapping_tpu.utils.prewarm``. There the cost
is a remote load per compiled TPU program; with eager PyTorch on one GPU
it is what a process pays the first time it touches each piece: the CUDA
context, lazily loaded kernel modules, library handles, the caching
allocator's first segments and the ctypes loads. The prewarm replays the
pipeline's entry points with the session's geometry (from header reads
only, :func:`..core.nifti.read_header`) and kwargs: resample with the
integer disk-cast replay, fusion, TV denoise, the echo registration and
its warp, the FeTA remap, and the U-Net forward when the session
segments with ``SynthSegRunner(mode="torch")``.

It runs on a CUDA stream of its own, so its kernels can overlap the
session's instead of queueing behind them, and it draws its synthetic
data from its own seeded numpy and torch generators: it never touches
the global RNG state, and the session's results are the same with or
without it.

Usage::

    process_qmri(..., prewarm=True)        # or qmri_reconstruction --prewarm

or explicitly, to overlap an earlier phase::

    h = start_recon_prewarm(acq_geoms, registration_kwargs=...)
    ...                                     # ingest / host work
    h.wait()                                # optional; the thread is a daemon
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.volume import Volume, np_dtype
from ..device import resolve_device
from .profiling import profiler

log = logging.getLogger("fetal_t2mapping_tpu_torch.prewarm")


class PrewarmHandle:
    """Join handle of a background prewarm.

    ``wait()`` blocks until the run ends and never raises: a prewarm
    failure costs only the overlap, so it is logged and kept on ``error``.
    ``steps`` lists the steps that completed, ``seconds`` the run's wall
    time."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.steps: List[str] = []
        self.error: Optional[BaseException] = None
        self.seconds: float = 0.0

    def wait(self, timeout: Optional[float] = None) -> "PrewarmHandle":
        self._thread.join(timeout)
        return self

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()


def _smooth_noise(shape, rng: np.random.Generator) -> np.ndarray:
    """A structured synthetic image (a low-frequency product pattern plus
    noise): registration and TV run their usual budgets on it; only the
    work matters, not the answer."""
    grids = np.ix_(*(np.linspace(0.0, 3.0, s, dtype=np.float32) for s in shape))
    base = 100.0 * np.cos(grids[0]) * np.cos(grids[1]) * np.cos(grids[2])
    return (base + rng.normal(0.0, 5.0, shape)).astype(np.float32)


def _run(acq_geoms: Dict[str, Volume], handle: PrewarmHandle, *, fixed_type: str,
         n_echoes: int, denoise: bool, high_res: float, registration_kwargs: Optional[dict],
         labels: bool, synthseg, device) -> None:
    from ..core import nifti
    from ..labels.feta import synthseg_to_feta
    from ..recon.denoise import denoise_volume
    from ..recon.fuse import fuse_orientations
    from ..recon.registration import register_rigid_multi
    from ..recon.resample import resample_to_reference, resample_volume

    dev = resolve_device(device)
    reg_kw = registration_kwargs or {}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def done(step: str) -> None:
        if stream is not None:
            stream.synchronize()
        handle.steps.append(step)

    def steps():
        # 1) acquisition -> HR isotropic resample, per orientation, with the
        #    header's dtype: the session resamples the converted int16/uint16
        #    inputs, writes them cast to that dtype and fuses the cache-served
        #    cast volumes, so replay that cast
        his = {}
        for otype, geom in acq_geoms.items():
            dt = np_dtype(geom.data)
            noise = _smooth_noise(geom.shape, rng)
            vol = geom.with_data(np.abs(noise).astype(dt) if dt.kind == "u" else noise.astype(dt))
            hi = resample_volume(vol, [high_res] * 3, on_device=True, device=dev)
            if dt.kind in "iu":
                hi = hi.with_data(nifti._cast_for_disk(hi.data, dt))
            his[otype] = hi
        done("resample")

        # 2) fusion: the two-pair registration, the warps, the combine
        fused = fuse_orientations(his, fixed_type, registration_kwargs=reg_kw, device=dev)
        done("fuse")
        if denoise:
            denoise_volume(fused, device=dev)
            done("denoise")

        # 3) the later echoes' registration onto the first and the warp
        if n_echoes > 1:
            movs = [fused] * (n_echoes - 1)
            regs = register_rigid_multi(fused, movs, device=dev, **reg_kw)
            resample_to_reference(movs[0], fused, transform=regs[0].matrix_device,
                                  on_device=True, device=dev)
            done("reg_echo")

        # 4) the FeTA remap at the HR shape, on labels made on the device
        if labels:
            lab = (torch.rand(fused.shape, generator=gen, device=dev) > 0.5).to(torch.int16) * 2
            synthseg_to_feta(fused.with_data(lab), device=dev)
            done("feta")

        # 5) the U-Net forward at the HR shape, when the session segments in
        #    this process with the port's U-Net
        if getattr(synthseg, "mode", "") == "torch" and synthseg.available():
            from ..labels.unet3d import load_params, segment_volume

            weights = synthseg.weights or os.environ.get("FT2_SYNTHSEG_WEIGHTS")
            segment_volume(load_params(weights), rng.random(fused.shape).astype(np.float32),
                           device=synthseg.device)
            done("unet")

    t0 = time.perf_counter()
    try:
        # thread-seconds of background work: it overlaps the main thread's
        # stages by design
        with profiler.stage("recon.prewarm"):
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                steps()
    except Exception as exc:   # a prewarm failure never reaches the pipeline
        handle.error = exc
        log.warning("prewarm failed after %s: %s", handle.steps, exc)
    finally:
        handle.seconds = time.perf_counter() - t0
        log.info("prewarm done in %.1f s: %s", handle.seconds, handle.steps)


def start_recon_prewarm(acq_geoms: Dict[str, Volume], *, fixed_type: str = "ax",
                        n_echoes: int = 3, denoise: bool = True, high_res: float = 1.0,
                        registration_kwargs: Optional[dict] = None, labels: bool = True,
                        synthseg=None, device="cuda") -> PrewarmHandle:
    """Start the background prewarm for one session's geometry on ``device``.

    ``acq_geoms`` maps orientation ('ax'/'cor'/'sag') to a geometry Volume
    of that acquisition (from :func:`..core.nifti.read_header`; its data is
    never read). ``registration_kwargs`` should be what the session passes.
    ``synthseg`` (a :class:`..labels.synthseg.SynthSegRunner`) adds the
    U-Net forward when its mode is ``"torch"`` (the other modes run outside
    this process's device code). Returns at once; the daemon thread runs
    each step once."""
    geoms = dict(acq_geoms)
    if fixed_type not in geoms:
        raise ValueError(f"fixed_type {fixed_type!r} not in {sorted(geoms)}")
    dev = resolve_device(device)
    # late-binding closure: `handle` is assigned before start()
    thread = threading.Thread(
        target=lambda: _run(geoms, handle, fixed_type=fixed_type, n_echoes=n_echoes,
                            denoise=denoise, high_res=high_res,
                            registration_kwargs=registration_kwargs, labels=labels,
                            synthseg=synthseg, device=dev),
        name="ft2-prewarm", daemon=True)
    handle = PrewarmHandle(thread)
    with profiler.stage("recon.prewarm_start"):
        thread.start()
    return handle


def geoms_from_metadata(metadata: List[Dict], bids_path: str) -> Dict[str, Volume]:
    """One geometry-only Volume per orientation of the first (prj, sub, ses)
    in ``metadata`` (header reads only: a few hundred bytes per
    acquisition). Sessions of one protocol share geometry, so the first
    session's shapes stand for the run."""
    from .. import config as C
    from ..core import nifti
    from ..pipeline.t2map_pipeline import _groups
    from .bids import get_img_path

    geoms: Dict[str, Volume] = {}
    first = next(iter(_groups(metadata, "prj", "sub", "ses")), None)
    if first is None:
        return geoms
    for otype, o_md in _groups(first[1], "ImageOrientationPatientSTR"):
        path = get_img_path(bids_path, o_md[0], C.IN_DIRNAME)
        try:
            geoms[str(otype)] = nifti.read_header(path)
        except (FileNotFoundError, ValueError) as exc:
            log.warning("prewarm: cannot read header %s (%s)", path, exc)
    return geoms
