"""Stage 3 pipeline: voxel-wise T2 mapping over the BIDS derivative tree.

The counterpart of ``fetal_t2mapping_tpu.pipeline.t2map_pipeline``
(reference run_t2mapping.py:333-479): per (prj, sub, ses) load the recon +
mask (+ phantom label) volumes for the selected TEs, build an EchoStack,
run the fit on the device, then write maps, convergence figures and the
phantom ROI CSV. While the device fits session *i*, a host thread
prefetches session *i+1*'s echo stack, and figures render on a worker
thread that overlaps the next session.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future, ThreadPoolExecutor
from itertools import groupby
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import config as C
from ..analysis.convergence import save_convergence_plots
from ..core import nifti
from ..core.stack import EchoStack
from ..models.t2map import fit_stack
from ..utils.bids import get_img_path, mk_bids_dir
from ..utils.maps_io import save_nifti_maps, save_phantom_csv
from ..utils.profiling import profiler

log = logging.getLogger("fetal_t2mapping_tpu_torch.t2map")


def set_ada_path(bids_path: str, prj: str) -> str:
    return mk_bids_dir(bids_path, prj, "ada", "convergence_analysis")


def _groups(rows: List[Dict], *keys: str):
    """pandas-style groupby over row dicts: (key, rows) in sorted key order,
    rows keeping their input order; rows with a missing key are dropped."""
    def key(r):
        return tuple(r.get(k) for k in keys) if len(keys) > 1 else r.get(keys[0])

    rows = [r for r in rows if all(r.get(k) is not None for k in keys)]
    for k, grp in groupby(sorted(rows, key=key), key=key):
        yield k, list(grp)


def _enumerate_sessions(metadata: List[Dict], bids_path: str,
                        tes: Sequence[int], phantom: bool) -> list:
    """Validation pass: one job dict per fit-able (prj, sub, ses).

    Applies the reference's skip semantics up front (TE completeness,
    run_t2mapping.py:388-390; derivatives present) so the prefetcher only
    ever loads sessions that will actually be fitted.
    """
    jobs = []
    for prj, prj_md in _groups(metadata, "prj"):
        for (sub, ses), sub_md in _groups(prj_md, "sub", "ses"):
            acq = None
            te_found, recon_paths, mask_paths = [], [], []
            for echotime, te_md in _groups(sub_md, "EchoTime"):
                acq = te_md[0]
                te_found.append(round(echotime * 1000))
                recon_paths.append(get_img_path(bids_path, acq, C.RECON_DIRNAME))
                mask_paths.append(get_img_path(bids_path, acq, C.MASK_DIRNAME))
            if sorted(te_found) != sorted(list(tes)):
                log.warning("one or more selected TEs missing for %s_%s: %s vs %s; skipped",
                            sub, ses, te_found, list(tes))
                continue
            label_path = (get_img_path(bids_path, acq, C.PHANTOM_LABELS_DIRNAME)
                          if phantom else None)
            # a phantom session whose sphere labels were never built skips
            # with the same warning instead of failing in the prefetch thread
            needed = recon_paths + mask_paths + ([label_path] if label_path
                                                 else [])
            missing = [p for p in needed if not nifti.exists(p)]
            if missing:
                log.warning("derivatives missing for %s_%s (run the recon stage "
                            "first): %s; skipped", sub, ses, missing[0])
                continue
            jobs.append({"prj": prj, "sub": sub, "ses": ses, "acq": acq,
                         "te_found": te_found, "recon_paths": recon_paths,
                         "mask_paths": mask_paths, "label_path": label_path})
    return jobs


def _load_session(job: dict):
    """Host IO for one session: inflate the whole echo stack in parallel."""
    n = len(job["recon_paths"])
    with profiler.stage("t2map.load", items=2 * n):
        loaded = nifti.read_batch(job["recon_paths"] + job["mask_paths"])
    label_vol = nifti.read(job["label_path"]) if job["label_path"] else None
    return loaded[:n], loaded[n:], label_vol


def process_t2maps(
    metadata: List[Dict],
    bids_path: str,
    tes: Sequence[int],
    cfg: C.FitConfig,
    *,
    phantom: bool = False,
    low_field: bool = True,
    fast: bool = False,
    sim: str = "0",
    make_plots: bool = True,
    prefetch: bool = True,
    device="cuda",
) -> list:
    """Fit every (prj, sub, ses) in the metadata rows on ``device``; returns
    per-session summaries.

    Args mirror the reference CLI semantics: ``phantom`` loads sphere labels
    and writes the ROI CSV; ``fast`` restricts the fit to labeled voxels
    (run_t2mapping.py:393-400); sessions missing any selected TE are skipped
    with a warning (:388-390). ``prefetch=False`` disables the load/fit
    overlap (it holds two echo stacks at once). ``make_plots`` needs
    matplotlib and raises without it.
    """
    tes = list(tes)
    tes_in_seconds = [t / 1000.0 for t in tes]
    # EXACT-match TE selection is deliberate reference parity
    # (run_t2mapping.py:351 uses the same float isin)
    metadata = [r for r in metadata if r.get("EchoTime") in tes_in_seconds]
    jobs = _enumerate_sessions(metadata, bids_path, tes, phantom)
    if not jobs:
        return []

    summaries = []
    loader = ThreadPoolExecutor(max_workers=1) if prefetch and len(jobs) > 1 else None
    plotter = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ft2-plots")
               if make_plots else None)
    plot_futures: List[Future] = []
    pending: Optional[Future] = None
    failed = False
    try:
        pending = loader.submit(_load_session, jobs[0]) if loader else None
        for i, job in enumerate(jobs):
            recons, masks, label_vol = (pending.result() if pending
                                        else _load_session(job))
            if loader and i + 1 < len(jobs):
                pending = loader.submit(_load_session, jobs[i + 1])
            else:
                pending = None
            summaries.append(_fit_one(job, recons, masks, label_vol, bids_path,
                                      cfg, phantom=phantom, low_field=low_field,
                                      fast=fast, sim=sim, plotter=plotter,
                                      plot_futures=plot_futures, device=device))
    except BaseException:
        # the fit loop's exception is the PRIMARY failure: cleanup errors
        # below are logged, not raised, so they never replace it
        failed = True
        raise
    finally:
        if loader:
            # a prefetch abandoned by a failed fit: consume it so shutdown
            # doesn't block on unneeded IO and its exception isn't dropped
            if pending is not None and not pending.cancel():
                try:
                    pending.result()
                except Exception:
                    log.exception("abandoned prefetch load failed")
            loader.shutdown(wait=True)
        if plotter:
            try:
                _drain(plot_futures)
            except Exception:
                if not failed:
                    raise
                log.exception("plot render failed during error unwind")
            finally:
                plotter.shutdown(wait=True)
    return summaries


def _profiled_plots(*args):
    with profiler.stage("t2map.plots"):
        return save_convergence_plots(*args)


def _drain(futures: List[Future]) -> None:
    """Wait for EVERY queued render, then re-raise the first failure
    (raising on the first would abandon the rest queued)."""
    first_exc = None
    for fut in futures:
        try:
            fut.result()
        except Exception as exc:
            if first_exc is None:
                first_exc = exc
    futures.clear()
    if first_exc is not None:
        raise first_exc


def _fit_one(job: dict, recons, masks, label_vol, bids_path: str,
             cfg: C.FitConfig, *, phantom: bool, low_field: bool, fast: bool,
             sim: str, plotter: Optional[ThreadPoolExecutor],
             plot_futures: List[Future], device) -> dict:
    prj, sub, ses, acq = job["prj"], job["sub"], job["ses"], job["acq"]
    te_found = job["te_found"]
    stack = EchoStack.from_volumes(recons, masks, te_found)
    if phantom and fast:
        # ROI-only fast mode: mask out everything unlabeled
        stack = EchoStack(
            signal=stack.signal,
            mask=stack.mask & (np.asarray(label_vol.data) > 0),
            tes=stack.tes,
            geometry=stack.geometry,
        )

    log.info("T2 mapping %s_%s_%s: grid %s, %d voxels, TEs %s, model %s",
             prj, sub, ses, stack.grid_shape, int(stack.mask.sum()),
             te_found, cfg.model)
    with profiler.stage("t2map.fit", items=int(stack.mask.sum())):
        out = fit_stack(stack, cfg, device=device)
    log.info("fit done in %.3f s (%.0f voxels/s)", out.fit_seconds,
             out.n_voxels / max(out.fit_seconds, 1e-9))

    with profiler.stage("t2map.save"):
        map_paths = save_nifti_maps(out, bids_path, acq, C.T2MAP_DIRNAME, sim, cfg.model)

    if plotter:
        # figure rendering is pure host work on downloaded arrays: queue it
        # on the worker so it overlaps the next session's load/fit
        ada_path = set_ada_path(bids_path, prj)
        m = stack.mask
        plot_futures.append(plotter.submit(
            _profiled_plots, ada_path, out.traces, out.trace_t2,
            out.n_iter.data[m], out.fun.data[m], out.t2.data[m],
            sub, ses, sim, cfg.model))

    csv_path = None
    if phantom:
        gt, ids = C.phantom_gt(low_field)
        csv_path = save_phantom_csv(out, label_vol, ids, gt, bids_path, acq,
                                    C.T2MAP_DIRNAME, sim, cfg.model)

    return {
        "prj": prj, "sub": sub, "ses": ses,
        "n_voxels": out.n_voxels,
        "fit_seconds": out.fit_seconds,
        "converged_frac": float(out.converged.data[stack.mask].mean()),
        "maps": map_paths, "roi_csv": csv_path,
    }
