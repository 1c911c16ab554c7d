"""Stage 2 pipeline: derivative generation (resample/fuse/segment/label).

The counterpart of ``fetal_t2mapping_tpu.pipeline.recon_pipeline`` (the
reference's ``process_qmri``, run_qmri_reconstruction.py:5-92) over the
port's metadata rows: a list of dicts, as ``utils.metadata.set_metadata``
returns them, grouped in sorted key order by ``t2map_pipeline._groups`` as
pandas' ``groupby`` groups the reference's frame. Every step writes NIfTIs
into the derivative tree and skips work whose outputs already exist (the
filesystem is the checkpoint; every stage is resumable).

In vivo: resample -> fuse (+ denoise) -> [hf-to-lf registration] ->
SynthSeg -> masks -> BET -> FeTA -> atlas labels. In vitro: phantom masks
and sphere labels from seeds.

Writes go through ``core.nifti.write_async``: each volume is cast to its
on-disk dtype on the device and queued on the writer pool, which
downloads, encodes and gzips it while the next steps compute, and the
volume cache serves the next stage's reads of it (a CUDA tensor stays on
the card). Every public stage flushes its writes on exit; ``process_qmri``
runs its stages inside ``nifti.deferred_flushes``, so those flushes become
one at its end. Within a session the register -> warp -> combine ->
denoise chain stays on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import config as C
from ..core import nifti
from ..core.volume import np_dtype
from ..device import resolve_device
from ..labels.feta import synthseg_to_feta
from ..labels.masks import extract_brain, mask_from_labels, phantom_mask
from ..labels.phantom import phantom_labels_from_seeds
from ..labels.synthseg import SynthSegRunner
from ..ops.morphology import binary_closing, binary_dilate, binary_opening
from ..recon.biasfield import n4_bias_correction, shared_log_bias
from ..recon.denoise import denoise_volume
from ..recon.fuse import fuse_orientations
from ..recon.registration import register_affine, register_rigid, register_rigid_multi
from ..recon.resample import resample_to_reference, resample_volume
from ..utils.bids import get_img_path, mk_bids_dir
from ..utils.profiling import profiler
from .t2map_pipeline import _groups

log = logging.getLogger("fetal_t2mapping_tpu_torch.recon")


def _flushes_writes(fn):
    """Each public stage drains the write queue on exit, so the
    filesystem-is-checkpoint contract holds at every API boundary (a
    caller may list or read the derivative tree right after the call);
    under ``nifti.deferred_flushes`` the drain waits for the outermost
    exit."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        finally:
            nifti.flush_writes()
    return wrapper


@contextlib.contextmanager
def _stage(name: str, device):
    """A profiler stage that ends once the device has finished its work
    (CUDA launches return before the card does)."""
    dev = resolve_device(device)
    with profiler.stage(name):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@_flushes_writes
def run_resample_volumes(metadata: List[Dict], bids_path: str, high_res: float = 1.0,
                         overwrite: bool = False, device="cuda") -> None:
    """Step 2: per-acquisition isotropic resample (reference :35-59)."""
    log.info("===== Resampling to %.2f mm =====", high_res)
    for acq in metadata:
        out_path = get_img_path(bids_path, acq, C.RESAMP_DIRNAME)
        if nifti.exists(out_path) and not overwrite:
            continue
        vol = nifti.read(get_img_path(bids_path, acq, C.IN_DIRNAME))
        hi = resample_volume(vol, [high_res] * 3, on_device=True, device=device)
        # an integer input keeps its pixel type on disk, as the reference's
        # sitk.Resample(..., volume.GetPixelID()) (utils/qmri_utils.py:78-80):
        # rounded half-even and clamped; float inputs stay float32
        in_dt = np_dtype(vol.data)
        nifti.write_async(out_path, hi, dtype=in_dt if in_dt.kind in "iu" else np.float32)
        log.info("resampled %s -> %s", acq["run"], out_path)


@_flushes_writes
def run_reconstruct_volumes(metadata: List[Dict], bids_path: str, *, denoise: bool = True,
                            fixed_type: str = "ax", overwrite: bool = False,
                            registration_kwargs: Optional[dict] = None,
                            device="cuda") -> None:
    """Step 3: per-TE 3-orientation fusion + echo-to-echo registration onto
    the first (shortest) TE's recon + TV denoising (reference :359-391)."""
    reg_kw = registration_kwargs or {}
    for (prj, sub, ses), ss_md in _groups(metadata, "prj", "sub", "ses"):
        first_recon = None
        later_echoes = []               # fused recons awaiting echo->first reg
        for echotime, te_md in _groups(ss_md, "EchoTime"):
            out_path = get_img_path(bids_path, te_md[0], C.RECON_DIRNAME)
            # checkpoint test BEFORE loading: a resumed run must not inflate
            # three HR volumes per TE just to skip them
            if nifti.exists(out_path) and not overwrite:
                if first_recon is None:
                    first_recon = nifti.read(out_path)
                continue
            paths = {a["ImageOrientationPatientSTR"]:
                     get_img_path(bids_path, a, C.RESAMP_DIRNAME) for a in te_md}
            if len(paths) != 3:
                log.warning("TE %.0f ms of %s_%s has orientations %s; skipped",
                            echotime * 1000, sub, ses, sorted(paths))
                continue
            with profiler.stage("fuse.read"):
                imgs = dict(zip(paths, nifti.read_batch(list(paths.values()))))
            log.info("===== Fusion TE %3d ms (%s_%s) =====", int(echotime * 1000), sub, ses)
            with _stage("fuse.fuse", device):
                recon = fuse_orientations(imgs, fixed_type, registration_kwargs=reg_kw,
                                          device=device)
            if first_recon is None:
                first_recon = recon
                if denoise:
                    with _stage("fuse.denoise", device):
                        recon = denoise_volume(recon, device=device)
                with profiler.stage("fuse.write"):
                    nifti.write_async(out_path, recon, dtype=np.float32)
                log.info("recon saved: %s", out_path)
            else:
                later_echoes.append((out_path, recon))
        if not later_echoes:
            continue
        # register ALL later echoes onto the first TE's recon (:378-383) in
        # one multi-pair solve: the echoes share the fixed image
        with _stage("fuse.reg_echo", device):
            regs = register_rigid_multi(first_recon, [r for _, r in later_echoes],
                                        device=device, **reg_kw)
        for (out_path, recon), reg in zip(later_echoes, regs):
            recon = resample_to_reference(recon, first_recon, transform=reg.matrix_device,
                                          on_device=True, device=device)
            if denoise:
                with _stage("fuse.denoise", device):
                    recon = denoise_volume(recon, device=device)
            with profiler.stage("fuse.write"):
                nifti.write_async(out_path, recon, dtype=np.float32)
            log.info("recon saved: %s", out_path)


@_flushes_writes
def run_biasfield_correction(metadata: List[Dict], bids_path: str, *, shared: bool = False,
                             overwrite: bool = False, device="cuda", **n4_kwargs) -> None:
    """Optional N4 bias correction of the resampled volumes (reference
    utils/qmri_utils.py:254-357). ``shared=False`` corrects each acquisition
    independently; ``shared=True`` pools the log-bias across echo times per
    (prj, sub, ses, orientation) — the coil bias is TE-independent."""
    if not shared:
        for acq in metadata:
            out_path = get_img_path(bids_path, acq, C.N4_DIRNAME)
            if nifti.exists(out_path) and not overwrite:
                continue
            vol = nifti.read(get_img_path(bids_path, acq, C.RESAMP_DIRNAME))
            with _stage("recon.n4", device):
                res = n4_bias_correction(vol, device=device, **n4_kwargs)
            nifti.write_async(out_path, res.corrected, dtype=np.float32)
            log.info("n4: %s", out_path)
        return
    for _, md in _groups(metadata, "prj", "sub", "ses", "ImageOrientationPatientSTR"):
        out_paths = [get_img_path(bids_path, a, C.N4_DIRNAME) for a in md]
        if all(nifti.exists(p) for p in out_paths) and not overwrite:
            continue
        vols = [nifti.read(get_img_path(bids_path, a, C.RESAMP_DIRNAME)) for a in md]
        with _stage("recon.n4", device):
            corrected, _ = shared_log_bias(vols, device=device, **n4_kwargs)
        for out_path, vol in zip(out_paths, corrected):
            nifti.write_async(out_path, vol, dtype=np.float32)
            log.info("n4 (shared): %s", out_path)


@_flushes_writes
def register_high_to_low_field(metadata: List[Dict], bids_path: str,
                               registration_kwargs: Optional[dict] = None,
                               device="cuda") -> None:
    """Step 3bis: register 1.5 T recons to the 0.55 T ses-01 te-114 recon
    (reference :1039-1051), with its per-subject exclusions."""
    warm: Dict[tuple, torch.Tensor] = {}
    for (prj, sub, ses, echotime), sub_md in _groups(metadata, "prj", "sub", "ses",
                                                     "EchoTime"):
        for acq in sub_md:
            # metadata stores EchoTime in seconds; the exclusion list is in ms
            if round(echotime * 1000) == 299 and sub in ("sub-003", "sub-004"):
                continue
            moving_path = get_img_path(bids_path, acq, C.RECON_DIRNAME)
            fixed_path = re.sub(r"ses-\d{2}", "ses-01", moving_path)
            fixed_path = re.sub(r"te-\d+", "te-114", fixed_path)
            if not nifti.exists(moving_path) or not nifti.exists(fixed_path):
                continue
            fixed = nifti.read(fixed_path)
            moving = nifti.read(moving_path)
            # successive echoes of one (prj, sub, ses) share the motion:
            # warm-start from the previous echo's solved parameters
            reg = register_rigid(fixed, moving, init_params=warm.get((prj, sub, ses)),
                                 device=device, **(registration_kwargs or {}))
            warm[(prj, sub, ses)] = reg.params_device
            out = resample_to_reference(moving, fixed, transform=reg.matrix_device,
                                        on_device=True, device=device)
            nifti.write_async(moving_path, out, dtype=np.float32)
            log.info("hf->lf registered: %s", moving_path)


def run_segmentation(metadata: List[Dict], bids_path: str,
                     runner: Optional[SynthSegRunner] = None) -> None:
    """Step 4: SynthSeg labels per (prj, sub, ses) recon dir, written to the
    session's ``recon_1mm_synthseg`` derivative dir (reference :424-466)."""
    runner = runner or SynthSegRunner()
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        input_dir = os.path.join(bids_path, prj, "derivatives", C.RECON_DIRNAME, sub, ses, "anat")
        output_dir = mk_bids_dir(bids_path, prj, "derivatives", C.SYNTHSEG_DIRNAME, sub, ses, "anat")
        runner.run(input_dir, output_dir)


def _derivative_files(bids_path, prj, sub, ses, dirname):
    return nifti.list_volumes(os.path.join(bids_path, prj, "derivatives", dirname, sub, ses, "anat"))


@_flushes_writes
def run_masks_and_bet(metadata: List[Dict], bids_path: str, overwrite: bool = False) -> None:
    """Steps 5 + 5bis: masks from labels; brain extraction (reference :935-974)."""
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        mask_dir = mk_bids_dir(bids_path, prj, "derivatives", C.MASK_DIRNAME, sub, ses, "anat")
        bet_dir = mk_bids_dir(bids_path, prj, "derivatives", C.BET_DIRNAME, sub, ses, "anat")
        for lbl_path in _derivative_files(bids_path, prj, sub, ses, C.SYNTHSEG_DIRNAME):
            out = os.path.join(mask_dir, os.path.basename(lbl_path).replace("synthseg", "mask"))
            if nifti.exists(out) and not overwrite:
                continue
            nifti.write_async(out, mask_from_labels(nifti.read(lbl_path)), dtype=np.uint8)
        # derive each mask path from the recon filename (never pair two
        # independently sorted listings: a count/naming mismatch would BET
        # the wrong mask onto a recon)
        for recon_path in _derivative_files(bids_path, prj, sub, ses, C.RECON_DIRNAME):
            base = os.path.basename(recon_path)
            mask_path = os.path.join(
                bids_path, prj, "derivatives", C.MASK_DIRNAME, sub, ses, "anat",
                base.replace(C.RECON_DIRNAME + ".nii", C.MASK_DIRNAME + ".nii"))
            if not nifti.exists(mask_path):
                raise FileNotFoundError(
                    f"no mask for recon {recon_path!r} (expected {mask_path!r}; "
                    "did the SynthSeg/mask step run?)")
            out = os.path.join(bet_dir, base.replace(C.RECON_DIRNAME + ".nii",
                                                     C.BET_DIRNAME + ".nii"))
            if nifti.exists(out) and not overwrite:
                continue
            bet = extract_brain(nifti.read(recon_path), nifti.read(mask_path))
            nifti.write_async(out, bet, dtype=np.float32)


@_flushes_writes
def run_feta_labels(metadata: List[Dict], bids_path: str, overwrite: bool = False,
                    device="cuda") -> None:
    """Step 6: SynthSeg -> FeTA remap (reference :976-1009)."""
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        out_dir = mk_bids_dir(bids_path, prj, "derivatives", C.FETA_DIRNAME, sub, ses, "anat")
        for lbl_path in _derivative_files(bids_path, prj, sub, ses, C.SYNTHSEG_DIRNAME):
            out = os.path.join(out_dir, os.path.basename(lbl_path).replace("synthseg", "feta"))
            if nifti.exists(out) and not overwrite:
                continue
            feta = synthseg_to_feta(nifti.read(lbl_path), device=device)
            nifti.write_async(out, feta, dtype=np.int16)


@_flushes_writes
def run_atlas_labels(metadata: List[Dict], bids_path: str, *,
                     mni_template: Optional[str] = None, jhu_atlas: Optional[str] = None,
                     ho_atlas: Optional[str] = None, low_field: bool = True,
                     device="cuda") -> None:
    """Step 7: affine MNI152->subject registration + JHU/HO atlas warps.

    One affine registration (correlation ratio, FLIRT's default cost for
    this cross-contrast step, reference :1011-1037) of the template to the
    subject's BET volume, then nearest-neighbour warps of both atlases with
    the same transform. Template/atlas paths default to $FSLDIR locations;
    when one is missing the step warns and skips, as the reference does."""
    fsl = os.environ.get("FSLDIR", "/usr/local/fsl")
    mni_template = mni_template or os.path.join(fsl, "data/standard/MNI152_T1_1mm_brain.nii.gz")
    jhu_atlas = jhu_atlas or os.path.join(fsl, "data/atlases/JHU/JHU-ICBM-labels-1mm.nii.gz")
    ho_atlas = ho_atlas or os.path.join(
        fsl, "data/atlases/HarvardOxford/HarvardOxford-cort-maxprob-thr50-1mm.nii.gz")
    for p in (mni_template, jhu_atlas, ho_atlas):
        if not nifti.exists(p):
            log.warning("atlas input missing: %s — skipping atlas labels", p)
            return
    te_tag = "te-114" if low_field else "te-115"
    mni, jhu, ho = nifti.read(mni_template), nifti.read(jhu_atlas), nifti.read(ho_atlas)
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        bet_path = os.path.join(bids_path, prj, "derivatives", C.BET_DIRNAME, sub, ses,
                                "anat", f"{sub}_{ses}_{te_tag}_{C.BET_DIRNAME}.nii.gz")
        if not nifti.exists(bet_path):
            log.warning("BET reference missing: %s", bet_path)
            continue
        bet = nifti.read(bet_path)
        reg = register_affine(bet, mni, metric="cr", device=device)
        mni_dir = mk_bids_dir(bids_path, prj, "derivatives", C.MNI_DIRNAME, sub, ses, "anat")
        jhu_dir = mk_bids_dir(bids_path, prj, "derivatives", C.JHU_DIRNAME, sub, ses, "anat")
        ho_dir = mk_bids_dir(bids_path, prj, "derivatives", C.HO_DIRNAME, sub, ses, "anat")
        warped = resample_to_reference(mni, bet, transform=reg.matrix, device=device)
        nifti.write_async(os.path.join(mni_dir, f"{sub}_{ses}_{C.MNI_DIRNAME}.nii.gz"), warped,
                          dtype=np.float32)
        np.savetxt(os.path.join(mni_dir, f"{sub}_{ses}_{C.MNI_DIRNAME}_omat.mat"), reg.matrix)
        for atlas, out_dir, name in ((jhu, jhu_dir, C.JHU_DIRNAME), (ho, ho_dir, C.HO_DIRNAME)):
            labels = resample_to_reference(atlas, bet, transform=reg.matrix, method="nearest",
                                           device=device)
            nifti.write_async(os.path.join(out_dir, f"{sub}_{ses}_{name}.nii.gz"), labels,
                              dtype=np.int16)


@_flushes_writes
def downsample_labels(metadata: List[Dict], bids_path: str, high_dirname: str,
                      low_dirname: str, device="cuda") -> None:
    """Nearest-neighbour resample of HR label maps back to the acquisition
    grids (reference utils/qmri_utils.py:504-530)."""
    for acq in (a for _, md in _groups(metadata, "prj", "sub", "ses") for a in md):
        high = nifti.read(get_img_path(bids_path, acq, high_dirname))
        ref = nifti.read(get_img_path(bids_path, acq, C.IN_DIRNAME))
        if high.shape == ref.shape and high.same_geometry(ref):
            low = high
        else:
            low = resample_to_reference(high, ref, method="nearest", device=device)
        nifti.write_async(get_img_path(bids_path, acq, low_dirname), low, dtype=np.int16)


@_flushes_writes
def downsample_masks(metadata: List[Dict], bids_path: str, high_dirname: str,
                     low_dirname: str, device="cuda") -> None:
    """Mask downsampling with dilate + close + open regularization
    (reference utils/qmri_utils.py:568-589)."""
    for acq in (a for _, md in _groups(metadata, "prj", "sub", "ses") for a in md):
        high = nifti.read(get_img_path(bids_path, acq, high_dirname))
        ref = nifti.read(get_img_path(bids_path, acq, C.IN_DIRNAME))
        low = resample_to_reference(high, ref, method="nearest", on_device=True, device=device)
        m = binary_opening(binary_closing(binary_dilate(low.data > 0, 2), 1), 1)
        out_path = get_img_path(bids_path, acq, low_dirname).replace("masks.nii", "mask.nii")
        nifti.write_async(out_path, low.with_data(m.to(torch.uint8)), dtype=np.uint8)


@_flushes_writes
def build_phantom_masks(metadata: List[Dict], bids_path: str, *, threshold: float = 100.0,
                        device="cuda") -> None:
    """In vitro: foreground masks from the recon volumes (reference
    utils/qmri_utils.py:591-623). The t2map stage loads MASK_DIRNAME
    unconditionally, so the in-vitro branch produces it too."""
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        input_dir = os.path.join(bids_path, prj, "derivatives", C.RECON_DIRNAME, sub, ses, "anat")
        out_dir = mk_bids_dir(bids_path, prj, "derivatives", C.MASK_DIRNAME, sub, ses, "anat")
        for img_path in nifti.list_volumes(input_dir):
            out_path = os.path.join(out_dir, os.path.basename(img_path).replace(
                C.RECON_DIRNAME, C.MASK_DIRNAME))
            if nifti.exists(out_path):
                continue
            mask = phantom_mask(nifti.read(img_path), threshold=threshold, device=device)
            nifti.write_async(out_path, mask, dtype=np.uint8)
            log.info("phantom mask: %s", out_path)


@_flushes_writes
def build_phantom_labels(metadata: List[Dict], bids_path: str,
                         seeds: Sequence[Sequence[int]], radius: int = 6,
                         device="cuda") -> None:
    """In vitro: sphere labels from seed voxels (reference :868-933)."""
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        input_dir = os.path.join(bids_path, prj, "derivatives", C.RECON_DIRNAME, sub, ses, "anat")
        out_dir = mk_bids_dir(bids_path, prj, "derivatives", C.PHANTOM_LABELS_DIRNAME,
                              sub, ses, "anat")
        for img_path in nifti.list_volumes(input_dir):
            out_path = os.path.join(out_dir, os.path.basename(img_path).replace(
                C.RECON_DIRNAME, C.PHANTOM_LABELS_DIRNAME))
            if nifti.exists(out_path):
                continue
            labels = phantom_labels_from_seeds(nifti.read(img_path), seeds, radius=radius,
                                               device=device)
            nifti.write_async(out_path, labels, dtype=np.uint8)
            log.info("phantom labels: %s", out_path)


def process_qmri(bids_path: str, metadata: List[Dict], *, in_vivo: bool, low_field: bool,
                 synthseg: Optional[SynthSegRunner] = None,
                 seeds_key: str = C.DEFAULT_PHANTOM_SEEDS_KEY,
                 registration_kwargs: Optional[dict] = None, mesh=None,
                 prewarm: bool = False, device="cuda"):
    """Full stage-2 pipeline (reference run_qmri_reconstruction.py:5-92) on
    ``device``. Each stage's wall time lands in ``utils.profiling.profiler``
    under ``recon.*`` (and ``fuse.*`` inside the fusion, ``io.*`` in the
    writer pool). ``synthseg`` carries its own device for ``mode="torch"``.

    The stages run inside ``nifti.deferred_flushes``: the writer pool
    drains while later stages compute, and every write has landed when
    this returns (``recon.flush_writes``).

    ``prewarm=True`` (in vivo) keeps the reference's interface: it reads
    the first session's headers and, when they hold the fusion's ax/cor/sag
    triple, returns a finished :class:`~..utils.prewarm.PrewarmHandle` that
    ran no step (no warm-up beat stage 2 without one on the H100; see
    :mod:`..utils.prewarm`); else None. Results are the same either way.

    ``mesh`` (a ``parallel.VoxelMesh`` whose first device is ``device``)
    spreads the registrations and the torch-mode U-Net over its devices:
    every rigid/affine solve splits its metric samples
    (``recon.registration``), and ``SynthSegRunner(mode="torch")`` splits
    the U-Net's z axis (``labels.unet3d``)."""
    if mesh is not None:
        registration_kwargs = dict(registration_kwargs or {})
        registration_kwargs.setdefault("mesh", mesh)
        if synthseg is not None and getattr(synthseg, "mesh", None) is None:
            synthseg = dataclasses.replace(synthseg, mesh=mesh)
    handle = None
    if prewarm and in_vivo:
        handle = _start_prewarm(bids_path, metadata)
    with nifti.deferred_flushes():
        try:
            _process_qmri_stages(bids_path, metadata, in_vivo=in_vivo, low_field=low_field,
                                 synthseg=synthseg, seeds_key=seeds_key,
                                 registration_kwargs=registration_kwargs, device=device)
        finally:
            # every queued checkpoint lands before the stage returns: the
            # filesystem-is-checkpoint contract holds at the API boundary
            with profiler.stage("recon.flush_writes"):
                nifti.flush_writes(force=True)
    return handle


def _start_prewarm(bids_path, metadata):
    """The prewarm's handle for the first session's geometry, or None with a
    warning for a session without the fusion's ax/cor/sag triple (the
    reference skips those too)."""
    from ..utils.prewarm import geoms_from_metadata, start_recon_prewarm

    geoms = geoms_from_metadata(metadata, bids_path)
    # "ax" is the fusion's fixed orientation (run_reconstruct_volumes)
    if len(geoms) != 3 or "ax" not in geoms:
        log.warning("prewarm skipped: found orientations %s", sorted(geoms))
        return None
    n_echoes = len({r["EchoTime"] for r in metadata if r.get("EchoTime") is not None})
    return start_recon_prewarm(geoms, n_echoes=n_echoes)


def _process_qmri_stages(bids_path, metadata, *, in_vivo, low_field, synthseg, seeds_key,
                         registration_kwargs, device):
    if in_vivo:
        with profiler.stage("recon.resample"):
            run_resample_volumes(metadata, bids_path, 1.0, device=device)
        with profiler.stage("recon.fuse"):
            run_reconstruct_volumes(metadata, bids_path, denoise=True, fixed_type="ax",
                                    registration_kwargs=registration_kwargs, device=device)
        if not low_field:
            with profiler.stage("recon.hf_to_lf"):
                register_high_to_low_field(metadata, bids_path,
                                           registration_kwargs=registration_kwargs,
                                           device=device)
        with profiler.stage("recon.synthseg"):
            run_segmentation(metadata, bids_path, synthseg)
        with profiler.stage("recon.masks_bet"):
            run_masks_and_bet(metadata, bids_path)
        with profiler.stage("recon.feta"):
            run_feta_labels(metadata, bids_path, device=device)
        with profiler.stage("recon.atlas"):
            run_atlas_labels(metadata, bids_path, low_field=low_field, device=device)
    else:
        with profiler.stage("recon.phantom_masks"):
            build_phantom_masks(metadata, bids_path, device=device)
        with profiler.stage("recon.phantom_labels"):
            build_phantom_labels(metadata, bids_path, C.PHANTOM_SEEDS[seeds_key],
                                 device=device)
