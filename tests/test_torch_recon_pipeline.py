"""The port's stage-2 pipeline end to end on the CPU, against the JAX
package's, over synthetic BIDS trees: an in-vivo session (two echo times,
three thick-slice orientations each with small rigid offsets, noise) and
an in-vitro phantom session.

Each tree is copied: the port writes into one copy, the reference into the
other, and their files are compared.
- Resampled volumes: 1e-5 of the scale.
- Fused recons (three rigid solves, the plateau exit on), with and without
  the TV denoising, and the hf->lf warps: at least 99.9% of the voxels
  within 1e-4 of the scale, all within 1e-2. The solved poses agree to
  ~1e-4 mm, and a voxel on a moving volume's field-of-view edge can enter
  or leave its coverage on such a change (measured: 1 voxel of 27,000 at
  2.5e-3, the 99.9th percentile at 7e-6). A TV slice near its stop test
  may likewise stop one iteration apart; denoising is held per iteration
  in test_torch_recon.py.
- The fake SynthSeg labeller thresholds the recon at its 60th/85th
  percentiles, so labels agree on >= 99.5% of voxels. The steps after it
  are held exactly from the same inputs (masks, BET, FeTA, downsampled
  labels and masks), and BET is the recon times the mask, exactly.
- In vitro (masks and sphere labels): exact.
"""

import csv
import logging
import os
import random
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from fetal_t2mapping_tpu import config as ref_C
from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.labels.synthseg import SynthSegRunner as RefSynthSegRunner
from fetal_t2mapping_tpu.pipeline import recon_pipeline as ref_pipe
from fetal_t2mapping_tpu.recon.resample import resample_to_reference as ref_resample_to_reference
from fetal_t2mapping_tpu.recon.resample import resample_volume as ref_resample_volume
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.cli.qmri_reconstruction import main
from fetal_t2mapping_tpu_torch.core import nifti
from fetal_t2mapping_tpu_torch.labels.synthseg import SynthSegRunner
from fetal_t2mapping_tpu_torch.pipeline import recon_pipeline as pipe
from fetal_t2mapping_tpu_torch.recon.resample import resample_to_reference
from fetal_t2mapping_tpu_torch.utils.bids import get_img_path
from fetal_t2mapping_tpu_torch.utils.metadata import set_metadata

torch.set_num_threads(1)

N = 30
TES = (114, 202)
REG = dict(levels=(2, 1), sigmas=(1.0, 0.0), iters=(40, 20))
OFFSETS = {"ax": (2, 0.0), "cor": (1, 1.5), "sag": (0, -2.0)}   # thick axis (x,y,z), shift mm


def _truth(te):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, N)] * 3, indexing="ij")
    r = np.sqrt(z ** 2 + y ** 2 + x ** 2)
    k = 1200.0 * np.exp(-3.0 * r ** 2) * (1 + 0.25 * np.sin(4 * x) * np.cos(3 * y))
    t2 = 140.0 + 30.0 * np.sin(2 * x) * np.cos(2 * y)
    return (k * np.exp(-te / t2)).astype(np.float32)


def _write_rows(logs, rows, name="synthetic.csv"):
    os.makedirs(logs, exist_ok=True)
    with open(os.path.join(logs, name), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _make_invivo_tree(root, seed=0):
    rng = np.random.default_rng(seed)
    bids = os.path.join(root, "projects/")
    rows = []
    for te in TES:
        truth = RefVolume(_truth(te), spacing=(1, 1, 1), origin=(0, 0, 0))
        for otype, (axis, shift) in OFFSETS.items():
            spacing = [1.0, 1.0, 1.0]
            spacing[axis] = 3.0
            low = ref_resample_volume(truth, spacing)
            data = np.asarray(low.data) + rng.normal(0, 4.0, low.shape).astype(np.float32)
            origin = np.asarray(low.origin, float)
            origin[axis] += shift
            acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01",
                   "run": f"run-{otype}-{te}", "EchoTime": te / 1000.0,
                   "ImageOrientationPatientSTR": otype, "CoilString": "Body"}
            ref_nifti.write(get_img_path(bids, acq, C.IN_DIRNAME),
                            RefVolume(data, spacing=low.spacing, origin=tuple(origin)),
                            dtype=np.int16 if otype == "sag" else np.float32)
            rows.append(acq)
    _write_rows(os.path.join(root, "dicom/logs/"), rows)
    return bids, rows


def _files(root):
    out = {}
    for d, _, names in os.walk(os.path.join(root, "projects")):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def _port_rows(root):
    return set_metadata(os.path.join(root, "dicom/logs/"), ["synthetic.csv"], low_field=True)


@pytest.fixture(scope="module")
def invivo(tmp_path_factory):
    """One in-vivo tree in three copies: the port's process_qmri, the
    reference's, and the inputs alone."""
    base = tmp_path_factory.mktemp("invivo")
    src = str(base / "src")
    bids_s, rows = _make_invivo_tree(src)
    roots = {k: str(base / k) for k in ("port", "ref")}
    for r in roots.values():
        shutil.copytree(src, r)
    bids_p = os.path.join(roots["port"], "projects/")
    pipe.process_qmri(bids_p, _port_rows(roots["port"]), in_vivo=True, low_field=True,
                      synthseg=SynthSegRunner(mode="fake"), registration_kwargs=REG,
                      device="cpu")
    ref_pipe.process_qmri(os.path.join(roots["ref"], "projects/"), pd.DataFrame(rows),
                          in_vivo=True, low_field=True,
                          synthseg=RefSynthSegRunner(mode="fake"), registration_kwargs=REG)
    return src, roots, rows


def _rel(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def _held(a, b, what):
    """>= 99.9% of the voxels within 1e-4 of the scale, all within 1e-2."""
    d = np.abs(a - b) / float(np.abs(b).max())
    assert (d <= 1e-4).mean() >= 0.999 and d.max() <= 1e-2, (
        what, (d > 1e-4).sum(), float(d.max()))


def test_invivo_files_match_reference(invivo):
    _, roots, _ = invivo
    fp, fr = _files(roots["port"]), _files(roots["ref"])
    assert sorted(fp) == sorted(fr)
    seen = set()
    for rel, path_r in sorted(fr.items()):
        a, b = nifti.read(fp[rel]), ref_nifti.read(path_r)
        ref = np.asarray(b.data)
        assert a.data.dtype == ref.dtype and a.shape == b.shape, rel
        np.testing.assert_allclose(a.affine, b.affine, atol=1e-5)
        kind = rel.split(os.sep)[3] if rel.split(os.sep)[2] == "derivatives" else "inputs"
        seen.add(kind)
        if kind == "inputs":
            np.testing.assert_array_equal(a.data, ref)
        elif kind == C.RESAMP_DIRNAME:
            if ref.dtype.kind in "iu":        # an integer input keeps its type
                assert np.abs(a.data.astype(np.int64) - ref).max() <= 1, rel
            else:
                assert _rel(a.data, ref) <= 1e-5, rel
        elif kind in (C.RECON_DIRNAME, C.BET_DIRNAME):
            _held(a.data, ref, rel)
        elif kind in (C.SYNTHSEG_DIRNAME, C.MASK_DIRNAME, C.FETA_DIRNAME):
            assert (a.data == ref).mean() >= 0.995, rel
        else:
            raise AssertionError(f"unexpected file {rel}")
    assert seen >= {C.RESAMP_DIRNAME, C.RECON_DIRNAME, C.SYNTHSEG_DIRNAME, C.MASK_DIRNAME,
                    C.BET_DIRNAME, C.FETA_DIRNAME}


def test_fusion_without_denoise_matches_reference(invivo, tmp_path):
    src, _, rows = invivo
    roots = {k: str(tmp_path / k) for k in ("port", "ref")}
    for r in roots.values():
        shutil.copytree(src, r)
    bids_p, bids_r = (os.path.join(roots[k], "projects/") for k in ("port", "ref"))
    port_rows = _port_rows(roots["port"])
    pipe.run_resample_volumes(port_rows, bids_p, device="cpu")
    pipe.run_reconstruct_volumes(port_rows, bids_p, denoise=False, registration_kwargs=REG,
                                 device="cpu")
    md = pd.DataFrame(rows)
    ref_pipe.run_resample_volumes(md, bids_r)
    ref_pipe.run_reconstruct_volumes(md, bids_r, denoise=False, registration_kwargs=REG)
    for te in TES:
        acq = next(r for r in rows if r["EchoTime"] == te / 1000.0)
        a = nifti.read(get_img_path(bids_p, acq, C.RECON_DIRNAME)).data
        b = np.asarray(ref_nifti.read(get_img_path(bids_r, acq, C.RECON_DIRNAME)).data)
        _held(a, b, te)


def test_invivo_outputs_are_consistent_and_recover_truth(invivo):
    _, roots, rows = invivo
    bids = os.path.join(roots["port"], "projects/")
    for te in TES:
        acq = next(r for r in rows if r["EchoTime"] == te / 1000.0)
        recon = nifti.read(get_img_path(bids, acq, C.RECON_DIRNAME))
        mask = nifti.read(get_img_path(bids, acq, C.MASK_DIRNAME))
        bet = nifti.read(get_img_path(bids, acq, C.BET_DIRNAME))
        assert (recon.data.dtype, mask.data.dtype, bet.data.dtype) == (
            np.float32, np.uint8, np.float32)
        np.testing.assert_array_equal(bet.data, recon.data * (mask.data > 0))
        feta_path = get_img_path(bids, acq, C.FETA_DIRNAME)
        assert nifti.read(feta_path).data.dtype == np.int16
        # the fused recon on the ax grid against the truth, on the core
        truth = ref_resample_volume(RefVolume(_truth(te), spacing=(1, 1, 1)), (1.0, 1.0, 1.0))
        ref = np.asarray(truth.data)
        common = tuple(slice(0, min(a, b)) for a, b in zip(recon.shape, ref.shape))
        got, ref = recon.data[common][(slice(5, -5),) * 3], ref[common][(slice(5, -5),) * 3]
        m = ref > 100
        assert np.median(np.abs(got[m] - ref[m]) / ref[m]) < 0.06


def test_label_steps_exact_from_same_inputs(invivo, tmp_path):
    """Masks, BET, FeTA and the downsampled labels/masks, from the port's
    own recon and SynthSeg files, run by both packages: equal."""
    _, roots, rows = invivo
    root_p, root_r = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(roots["port"], root_p)
    shutil.copytree(roots["port"], root_r)
    bids_p, bids_r = (os.path.join(r, "projects/") for r in (root_p, root_r))
    for d in (C.MASK_DIRNAME, C.BET_DIRNAME, C.FETA_DIRNAME):
        shutil.rmtree(os.path.join(bids_r, "prj-004", "derivatives", d))
    md = pd.DataFrame(rows)
    ref_pipe.run_masks_and_bet(md, bids_r)
    ref_pipe.run_feta_labels(md, bids_r)
    ref_pipe.downsample_labels(md, bids_r, ref_C.FETA_DIRNAME, "feta_lowres")
    ref_pipe.downsample_masks(md, bids_r, ref_C.MASK_DIRNAME, "masks_lowres")
    ref_nifti.flush_writes()
    port_rows = _port_rows(root_p)
    pipe.downsample_labels(port_rows, bids_p, C.FETA_DIRNAME, "feta_lowres", device="cpu")
    pipe.downsample_masks(port_rows, bids_p, C.MASK_DIRNAME, "masks_lowres", device="cpu")
    fp, fr = _files(root_p), _files(root_r)
    assert sorted(fp) == sorted(fr)
    n = 0
    for rel, path_r in fr.items():
        if rel.split(os.sep)[3] in (C.MASK_DIRNAME, C.BET_DIRNAME, C.FETA_DIRNAME,
                                    "feta_lowres", "masks_lowres"):
            a, b = nifti.read(fp[rel]).data, np.asarray(ref_nifti.read(path_r).data)
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
            n += 1
    assert n == 2 * 3 + 2 * 2 * 3


def test_resumed_run_leaves_files_untouched(invivo):
    """Every checkpointed derivative is skipped on a second run. The SynthSeg
    runner rewrites its outputs, as the reference's does."""
    _, roots, _ = invivo
    before = {rel: os.path.getmtime(p) for rel, p in _files(roots["port"]).items()
              if C.SYNTHSEG_DIRNAME not in rel}
    pipe.process_qmri(os.path.join(roots["port"], "projects/"), _port_rows(roots["port"]),
                      in_vivo=True, low_field=True, synthseg=SynthSegRunner(mode="fake"),
                      registration_kwargs=REG, device="cpu")
    after = {rel: os.path.getmtime(p) for rel, p in _files(roots["port"]).items()
             if C.SYNTHSEG_DIRNAME not in rel}
    assert after == before


def test_shuffled_metadata_gives_the_same_files(invivo, tmp_path):
    """The first (shortest) TE's recon is the echo registration's fixed
    image whatever the row order: the groups are sorted as pandas' are."""
    src, roots, _ = invivo
    root = str(tmp_path / "shuffled")
    shutil.copytree(src, root)
    rows = _port_rows(root)
    random.Random(3).shuffle(rows)
    rows.sort(key=lambda r: -r["EchoTime"])          # the longest TE first
    pipe.process_qmri(os.path.join(root, "projects/"), rows, in_vivo=True, low_field=True,
                      synthseg=SynthSegRunner(mode="fake"), registration_kwargs=REG,
                      device="cpu")
    fp, fs = _files(roots["port"]), _files(root)
    assert sorted(fp) == sorted(fs)
    for rel in fs:
        np.testing.assert_array_equal(nifti.read(fs[rel]).data, nifti.read(fp[rel]).data,
                                      err_msg=rel)


def test_cli_main_in_vivo_masked_metric(invivo, tmp_path):
    """The CLI with its default registration settings and --masked_metric
    on a fresh copy: every derivative, and the recon near the truth."""
    src, _, rows = invivo
    root = str(tmp_path / "cli")
    shutil.copytree(src, root)
    rc = main(["--path", root, "--csv", "synthetic.csv", "--in_vivo", "--lf",
               "--synthseg", "fake", "--masked_metric", "--device", "cpu"])
    assert rc == 0
    bids = os.path.join(root, "projects/")
    for d in (C.RESAMP_DIRNAME, C.RECON_DIRNAME, C.SYNTHSEG_DIRNAME, C.MASK_DIRNAME,
              C.BET_DIRNAME, C.FETA_DIRNAME):
        files = nifti.list_volumes(os.path.join(bids, "prj-004", "derivatives", d,
                                                "sub-001", "ses-01", "anat"))
        assert len(files) == (6 if d == C.RESAMP_DIRNAME else 2), d
    recon = nifti.read(get_img_path(bids, rows[0], C.RECON_DIRNAME)).data
    ref = np.asarray(ref_resample_volume(RefVolume(_truth(TES[0])), (1.0, 1.0, 1.0)).data)
    core = (slice(5, N - 6),) * 3
    m = ref[core] > 100
    assert np.median(np.abs(recon[core][m] - ref[core][m]) / ref[core][m]) < 0.06


def test_cli_missing_path_returns_1(tmp_path):
    assert main(["--path", str(tmp_path / "nope"), "--csv", "x.csv", "--in_vitro", "--lf",
                 "--device", "cpu"]) == 1


def test_high_to_low_field_matches_reference(invivo, tmp_path):
    """1.5 T recons (ses-02, shifted) registered onto the 0.55 T ses-01
    te-114 recon, warm-started echo to echo."""
    _, roots, rows = invivo
    out = {}
    for who in ("port", "ref"):
        root = str(tmp_path / who)
        bids = os.path.join(root, "projects/")
        hf_rows = []
        for acq in rows:
            if acq["ImageOrientationPatientSTR"] != "ax":
                continue
            src = nifti.read(get_img_path(os.path.join(roots["port"], "projects/"), acq,
                                          C.RECON_DIRNAME))
            for ses, shift in (("ses-01", 0.0), ("ses-02", 1.7)):
                row = dict(acq, ses=ses)
                vol = RefVolume(src.data, spacing=src.spacing,
                                origin=tuple(np.asarray(src.origin) + [shift, -shift, 0.5 * shift]))
                ref_nifti.write(get_img_path(bids, row, C.RECON_DIRNAME), vol)
                hf_rows.append(row)
        hf_rows = [r for r in hf_rows if r["ses"] == "ses-02"]
        if who == "port":
            pipe.register_high_to_low_field(hf_rows, bids, registration_kwargs=REG, device="cpu")
        else:
            ref_pipe.register_high_to_low_field(pd.DataFrame(hf_rows), bids,
                                                registration_kwargs=REG)
            ref_nifti.flush_writes()
        out[who] = [nifti.read(get_img_path(bids, r, C.RECON_DIRNAME)).data for r in hf_rows]
    for a, b in zip(out["port"], out["ref"]):
        _held(a, b, "hf->lf")


def test_biasfield_correction_not_ported():
    with pytest.raises(NotImplementedError, match="item 8"):
        pipe.run_biasfield_correction([], "unused")


# ---------------------------------------------------------------- atlases
T_ATLAS = np.array([[1.04, -0.05, 0.0, 2.0], [0.05, 1.04, 0.02, -1.0],
                    [0.0, -0.02, 0.98, 1.5], [0.0, 0.0, 0.0, 1.0]])


def _atlas_tree(root):
    """A subject's BET (textured blobs inside an ellipsoidal brain), a
    T1-like template (the BET with inverted contrast, moved by the known
    affine T_ATLAS onto a 1.1 mm grid) and two label atlases on the template
    grid, as files."""
    os.makedirs(root, exist_ok=True)
    n = 32
    rng = np.random.default_rng(5)
    zz, yy, xx = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    data = np.zeros((n,) * 3, np.float32)
    for _ in range(14):
        c, s, amp = rng.uniform(7, n - 7, 3), rng.uniform(1.5, 3.5), rng.uniform(300, 900)
        data += amp * np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                             / (2 * s * s))
    brain = np.sqrt(((zz - 15.5) / 12) ** 2 + ((yy - 15.5) / 13) ** 2
                    + ((xx - 15.5) / 11) ** 2) < 1
    bet = RefVolume(np.where(brain, data + 200.0, 0.0).astype(np.float32))
    t1 = RefVolume(np.where(brain, 2000.0 - 1.2 * np.asarray(bet.data), 0.0).astype(np.float32))
    grid = RefVolume(np.zeros((30, 31, 32), np.float32), spacing=(1.1, 1.1, 1.1),
                     origin=(-1.0, 0.5, -0.5))
    tmpl = ref_resample_to_reference(t1, grid, transform=T_ATLAS)   # t1(T_ATLAS @ w)
    t = np.asarray(tmpl.data)
    w = tmpl.world_grid()
    jhu = (np.digitize(w[..., 0], [10.0, 16.0, 22.0]) + 4 * (w[..., 2] > 15.0)) * (t > 0)
    ho = np.digitize(t, [1.0, 1000.0, 1400.0])
    paths = {k: os.path.join(root, f"{k}.nii.gz") for k in ("mni", "jhu", "ho")}
    ref_nifti.write(paths["mni"], tmpl)
    ref_nifti.write(paths["jhu"], tmpl.with_data(jhu.astype(np.int16)), dtype=np.int16)
    ref_nifti.write(paths["ho"], tmpl.with_data(ho.astype(np.int16)), dtype=np.int16)
    acq = {"prj": "prj-004", "sub": "sub-001", "ses": "ses-01", "run": "run-ax-114",
           "EchoTime": 0.114, "ImageOrientationPatientSTR": "ax", "CoilString": "Body"}
    bids = os.path.join(root, "projects/")
    ref_nifti.write(get_img_path(bids, acq, C.BET_DIRNAME), bet)
    ref_nifti.flush_writes()
    return bids, [acq], paths, bet, brain


def test_atlas_labels_match_reference(tmp_path):
    """The affine CR registration (default settings, as the pipeline runs
    it) recovers the template's known pose as the reference's does, and
    the warps through one matrix are the reference's: linear to 1e-5 of the
    scale, nearest exactly."""
    bids_p, rows, paths, bet, brain = _atlas_tree(str(tmp_path / "port"))
    shutil.copytree(str(tmp_path / "port"), str(tmp_path / "ref"))
    bids_r = os.path.join(str(tmp_path / "ref"), "projects/")
    kw = dict(mni_template=paths["mni"], jhu_atlas=paths["jhu"], ho_atlas=paths["ho"])
    pipe.run_atlas_labels(rows, bids_p, device="cpu", **kw)
    ref_pipe.run_atlas_labels(pd.DataFrame(rows), bids_r, **kw)
    ref_nifti.flush_writes()

    def out(bids, dn, suffix=".nii.gz"):
        return os.path.join(bids, "prj-004", "derivatives", dn, "sub-001", "ses-01", "anat",
                            f"sub-001_ses-01_{dn}{suffix}")

    mat_p = np.loadtxt(out(bids_p, C.MNI_DIRNAME, "_omat.mat"))
    mat_r = np.loadtxt(out(bids_r, C.MNI_DIRNAME, "_omat.mat"))
    # registered(w) = template(T @ w) = t1(T_ATLAS @ T @ w): T_ATLAS @ T ~ I
    pts = np.asarray(bet.world_grid())[brain][::5]
    for mat in (mat_p, mat_r):
        M = T_ATLAS @ mat
        assert np.abs(pts @ M[:3, :3].T + M[:3, 3] - pts).max() < 0.5
    fixed = nifti.read(get_img_path(bids_p, rows[0], C.BET_DIRNAME))
    for dn, src, method in ((C.MNI_DIRNAME, "mni", "linear"), (C.JHU_DIRNAME, "jhu", "nearest"),
                            (C.HO_DIRNAME, "ho", "nearest")):
        got = nifti.read(out(bids_p, dn)).data
        ref = np.asarray(ref_nifti.read(out(bids_r, dn)).data)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        same = resample_to_reference(nifti.read(paths[src]), fixed, transform=mat_r,
                                     method=method, device="cpu").data
        if method == "nearest":
            np.testing.assert_array_equal(same, ref)
            assert (got == ref).mean() >= 0.99 and len(np.unique(got)) > 2, dn
        else:
            assert _rel(same, ref) <= 1e-5


def test_atlas_labels_skip_without_fsl(invivo, tmp_path, monkeypatch, caplog):
    _, roots, _ = invivo
    before = sorted(_files(roots["port"]))
    monkeypatch.setenv("FSLDIR", str(tmp_path / "no_fsl"))
    with caplog.at_level(logging.WARNING, logger="fetal_t2mapping_tpu_torch.recon"):
        pipe.run_atlas_labels(_port_rows(roots["port"]), os.path.join(roots["port"], "projects/"),
                              device="cpu")
    assert "skipping atlas labels" in caplog.text
    assert sorted(_files(roots["port"])) == before


# ---------------------------------------------------------------- in vitro
def _make_phantom_tree(root):
    """A 108 x 236 x 232 phantom recon (the default seed set's tubes lie in
    it) with a body, a dark shell and bright tubes at the seeds."""
    rng = np.random.default_rng(7)
    shape = (108, 236, 232)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    disk = (yy - 178) ** 2 + (xx - 184) ** 2
    vol = np.where((disk < 62 ** 2) & (zz > 60) & (zz < 107), 250.0, 8.0).astype(np.float32)
    for sx, sy, _ in C.PHANTOM_SEEDS[C.DEFAULT_PHANTOM_SEEDS_KEY]:       # vials along z
        vol[:, ((yy - sy) ** 2 + (xx - sx) ** 2 < 25)[0]] = 700.0
    vol[(disk < 5 ** 2) & (zz > 70) & (zz < 90)] = 30.0                   # a closed hole
    vol += rng.normal(0, 6.0, shape).astype(np.float32)
    bids = os.path.join(root, "projects/")
    rows = []
    for te in (114,):
        acq = {"prj": "prj-003", "sub": "sub-001", "ses": "ses-01", "run": f"run-{te}",
               "EchoTime": te / 1000.0, "ImageOrientationPatientSTR": "ax",
               "CoilString": "Body"}
        ref_nifti.write(get_img_path(bids, acq, C.RECON_DIRNAME),
                        RefVolume(vol * np.float32(np.exp(-te / 300.0))))
        rows.append(acq)
    _write_rows(os.path.join(root, "dicom/logs/"), rows)
    return rows


def test_in_vitro_cli_matches_reference_exactly(tmp_path):
    roots = {k: str(tmp_path / k) for k in ("port", "ref")}
    rows = _make_phantom_tree(roots["port"])
    shutil.copytree(roots["port"], roots["ref"])
    assert main(["--path", roots["port"], "--csv", "synthetic.csv", "--in_vitro", "--lf",
                 "--device", "cpu"]) == 0
    ref_pipe.process_qmri(os.path.join(roots["ref"], "projects/"), pd.DataFrame(rows),
                          in_vivo=False, low_field=True)
    fp, fr = _files(roots["port"]), _files(roots["ref"])
    assert sorted(fp) == sorted(fr)
    kinds = set()
    for rel, path_r in fr.items():
        kind = rel.split(os.sep)[3]
        if kind in (C.MASK_DIRNAME, C.PHANTOM_LABELS_DIRNAME):
            a, b = nifti.read(fp[rel]).data, np.asarray(ref_nifti.read(path_r).data)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=rel)
            kinds.add(kind)
            assert 0 < (a > 0).sum() < a.size
    assert kinds == {C.MASK_DIRNAME, C.PHANTOM_LABELS_DIRNAME}
