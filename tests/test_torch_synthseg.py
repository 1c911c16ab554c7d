"""The port's SynthSeg runner, volume listing and segmentation step against
the JAX package's, on the CPU: the same files in, the same label files out.
The U-Net runs at a small configuration, patched in as
tests/test_unet3d.py:74-86 does."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from fetal_t2mapping_tpu.core import Volume as RefVolume
from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.labels import synthseg as ref_ss
from fetal_t2mapping_tpu.labels import unet3d as ref_unet
from fetal_t2mapping_tpu.pipeline import recon_pipeline as ref_recon
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import nifti
from fetal_t2mapping_tpu_torch.labels import SynthSegRunner, unet3d
from fetal_t2mapping_tpu_torch.pipeline import run_segmentation

torch.set_num_threads(1)

CFG_KW = dict(n_levels=3, base_features=4, n_labels=len(unet3d.SYNTHSEG_LABELS),
              batch_norm=True)
NAME = "sub-001_ses-01_te-114_recon_1mm.nii.gz"


def _write_recons(directory, names=(NAME,), shape=(12, 10, 14), seed=1):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in names:
        vol = RefVolume(np.abs(rng.normal(400, 120, shape)).astype(np.float32),
                        spacing=(1, 1, 1), origin=(0, 0, 0))
        ref_nifti.write(os.path.join(directory, name), vol)


def _labels(directory):
    return {f: np.asarray(nifti.read(os.path.join(directory, f)).data)
            for f in sorted(os.listdir(directory))}


@pytest.fixture
def small_unet(monkeypatch):
    """Both packages' segment_volume at the small configuration."""
    ref_orig, orig = ref_unet.segment_volume, unet3d.segment_volume
    monkeypatch.setattr(ref_unet, "segment_volume", lambda p, d, cfg=None, **kw: ref_orig(
        p, d, ref_unet.UNetConfig(**CFG_KW), **kw))
    monkeypatch.setattr(unet3d, "segment_volume", lambda p, d, cfg=None, **kw: orig(
        p, d, unet3d.UNetConfig(**CFG_KW), **kw))


def test_torch_mode_matches_jax_mode(tmp_path, small_unet):
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **unet3d.random_params(unet3d.UNetConfig(**CFG_KW), seed=2))
    _write_recons(tmp_path / "in", names=(NAME, "sub-001_ses-01_te-202_recon_1mm.nii.gz"))
    runner = SynthSegRunner(mode="torch", weights=wpath, device="cpu")
    assert runner.available()
    runner.run(str(tmp_path / "in"), str(tmp_path / "out"))
    ref_ss.SynthSegRunner(mode="jax", weights=wpath).run(str(tmp_path / "in"),
                                                         str(tmp_path / "ref"))
    got, want = _labels(tmp_path / "out"), _labels(tmp_path / "ref")
    assert list(got) == list(want) == [
        "sub-001_ses-01_te-114_recon_1mm_synthseg.nii.gz",
        "sub-001_ses-01_te-202_recon_1mm_synthseg.nii.gz"]
    for f in want:
        assert got[f].dtype == np.int16
        np.testing.assert_array_equal(got[f], want[f])
        assert set(np.unique(got[f])) <= set(unet3d.SYNTHSEG_LABELS)


def test_torch_mode_reads_weights_from_env(tmp_path, monkeypatch, small_unet):
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **unet3d.random_params(unet3d.UNetConfig(**CFG_KW), seed=3))
    monkeypatch.setenv("FT2_SYNTHSEG_WEIGHTS", wpath)
    _write_recons(tmp_path / "in")
    runner = SynthSegRunner(mode="torch", device="cpu")
    assert runner.available()
    runner.run(str(tmp_path / "in"), str(tmp_path / "out"))
    assert list(_labels(tmp_path / "out")) == [NAME.replace(".nii.gz", "_synthseg.nii.gz")]


def test_fake_mode_equals_reference(tmp_path):
    _write_recons(tmp_path / "in", names=(NAME, "a_recon_1mm.nii.gz"), shape=(9, 11, 8))
    SynthSegRunner(mode="fake").run(str(tmp_path / "in"), str(tmp_path / "out"))
    ref_ss.SynthSegRunner(mode="fake").run(str(tmp_path / "in"), str(tmp_path / "ref"))
    got, want = _labels(tmp_path / "out"), _labels(tmp_path / "ref")
    assert list(got) == list(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
        g, w = nifti.read(str(tmp_path / "out" / f)), ref_nifti.read(str(tmp_path / "ref" / f))
        assert g.spacing == w.spacing and g.origin == w.origin


def test_torch_mode_without_weights_raises(monkeypatch):
    monkeypatch.delenv("FT2_SYNTHSEG_WEIGHTS", raising=False)
    runner = SynthSegRunner(mode="torch", device="cpu")
    assert not runner.available()
    with pytest.raises(ValueError, match="weights"):
        runner.run("/nonexistent_in", "/nonexistent_out")


def test_callable_and_unknown_modes(tmp_path):
    seen = []
    SynthSegRunner(mode="callable", fn=lambda i, o: seen.append((i, o))).run(
        str(tmp_path / "i"), str(tmp_path / "o"))
    assert seen == [(str(tmp_path / "i"), str(tmp_path / "o"))]
    with pytest.raises(ValueError, match="requires fn"):
        SynthSegRunner(mode="callable").run(str(tmp_path / "i"), str(tmp_path / "o"))
    with pytest.raises(ValueError, match="unknown mode"):
        SynthSegRunner(mode="jax").run(str(tmp_path / "i"), str(tmp_path / "o"))
    assert SynthSegRunner(mode="subprocess",
                          command_template="no-such-binary-xyz {input}").available() is False


def test_list_volumes_equals_reference(tmp_path):
    _write_recons(tmp_path, names=("b.nii.gz", "a.nii.gz"), shape=(2, 2, 2))
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "c.nii").write_bytes(b"")
    assert nifti.list_volumes(tmp_path) == ref_nifti.list_volumes(tmp_path) == [
        str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")]
    assert nifti.list_volumes(tmp_path, ".nii") == ref_nifti.list_volumes(tmp_path, ".nii")
    assert nifti.list_volumes(tmp_path / "missing") == []


def _bids_rows(bids):
    rows = []
    for sub in ("sub-001", "sub-002"):
        for te in (114, 202):
            acq = {"prj": "prj-003", "sub": sub, "ses": "ses-01", "run": f"run-{te}",
                   "EchoTime": te / 1000.0, "CoilString": "Body"}
            rows.append(acq)
        d = os.path.join(bids, "prj-003", "derivatives", C.RECON_DIRNAME, sub, "ses-01",
                         "anat")
        _write_recons(d, names=(f"{sub}_ses-01_te-114_{C.RECON_DIRNAME}.nii.gz",),
                      seed=int(sub[-1]))
    return rows


@pytest.mark.parametrize("mode", ["fake", "torch"])
def test_run_segmentation_writes_the_reference_files(tmp_path, mode, small_unet):
    wpath = str(tmp_path / "w.npz")
    np.savez(wpath, **unet3d.random_params(unet3d.UNetConfig(**CFG_KW), seed=4))
    outs = {}
    for name in ("port", "ref"):
        bids = str(tmp_path / name / "projects")
        rows = _bids_rows(bids)
        if name == "port":
            run_segmentation(rows, bids, SynthSegRunner(mode=mode, weights=wpath, device="cpu"))
        else:
            ref_recon.run_segmentation(pd.DataFrame(rows), bids, ref_ss.SynthSegRunner(
                mode="jax" if mode == "torch" else mode, weights=wpath))
        outs[name] = {}
        for sub in ("sub-001", "sub-002"):
            d = os.path.join(bids, "prj-003", "derivatives", C.SYNTHSEG_DIRNAME, sub,
                             "ses-01", "anat")
            outs[name].update({f"{sub}/{k}": v for k, v in _labels(d).items()})
    assert sorted(outs["port"]) == sorted(outs["ref"]) == [
        f"{s}/{s}_ses-01_te-114_{C.RECON_DIRNAME}_synthseg.nii.gz"
        for s in ("sub-001", "sub-002")]
    for k in outs["ref"]:
        np.testing.assert_array_equal(outs["port"][k], outs["ref"][k])
