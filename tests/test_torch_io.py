"""The port's host-side modules against the JAX package's: configuration
tables, echo-stack gather/scatter, NIfTI files across the two codecs, the
csv-based metadata and session enumeration, and the phantom ROI CSV.
These are copies or stdlib re-writes of host code, so they must agree
exactly."""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from fetal_t2mapping_tpu import config as ref_C
from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu.core import stack as ref_stack
from fetal_t2mapping_tpu.core.volume import Volume as RefVolume
from fetal_t2mapping_tpu.pipeline import t2map_pipeline as ref_pipe
from fetal_t2mapping_tpu.utils import maps_io as ref_maps
from fetal_t2mapping_tpu.utils import metadata as ref_md
from fetal_t2mapping_tpu_torch import config as C
from fetal_t2mapping_tpu_torch.core import nifti, stack
from fetal_t2mapping_tpu_torch.core.volume import Volume
from fetal_t2mapping_tpu_torch.pipeline import t2map_pipeline as pipe
from fetal_t2mapping_tpu_torch.utils import maps_io
from fetal_t2mapping_tpu_torch.utils import metadata as md

torch.set_num_threads(1)

GEOM = dict(spacing=(0.8, 1.1, 1.3), origin=(-10.5, 4.25, 30.0),
            direction=(0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0))


def test_fit_table_tes_and_phantom_gt_equal_reference():
    assert C._FIT_TABLE == ref_C._FIT_TABLE
    assert C.DEFAULT_TES_LF == ref_C.DEFAULT_TES_LF
    assert C.DEFAULT_TES_HF == ref_C.DEFAULT_TES_HF
    assert C.PHANTOM_GT_LF == ref_C.PHANTOM_GT_LF
    assert C.PHANTOM_GT_HF == ref_C.PHANTOM_GT_HF
    assert (C.NO_PRIOR_K_UPPER, C.NO_PRIOR_T2_BOUNDS) == (
        ref_C.NO_PRIOR_K_UPPER, ref_C.NO_PRIOR_T2_BOUNDS)
    for key in ref_C._FIT_TABLE:
        assert dataclasses.astuple(C.fit_config(*key)) == dataclasses.astuple(
            ref_C.fit_config(*key))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 8192, 8193, 3_000_000])
def test_pad_bucket_identical(n):
    assert stack.pad_bucket(n) == ref_stack.pad_bucket(n)


def test_gather_scatter_identical():
    rng = np.random.default_rng(0)
    shape = (6, 7, 9)
    tes = [202.0, 114.0, 299.0]               # unsorted on purpose
    recons = [rng.uniform(0, 1000, shape).astype(np.float32) for _ in tes]
    masks = [(rng.uniform(size=shape) > 0.6).astype(np.uint8) for _ in tes]
    ref_s = ref_stack.EchoStack.from_volumes(
        [RefVolume(r, **GEOM) for r in recons], [RefVolume(m, **GEOM) for m in masks], tes)
    port_s = stack.EchoStack.from_volumes(
        [Volume(r, **GEOM) for r in recons], [Volume(m, **GEOM) for m in masks], tes)
    np.testing.assert_array_equal(port_s.tes, ref_s.tes)
    b_r, idx_r, n_r = ref_s.gather()
    b_p, idx_p, n_p = port_s.gather()
    np.testing.assert_array_equal(b_p, b_r)
    np.testing.assert_array_equal(idx_p, idx_r)
    assert n_p == n_r
    vals = rng.uniform(size=n_r).astype(np.float32)
    v_r, v_p = ref_s.scatter(vals, idx_r), port_s.scatter(vals, idx_p)
    np.testing.assert_array_equal(v_p.data, v_r.data)
    assert (v_p.spacing, v_p.origin, v_p.direction) == (
        v_r.spacing, v_r.origin, v_r.direction)


@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_nifti_files_cross_read(tmp_path, suffix, dtype):
    data = (np.random.default_rng(1).uniform(0, 200, (5, 6, 7))).astype(dtype)
    a, b = str(tmp_path / f"port{suffix}"), str(tmp_path / f"ref{suffix}")
    nifti.write(a, Volume(data, **GEOM))
    ref_nifti.write(b, RefVolume(data, **GEOM))
    for got in (ref_nifti.read(a), nifti.read(b), nifti.read(a)):
        np.testing.assert_array_equal(np.asarray(got.data), data)
        assert got.data.dtype == np.dtype(dtype)
        np.testing.assert_allclose(got.spacing, GEOM["spacing"], rtol=1e-6)
        np.testing.assert_allclose(got.origin, GEOM["origin"], rtol=1e-6)
        np.testing.assert_allclose(got.direction, GEOM["direction"], atol=1e-6)


def test_nifti_write_casts_like_reference(tmp_path):
    data = np.asarray([[[-3.6, 0.5, 1.5], [2.5, 300.7, np.nan]]], np.float32)
    a, b = str(tmp_path / "a.nii.gz"), str(tmp_path / "b.nii.gz")
    nifti.write(a, Volume(data), dtype=np.uint8)
    ref_nifti.write(b, RefVolume(data), dtype=np.uint8)
    np.testing.assert_array_equal(nifti.read(a).data, np.asarray(ref_nifti.read(b).data))


def test_nifti_write_takes_numpy_only(tmp_path):
    vol = Volume(np.zeros((2, 2, 2), np.float32))
    tensor_vol = Volume(torch.zeros((2, 2, 2)))
    with pytest.raises(TypeError, match="numpy"):
        nifti.write(str(tmp_path / "x.nii.gz"), tensor_vol)
    nifti.write(str(tmp_path / "y.nii.gz"), vol)
    assert nifti.exists(str(tmp_path / "y.nii.gz"))


def test_nifti_read_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        nifti.read(str(tmp_path / "missing.nii.gz"))
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"not gzip at all")
    with pytest.raises(ValueError, match="unreadable"):
        nifti.read(str(bad))
    with pytest.raises(ValueError, match="truncated"):
        nifti.parse(b"\x00" * 100)


def _write_logs(root):
    """Two projects, three subjects, one missing an echo, as a CSV log."""
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs, exist_ok=True)
    rows = []
    for prj, sub, tes in (("prj-003", "sub-002", (114, 202, 299)),
                          ("prj-003", "sub-001", (299, 114, 202)),
                          ("prj-002", "sub-007", (114, 202)),
                          ("prj-003", "sub-001", (350,))):
        for te in tes:
            rows.append({"prj": prj, "sub": sub, "ses": "ses-01",
                         "run": f"run-{te}", "EchoTime": te / 1000.0,
                         "ImageOrientationPatientSTR": "ax",
                         "CoilString": "Body", "SeriesNumber": te})
    pd.DataFrame(rows).to_csv(os.path.join(logs, "a.csv"), index=False)
    pd.DataFrame(rows[:2]).to_csv(os.path.join(logs, "b.csv"), index=False)
    return logs


def test_metadata_rows_equal_pandas(tmp_path):
    logs = _write_logs(str(tmp_path))
    ref = ref_md.set_metadata(logs, ["a.csv", "b.csv"], low_field=True)
    port = md.set_metadata(logs, ["a.csv", "b.csv"], low_field=True)
    assert port == ref.to_dict("records")
    assert type(port[0]["EchoTime"]) is float and type(port[0]["SeriesNumber"]) is int
    with pytest.raises(ValueError, match="neither"):
        md.set_metadata(logs, ["notacsv.txt"], low_field=True)


def test_csv2df_equals_reference(tmp_path):
    """csv2df is the reference's pandas loader, exported from utils as
    there."""
    from fetal_t2mapping_tpu import utils as ref_utils
    from fetal_t2mapping_tpu_torch import utils as port_utils

    logs = _write_logs(str(tmp_path))
    path = os.path.join(logs, "a.csv")
    pd.testing.assert_frame_equal(port_utils.csv2df(path), ref_utils.csv2df(path))
    assert "csv2df" in port_utils.__all__ and md.csv2df is port_utils.csv2df
    assert md.csv2df(path).to_dict("records") == md.read_csv(path)


def test_session_enumeration_equals_pandas(tmp_path):
    logs = _write_logs(str(tmp_path))
    bids = str(tmp_path / "projects") + "/"
    ref_rows = ref_md.set_metadata(logs, ["a.csv"], low_field=True)
    port_rows = md.set_metadata(logs, ["a.csv"], low_field=True)
    # derivatives on disk for every acquisition but one recon of sub-002
    for _, acq in ref_rows.iterrows():
        for d in (C.RECON_DIRNAME, C.MASK_DIRNAME):
            path = ref_pipe.get_img_path(bids, acq, d)
            if not (acq["sub"] == "sub-002" and acq["EchoTime"] == 0.202
                    and d == C.RECON_DIRNAME):
                nifti.write(path, Volume(np.zeros((2, 2, 2), np.float32)))
    tes = [114, 202, 299]
    sel = [t / 1000.0 for t in tes]
    ref_jobs = ref_pipe._enumerate_sessions(
        ref_rows[ref_rows["EchoTime"].isin(sel)], bids, tes, False)
    port_jobs = pipe._enumerate_sessions(
        [r for r in port_rows if r["EchoTime"] in sel], bids, tes, False)
    assert len(port_jobs) == len(ref_jobs) == 1
    for pj, rj in zip(port_jobs, ref_jobs):
        assert pj["acq"] == rj["acq"].to_dict()
        for key in ("prj", "sub", "ses", "te_found", "recon_paths",
                    "mask_paths", "label_path"):
            assert pj[key] == rj[key], key


def test_phantom_csv_same_as_reference(tmp_path):
    rng = np.random.default_rng(2)
    shape = (4, 5, 6)
    label = rng.integers(0, 4, shape).astype(np.uint8)
    label[label == 3] = 0                          # sphere 3: empty -> NaN row
    maps = {n: rng.uniform(1, 500, shape).astype(np.float32) for n in ("t2", "k", "sigma")}

    class Out:
        t2, k, sigma = (Volume(maps[n]) for n in ("t2", "k", "sigma"))

    acq = {"prj": "prj-003", "sub": "sub-001", "ses": "ses-01", "run": "run-1",
           "EchoTime": 0.114}
    ids, gt = ["T2-3", "T2-4", "T2-5"], [594, 416, 284]
    p_port = maps_io.save_phantom_csv(Out, Volume(label), ids, gt,
                                      str(tmp_path / "a") + "/", acq, C.T2MAP_DIRNAME, "t", "gaussian")
    p_ref = ref_maps.save_phantom_csv(Out, RefVolume(label), ids, gt,
                                      str(tmp_path / "b") + "/", pd.Series(acq),
                                      C.T2MAP_DIRNAME, "t", "gaussian")
    a, b = pd.read_csv(p_port), pd.read_csv(p_ref)
    assert list(a.columns) == list(b.columns) == list(maps_io.ROI_COLUMNS)
    pd.testing.assert_frame_equal(a, b, rtol=1e-6)
