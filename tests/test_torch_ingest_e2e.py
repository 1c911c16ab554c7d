"""DICOM -> T2 maps through the port's three CLIs on the CPU, at a small
size: chip_smoke.py's phase 15 run on its in-vivo scene at 48 x 48 x 12
slabs (3 TEs x ax/cor/sag, the first TE's axial stack JPEG-lossless).

- The port's ``dcm2csv --process`` and the JAX package's, each on a copy
  of the same DICOM tree (no ``dcm2niix`` on PATH): equal file lists,
  NIfTIs equal once decompressed (header and voxels), equal sidecars and
  equal session CSVs read back with pandas (``path`` apart, which names
  each copy).
- The phase itself, on the CPU: the ingested NIfTIs hold the pixels
  written and their affines match the volumes' (origin 1e-3 mm, direction
  1e-6), ``qmri_reconstruction`` and ``t2mapping`` recover the truth as
  tests/test_torch_recon_pipeline.py gates its scene (fused recon median
  relative error < 0.06 on the core, BET = recon x mask, T2 median
  relative error <= 5e-2 in mask and brain). ``t2mapping`` runs as on a
  machine without matplotlib: it warns and writes no figures.
"""

import gzip
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke as cs
from fetal_t2mapping_tpu.cli import dcm2csv as ref_dcm2csv
from fetal_t2mapping_tpu.core import nifti as ref_nifti
from fetal_t2mapping_tpu_torch.cli import dcm2csv, t2mapping
from fetal_t2mapping_tpu_torch.core import nifti

torch.set_num_threads(2)

N = 48


def _no_dcm2niix_path():
    return os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                           if not os.path.exists(os.path.join(d, "dcm2niix")))


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    """One DICOM tree in two copies, ingested by the port and by the JAX
    package."""
    base = tmp_path_factory.mktemp("ingest_e2e")
    acqs, _ = cs.invivo_acquisitions(N)
    src = str(base / "src" / "qMRI")
    session, written = cs.write_dicom_session(src, acqs)
    roots = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", _no_dcm2niix_path())
        for name, main in (("port", dcm2csv.main), ("ref", ref_dcm2csv.main)):
            roots[name] = str(base / name / "qMRI")
            shutil.copytree(src, roots[name])
            rel = os.path.relpath(session, src)
            assert main(["--path", os.path.join(roots[name], rel), "--process"]) == 0
    return roots, written


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def test_port_ingest_equals_reference(ingested):
    roots, written = ingested
    port, ref = _tree(roots["port"]), _tree(roots["ref"])
    assert sorted(port) == sorted(ref)
    niis = [r for r in port if r.endswith(".nii.gz")]
    sidecars = [r for r in port if r.startswith("projects") and r.endswith(".json")]
    assert len(niis) == len(sidecars) == len(written) == 9
    for rel in niis:
        a, b = nifti.read(port[rel]), ref_nifti.read(ref[rel])
        assert a.data.dtype == np.asarray(b.data).dtype == np.int16
        np.testing.assert_array_equal(a.data, np.asarray(b.data))
        with gzip.open(port[rel]) as fa, gzip.open(ref[rel]) as fb:
            assert fa.read() == fb.read(), rel
    for rel in sidecars:
        with open(port[rel]) as fa, open(ref[rel]) as fb:
            assert json.load(fa) == json.load(fb), rel
    csv_name = f"dicom/logs/{cs.INGEST_DATE}_{cs.INGEST_PARENT}.csv"
    a, b = pd.read_csv(port[csv_name]), pd.read_csv(ref[csv_name])
    assert list(a["path"].str.replace(roots["port"], "", regex=False)) == list(
        b["path"].str.replace(roots["ref"], "", regex=False))
    pd.testing.assert_frame_equal(a.drop(columns="path"), b.drop(columns="path"))
    assert list(a["run"]) == sorted(written)


def test_encoder_processes_give_the_same_streams():
    """write_dicom_session's JPEG-lossless frames, encoded in spawned
    processes as on the card's host, equal the in-process encoding."""
    frames = np.random.default_rng(0).integers(0, 900, (3, 16, 12)).astype(np.uint16)
    assert cs.encode_frames(frames, 2) == cs.encode_frames(frames, 1)


def test_smoke_phase15_chain_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(t2mapping, "have_matplotlib", lambda: False)
    out = cs.phase15_ingest_chain(n=N, device="cpu", workers=1)
    assert out["launches"] == 0                     # plain versions on the CPU
    assert out["decoders_ms"]["jpegll (host library)"] > 0
    captured = capsys.readouterr()
    assert "matplotlib is not importable" in captured.err
    assert "phase 15 ingest chain" in captured.out
