"""The port's stage-1 ingest (``utils/ingest``, ``cli/dcm2csv``) against the
JAX package's, on the same DICOM trees, on the CPU.

Every helper of ``utils/ingest`` returns and writes what the reference's
does; ``dcm2csv --check`` prints the same lines; ``dcm2csv --process``,
run by each package on its own copy of a tree (no ``dcm2niix`` on PATH, so
the in-repo converter runs), writes the same files: NIfTIs equal once
decompressed, equal sidecars, and session CSVs equal when read back with
pandas (their ``path`` column names each copy). A path without a
``dicom`` component, or one that does not exist, gives rc 1 in both.
"""

import builtins
import gzip
import json
import os

import numpy as np
import pandas as pd
import pytest

from fetal_t2mapping_tpu.cli import dcm2csv as ref_cli
from fetal_t2mapping_tpu.utils import dicom as ref_dicom
from fetal_t2mapping_tpu.utils import ingest as ref
from fetal_t2mapping_tpu_torch.cli import dcm2csv as cli
from fetal_t2mapping_tpu_torch.utils import dicom, ingest
from tests.test_dcm2nifti import (
    write_test_dicom,
    write_test_dicom_jpegll,
    write_test_dicom_multiframe,
)
from tests.test_ingest import make_dicom

LOG = [{"date": "2024080610", "dcm_parent": "30540000",
        "prj": "prj-003", "sub": "sub-001", "ses": "ses-01"}]


@pytest.fixture(autouse=True)
def no_dcm2niix(monkeypatch):
    """The in-repo converter runs: no dcm2niix on PATH."""
    monkeypatch.setenv("PATH", os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(d, "dcm2niix"))))


def _pix(seed, shape=(16, 16)):
    return np.random.default_rng(seed).integers(0, 3000, shape).astype(np.uint16)


def _tree(root):
    """qMRI/dicom/2024080610/30540000/ (logged: three single-frame echoes,
    one multi-frame and one JPEG-lossless file, a text file) and
    qMRI/dicom/2024080611/11110000/ (not in the log), with log_dcms.csv."""
    logged = os.path.join(root, "dicom", "2024080610", "30540000")
    other = os.path.join(root, "dicom", "2024080611", "11110000")
    os.makedirs(logged)
    os.makedirs(other)
    for i, te in enumerate([114.0, 202.0, 299.0]):
        write_test_dicom(os.path.join(logged, f"im{i}.dcm"), _pix(i), ipp=(0.0, 0.0, 2.0 * i),
                         te=te, instance=i + 1, series_uid=f"1.2.3.{i}")
    write_test_dicom_multiframe(os.path.join(logged, "mf.dcm"), _pix(5, (4, 16, 16)),
                                ipp=(1.0, 2.0, 30.0), iop=(1, 0, 0, 0, 0, -1), dz=4.0)
    write_test_dicom_jpegll(os.path.join(logged, "jll.dcm"), _pix(6), ipp=(0.0, 0.0, 0.0))
    with open(os.path.join(logged, "notes.txt"), "w") as f:
        f.write("acquisition notes, not a DICOM file")
    write_test_dicom(os.path.join(other, "x.dcm"), _pix(7), ipp=(0.0, 0.0, 0.0))
    os.makedirs(os.path.join(root, "dicom", "logs"))
    pd.DataFrame(LOG).to_csv(os.path.join(root, "dicom", "logs", "log_dcms.csv"), index=False)
    return os.path.join(root, "dicom"), logged


@pytest.fixture
def tree(tmp_path):
    return _tree(str(tmp_path / "qMRI"))


@pytest.mark.parametrize("iop", [[1, 0, 0, 0, 1, 0], [1, 0, 0, 0, 0, -1], [0, 1, 0, 0, 0, -1],
                                 [0.7, 0.7, 0, 0, 0, -1], [0.98, 0.02, 0, 0, 0.1, -0.99],
                                 [-1, 0, 0, 0, 1, 0]])
def test_get_orientation_equals_reference(iop):
    assert ingest.get_orientation_dcm(iop) == ref.get_orientation_dcm(iop)


def test_file_scan_and_entries_equal_reference(tree, tmp_path):
    dicom_root, logged = tree
    files = ingest.get_dcm_files(dicom_root)
    assert files == ref.get_dcm_files(dicom_root)
    assert len(files) == 6 and not any(f.endswith(".txt") or f.endswith(".csv") for f in files)
    for f in files:
        for structured in (False, True):
            assert ingest.build_dcm_entry(f, structured) == ref.build_dcm_entry(f, structured)
    assert ingest.get_dcms(dicom_root) == ref.get_dcms(dicom_root)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(dicom.InvalidDicomError) as got:
        ingest.get_dcms(empty)
    with pytest.raises(ref_dicom.InvalidDicomError) as want:
        ref.get_dcms(empty)
    assert str(got.value) == str(want.value)


def test_assign_bids_equals_reference(tree, monkeypatch, capsys):
    dicom_root, _ = tree
    log = os.path.join(os.path.dirname(dicom_root), "dicom", "logs", "log_dcms.csv")
    assert ingest.get_bids_from_log(log, "2024080610", "30540000") == \
        ref.get_bids_from_log(log, "2024080610", "30540000")
    dcms = ingest.get_dcms(dicom_root)
    got = ingest.assign_bids(dcms, log)
    out_port = capsys.readouterr().out
    want = ref.assign_bids(dcms, log)
    assert capsys.readouterr().out == out_port and "no matching" in out_port
    pd.testing.assert_frame_equal(got, want)
    assert list(got["run"]) == [f"run-{r:02d}" for r in range(1, 6)]
    answers = {}
    for name, fn in (("port", ingest.assign_bids), ("ref", ref.assign_bids)):
        replies = iter(["n", "y"])
        monkeypatch.setattr(builtins, "input", lambda prompt: next(replies))
        answers[name] = fn(dcms, log, interactive=True)
    pd.testing.assert_frame_equal(answers["port"], answers["ref"])


def test_conversion_helpers_write_what_the_reference_writes(tmp_path, capsys):
    """run_dcm2niix (in-repo converter), enrich_sidecar, get_metabids and
    dcms2csv, each package on its own copy."""
    frames, outs = {}, {}
    for name, mod in (("port", ingest), ("ref", ref)):
        root = str(tmp_path / name / "qMRI")
        dicom_root, _ = _tree(root)
        log = os.path.join(root, "dicom", "logs", "log_dcms.csv")
        assert mod.dcm2niix_available() is False
        df = mod.assign_bids(mod.get_dcms(dicom_root), log)
        bids = os.path.join(root, "projects/")
        mod.run_dcm2niix(df, bids)
        mod.run_dcm2niix(df, bids)                       # resumed: "already IN"
        df = mod.get_metabids(df, mod.SIDE_CAR_KEYS, bids)
        mod.dcms2csv(os.path.join(root, "dicom", "logs/"), df)
        frames[name] = df.assign(path=df["path"].str.replace(root, "", regex=False))
        outs[name] = capsys.readouterr().out.replace(root, "<root>")
    pd.testing.assert_frame_equal(frames["port"], frames["ref"])
    assert outs["port"] == outs["ref"] and "already IN" in outs["port"]
    _same_trees(str(tmp_path / "port" / "qMRI"), str(tmp_path / "ref" / "qMRI"))


def test_enrich_sidecar_equals_reference(tmp_path):
    """A sidecar without an orientation, against a file carrying its pixel
    spacing in the per-frame functional groups."""
    p = str(tmp_path / "enh.dcm")
    make_dicom(p, spacing=(0.5, 0.75), iop=(0, 1, 0, 0, 0, -1))
    texts = []
    for mod in (ingest, ref):
        js = str(tmp_path / f"{mod.__name__.split('.')[0]}.json")
        with open(js, "w") as f:
            json.dump({"EchoTime": 0.114}, f)
        mod.enrich_sidecar(js, p)
        texts.append(open(js).read())
    assert texts[0] == texts[1]
    side = json.loads(texts[0])
    assert side["ImageOrientationPatientSTR"] == "sag" and side["PixelSpacingX"] == 0.5


def test_config_and_sequence_json_equal_reference(tmp_path, capsys):
    df = pd.DataFrame({"sub": ["sub-001"] * 3 + ["sub-002"] * 2,
                       "ses": ["ses-01"] * 3 + ["ses-02"] * 2,
                       "run": ["run-01", "run-02", "run-03", "run-01", "run-02"]})
    outs = {}
    for name, mod in (("port", ingest), ("ref", ref)):
        d = str(tmp_path / name) + os.sep
        os.makedirs(d)
        cfg = mod.gen_config_json(df, d)
        enh = str(tmp_path / name / "enh.dcm")
        make_dicom(enh, series="t2_haste_tra", rows=320, cols=260)
        seq = mod.gen_seq_json(mod.read_dcm(enh), d + "seq.json")
        outs[name] = (cfg, seq, open(d + "001_params.json").read(), open(d + "seq.json").read(),
                      capsys.readouterr().out.replace(d, "<dir>"))
    assert outs["port"] == outs["ref"]


def _same_trees(root_p, root_r):
    fp, fr = ({os.path.relpath(os.path.join(d, n), r): os.path.join(d, n)
               for d, _, names in os.walk(r) for n in names} for r in (root_p, root_r))
    assert sorted(fp) == sorted(fr)
    n_nii = n_csv = 0
    for rel, pr in fr.items():
        pp = fp[rel]
        if rel.endswith(".nii.gz"):
            with gzip.open(pp) as a, gzip.open(pr) as b:
                assert a.read() == b.read(), rel
            n_nii += 1
        elif rel.endswith(".csv"):
            a, b = pd.read_csv(pp), pd.read_csv(pr)
            if "path" in a:
                a["path"] = a["path"].str.replace(root_p, "", regex=False)
                b["path"] = b["path"].str.replace(root_r, "", regex=False)
            pd.testing.assert_frame_equal(a, b)
            n_csv += 1
        elif rel.endswith(".json"):
            assert json.load(open(pp)) == json.load(open(pr)), rel
        else:
            assert open(pp, "rb").read() == open(pr, "rb").read(), rel
    assert n_nii == 5 and n_csv == 2


def test_cli_check_prints_what_the_reference_prints(tree, capsys):
    dicom_root, logged = tree
    for path, n_series in ((dicom_root, 4), (logged, 3)):
        assert cli.main(["--path", path, "--check"]) == 0
        got = capsys.readouterr().out
        assert ref_cli.main(["--path", path, "--check"]) == 0
        assert capsys.readouterr().out == got
        assert got.count("t2_haste_test") == n_series and "<not DICOM" in got


@pytest.mark.parametrize("where", ["dicom root", "session"])
def test_cli_process_writes_what_the_reference_writes(tmp_path, capsys, where):
    outs = {}
    for name, main in (("port", cli.main), ("ref", ref_cli.main)):
        root = str(tmp_path / name / "qMRI")
        dicom_root, logged = _tree(root)
        assert main(["--path", dicom_root if where == "dicom root" else logged,
                     "--process"]) == 0
        outs[name] = capsys.readouterr().out.replace(root, "<root>")
    assert outs["port"] == outs["ref"]
    assert outs["port"].count("BIDSified") == 5
    _same_trees(str(tmp_path / "port" / "qMRI"), str(tmp_path / "ref" / "qMRI"))


@pytest.mark.parametrize("argv", [["--path", "{tmp}", "--process"],
                                  ["--path", "{tmp}/missing/dicom", "--check"]],
                         ids=["no dicom component", "missing"])
def test_cli_rejects_bad_paths_as_the_reference(tmp_path, capsys, argv):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    assert cli.main(argv) == 1
    got = capsys.readouterr()
    assert ref_cli.main(argv) == 1
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err) and "Error" in got.err
