"""Stage 1: DICOM -> BIDS NIfTI ingest + metadata CSV logs.

Equivalent of the reference's utils/dcm_utils.py: walk session directories
for DICOM files, resolve BIDS ids from the master ``log_dcms.csv``, convert
with the external ``dcm2niix`` binary (gated on availability), enrich the
JSON sidecars with Rows/Columns/PixelSpacing/orientation-string, read the
sidecars back into the session metadata CSVs that drive the later stages.

Differences by design: the per-session prompt (reference
utils/dcm_utils.py:144 blocks on input()) is an *option*; the default is
non-interactive assignment of every session found in the log.

A copy of ``fetal_t2mapping_tpu.utils.ingest``; its file probe is the
port's host library (``build.dicom_probe``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from .bids import mk_bids_dir
from .dicom import InvalidDicomError, read_dcm

SIDE_CAR_KEYS = [
    "CoilString", "EchoTime", "RepetitionTime", "SliceThickness", "FlipAngle",
    "EchoTrainLength", "PixelBandwidth", "PixelSpacingX", "PixelSpacingY",
    "ImageOrientationPatientDICOM", "ImageOrientationPatientSTR",
]


def get_orientation_dcm(img_orientation) -> str:
    """Classify an ImageOrientationPatient 6-vector as ax / cor / sag."""
    arr = np.round(np.asarray(img_orientation, float)).astype(int)
    if np.array_equal(arr, [1, 0, 0, 0, 1, 0]):
        return "ax"
    if np.array_equal(arr, [1, 0, 0, 0, 0, -1]):
        return "cor"
    if np.array_equal(arr, [0, 1, 0, 0, 0, -1]):
        return "sag"
    return "custom"


def get_dcm_files(directory: str) -> List[str]:
    """Walk a session directory and keep Part-10 DICOM files.

    Uses the host library's threaded magic probe (132-byte reads) — the
    reference validates candidates by fully parsing each file with pydicom
    (utils/dcm_utils.py:54-65), which reads gigabytes on big sessions; the
    probe touches a few hundred KB."""
    from .. import build

    candidates = []
    for root, _, files in os.walk(directory):
        for f in sorted(files):
            candidates.append(os.path.join(root, f))
    flags = build.dicom_probe(candidates)
    return [p for p, flag in zip(candidates, flags) if flag == 1]


def build_dcm_entry(dcm_path: str, structured: bool = False) -> Dict:
    ds = read_dcm(dcm_path)
    # absolute + normalized so the fixed component offsets below are stable
    # for relative inputs ('.', 'session/file.dcm') and trailing slashes
    parts = os.path.abspath(dcm_path).split(os.sep)
    date_idx, parent_idx = (-4, -3) if structured else (-3, -2)
    if len(parts) < abs(date_idx):
        raise InvalidDicomError(
            f"{dcm_path}: path too shallow for the expected "
            "dicom/YYYYMMDDHH/MMSS0000/file layout")
    return {
        "date": parts[date_idx],
        "dcm_parent": parts[parent_idx],
        "acquisition_time": ds.get("AcquisitionDateTime", ""),
        "dcm_reference": os.path.basename(dcm_path),
        "description": str(ds.get("SeriesDescription", "")).strip(),
        "path": dcm_path,
        "prj": None, "sub": None, "ses": None, "run": None,
    }


def get_dcms(dicom_path: str, structured: bool = False) -> List[Dict]:
    """Scan a directory tree for DICOMs, sorted by acquisition time."""
    files = get_dcm_files(dicom_path)
    if not files:
        raise InvalidDicomError(f"{dicom_path}: no DICOM files found")
    entries = [build_dcm_entry(p, structured) for p in files]
    return sorted(entries, key=lambda e: e["acquisition_time"])


def get_bids_from_log(log_path: str, date, parent: str):
    df = pd.read_csv(log_path)
    hit = df[(df["date"].astype(str) == str(date)) & (df["dcm_parent"].astype(str) == str(parent))]
    if hit.empty:
        raise InvalidDicomError(
            f"no matching (date={date}, dcm_parent={parent}) in {os.path.basename(log_path)}")
    row = hit.iloc[0]
    return row["prj"], row["sub"], row["ses"]


def assign_bids(dcms: Sequence[Dict], log_path: str, *, interactive: bool = False) -> pd.DataFrame:
    """Attach prj/sub/ses/run to each DICOM entry from the master log."""
    df = pd.DataFrame(dcms)
    keep = np.ones(len(df), bool)
    for (date, parent), _ in df.groupby(["date", "dcm_parent"]):
        sel = (df["date"] == date) & (df["dcm_parent"] == parent)
        if interactive:
            ans = input(f"Assign BIDS id to {date} - {parent}? (y/n): ")
            if ans.strip().lower() != "y":
                keep &= ~sel.to_numpy()
                continue
        try:
            prj, sub, ses = get_bids_from_log(log_path, date, parent)
        except InvalidDicomError as e:
            print(e)
            keep &= ~sel.to_numpy()
            continue
        df.loc[sel, ["prj", "sub", "ses"]] = prj, sub, ses
        runs = np.arange(1, int(sel.sum()) + 1)
        df.loc[sel, "run"] = [f"run-{r:02d}" for r in runs]
    return df[keep].reset_index(drop=True)


def dcm2niix_available() -> bool:
    return shutil.which("dcm2niix") is not None


def run_dcm2niix(df: pd.DataFrame, bids_dir: str) -> None:
    """Convert each run to BIDS NIfTI + sidecar; skip already-converted.

    Uses the external dcm2niix binary when present (the reference's
    converter, utils/dcm_utils.py:259-312) and otherwise falls back to the
    in-repo converter (utils.dcm2nifti) — the framework ingests standalone.
    """
    use_binary = dcm2niix_available()
    for (prj, sub, ses), g in df.groupby(["prj", "sub", "ses"]):
        anat = mk_bids_dir(bids_dir, prj, sub, ses, "anat")
        for _, entry in g.iterrows():
            base = f"{sub}_{ses}_{entry['run']}_T2w"
            nii = os.path.join(anat, base + ".nii.gz")
            if os.path.exists(nii):
                print(f"{prj}_{sub}_{ses}_{entry['run']} already IN")
                continue
            if use_binary:
                subprocess.run(
                    ["dcm2niix", "-f", base, "-o", anat, "-s", "y", "-b", "y",
                     "-ba", "y", "-z", "y", entry["path"]],
                    check=True, stdout=subprocess.DEVNULL)
            else:
                from .dcm2nifti import convert_series

                convert_series([entry["path"]], os.path.join(anat, base))
            enrich_sidecar(os.path.join(anat, base + ".json"), entry["path"])
            print(f"{prj}_{sub}_{ses}_{entry['run']} BIDSified")


def enrich_sidecar(json_path: str, dcm_path: str) -> None:
    """Add Rows/Columns/PixelSpacing/orientation-string to the sidecar."""
    with open(json_path) as f:
        side = json.load(f)
    ds = read_dcm(dcm_path)
    side["Rows"] = int(ds.get("Rows")) if ds.get("Rows") is not None else None
    side["Columns"] = int(ds.get("Columns")) if ds.get("Columns") is not None else None
    spacing = None
    pf = ds.get("PerFrameFunctionalGroupsSequence")
    if pf:
        pm = pf[0].get("PixelMeasuresSequence")
        if pm:
            spacing = pm[0].get("PixelSpacing")
    if spacing is None:
        spacing = ds.get("PixelSpacing")
    if spacing is not None:
        spacing = np.atleast_1d(spacing).astype(float)
        side["PixelSpacingX"] = float(spacing[0])
        side["PixelSpacingY"] = float(spacing[-1])
    iop = side.get("ImageOrientationPatientDICOM")
    if iop is None:
        iop = ds.get("ImageOrientationPatient")
        side["ImageOrientationPatientDICOM"] = iop
    if iop is not None:
        side["ImageOrientationPatientSTR"] = get_orientation_dcm(iop)
    with open(json_path, "w") as f:
        json.dump(side, f, indent=4)


def get_metabids(df: pd.DataFrame, keys: Sequence[str], bids_dir: str) -> pd.DataFrame:
    """Read sidecar keys back into the metadata frame (reference :207-243)."""
    new_keys = [k for k in keys if k not in df.columns]
    if not new_keys:
        return df
    data = {k: [] for k in new_keys}
    for _, entry in df.iterrows():
        jp = os.path.join(bids_dir, entry["prj"], entry["sub"], entry["ses"], "anat",
                          f"{entry['sub']}_{entry['ses']}_{entry['run']}_T2w.json")
        side = {}
        if os.path.exists(jp):
            with open(jp) as f:
                side = json.load(f)
        for k in new_keys:
            data[k].append(side.get(k))
    return pd.concat([df.reset_index(drop=True), pd.DataFrame(data)], axis=1)


def gen_config_json(df: pd.DataFrame, out_path: str, sr_id: int = 0,
                    do_anat_orient: bool = True) -> Dict:
    """Super-resolution toolkit params JSON (reference utils/dcm_utils.py:316-367).

    One entry per (sub, ses) with the stack index list sized to the number
    of runs in that session; written to ``<out_path>001_params.json`` (the
    reference's filename convention, kept for drop-in compatibility).
    Accepts either this framework's prj/sub/ses columns or the reference's
    sub_id/ses_id.
    """
    sub_col = "sub" if "sub" in df.columns else "sub_id"
    ses_col = "ses" if "ses" in df.columns else "ses_id"
    output: Dict = {}
    for (sub, ses), g in df.groupby([sub_col, ses_col]):
        output.setdefault(sub, []).append({
            "sr-id": sr_id,
            "session": ses,
            "stacks": list(range(1, len(g) + 1)),
            "custom_interfaces": {"do_anat_orientation": do_anat_orient},
        })
    dst = out_path + "001_params.json"
    with open(dst, "w") as f:
        json.dump(output, f, indent=4)
    print(f"JSON structure saved to: {dst}")
    return output


# sequence-parameter summary keys: (json key, top-level DICOM keyword) —
# nested functional-group values are resolved separately below
_SEQ_JSON_KEYS = [
    ("StudyDate", "StudyDate"), ("Modality", "Modality"),
    ("MagneticFieldStrength", "MagneticFieldStrength"),
    ("Manufacturer", "Manufacturer"),
    ("ManufacturersModelName", "ManufacturerModelName"),
    ("SoftwareVersions", "SoftwareVersions"),
    ("StationName", "StationName"),
    ("DeviceSerialNumber", "DeviceSerialNumber"),
    ("InstitutionName", "InstitutionName"),
    ("InstitutionAddress", "InstitutionAddress"),
    ("StudyDescription", "StudyDescription"),
    ("SeriesDescription", "SeriesDescription"),
    ("ProtocolName", "ProtocolName"),
    ("MRAcquisitionType", "MRAcquisitionType"),
    ("BodyPartExamined", "BodyPartExamined"),
    ("NumberOfFrames", "NumberOfFrames"),
]


def _seq_nested(ds, group: str, seq: str, key: str):
    g = ds.get(group)
    if not g:
        return None
    s = g[0].get(seq) if hasattr(g[0], "get") else None
    if not s:
        return None
    return s[0].get(key) if hasattr(s[0], "get") else None


def gen_seq_json(ds, json_file_path: str) -> Dict:
    """Sequence-parameter summary JSON (reference utils/dcm_utils.py:369-419,
    marked obsolete there — dcm2niix sidecars superseded it).

    Unlike the reference, missing attributes become null instead of raising
    AttributeError, so the helper works on any vendor's headers. The
    private-tag FOV lookup (Siemens 0021,10fe) is skipped for the same
    reason.
    """
    seq = {k: ds.get(a) for k, a in _SEQ_JSON_KEYS}
    sfg, pfg = "SharedFunctionalGroupsSequence", "PerFrameFunctionalGroupsSequence"
    seq["ParallelAcquisitionTechnique"] = _seq_nested(
        ds, sfg, "MRModifierSequence", "ParallelAcquisitionTechnique")
    seq["PartialFourier"] = _seq_nested(ds, sfg, "MRModifierSequence", "PartialFourier")
    timing = "MRTimingAndRelatedParametersSequence"
    seq["Repetition Time"] = _seq_nested(ds, sfg, timing, "RepetitionTime")
    seq["EchoTrainLength"] = _seq_nested(ds, sfg, timing, "EchoTrainLength")
    seq["FlipAngle"] = _seq_nested(ds, sfg, timing, "FlipAngle")
    seq["RFEChoTrainLength"] = _seq_nested(ds, sfg, timing, "RFEchoTrainLength")
    seq["EchoNumbers"] = _seq_nested(ds, pfg, "MREchoSequence", "EchoNumbers")
    seq["EffectiveEchoTime"] = _seq_nested(ds, pfg, "MREchoSequence", "EffectiveEchoTime")
    rows, cols = ds.get("Rows"), ds.get("Columns")
    seq["Rows"] = str(int(rows)) if rows is not None else None
    seq["Columns"] = str(int(cols)) if cols is not None else None
    pm = "PixelMeasuresSequence"
    seq["SliceThickness"] = _seq_nested(ds, pfg, pm, "SliceThickness") or ds.get("SliceThickness")
    seq["SpacingBetweenSlices"] = _seq_nested(ds, pfg, pm, "SpacingBetweenSlices")
    spacing = _seq_nested(ds, pfg, pm, "PixelSpacing")
    if spacing is None:
        spacing = ds.get("PixelSpacing")
    if spacing is not None:
        spacing = np.atleast_1d(spacing).astype(float)
        seq["PixelSpacingX"] = float(spacing[0])
        seq["PixelSpacingY"] = float(spacing[-1])

    def _clean(v):
        return v.item() if isinstance(v, np.generic) else v

    seq = {k: _clean(v) for k, v in seq.items()}
    with open(json_file_path, "w") as f:
        json.dump([seq], f, indent=4)
    print(f"JSON structure saved to: {json_file_path}")
    return seq


def dcms2csv(csv_path: str, df: pd.DataFrame) -> List[str]:
    """One session-log CSV per (date, dcm_parent) (reference :168-175)."""
    os.makedirs(csv_path, exist_ok=True)
    paths = []
    for (date, parent), g in df.groupby(["date", "dcm_parent"]):
        p = os.path.join(csv_path, f"{date}_{parent}.csv")
        g.to_csv(p, index=False)
        paths.append(p)
        print(f"CSV file '{p}' has been created.")
    return paths
