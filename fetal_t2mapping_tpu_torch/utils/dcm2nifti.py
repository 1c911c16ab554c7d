"""In-repo DICOM -> NIfTI conversion (the dcm2niix replacement).

The reference shells out to the external ``dcm2niix`` C++ binary for every
run (reference utils/dcm_utils.py:259-312); this module makes the ingest
stage standalone: classic single-frame series (one file per slice) and
uncompressed enhanced multi-frame files are decoded with the in-repo DICOM
parser, assembled into a geometry-correct :class:`~..core.volume.Volume`
(LPS, direction-aware), and written through the NIfTI codec with a BIDS
sidecar JSON carrying the metadata keys the pipeline consumes
(utils.ingest.SIDE_CAR_KEYS).

A copy of ``fetal_t2mapping_tpu.utils.dcm2nifti`` writing through the
port's ``core.nifti``: the same decoded data, dtype, affine and sidecar.

Geometry (DICOM PS3.3 C.7.6.2): ImageOrientationPatient holds the row and
column direction cosines in LPS; the slice normal is their cross product;
PixelSpacing is (between-rows, between-columns) = (dy, dx). Slices are
sorted by the projection of ImagePositionPatient onto the normal, exactly
how dcm2niix orders them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import nifti
from ..core.volume import Volume
from .dicom import DicomDataset, InvalidDicomError, read_dcm

_DTYPES = {
    (8, 0): np.uint8, (8, 1): np.int8,
    (16, 0): np.uint16, (16, 1): np.int16,
    (32, 0): np.uint32, (32, 1): np.int32,
}


def _pixel_array(ds: DicomDataset, n_frames: int) -> np.ndarray:
    rows = int(ds.get("Rows"))
    cols = int(ds.get("Columns"))
    bits = int(ds.get("BitsAllocated") or 16)
    signed = int(ds.get("PixelRepresentation") or 0)
    samples = int(ds.get("SamplesPerPixel") or 1)
    if samples != 1:
        raise InvalidDicomError(f"SamplesPerPixel={samples} unsupported (scalar only)")
    dtype = _DTYPES.get((bits, signed))
    if dtype is None:
        raise InvalidDicomError(f"BitsAllocated={bits} signed={signed} unsupported")
    raw = ds.get("PixelData")
    if raw is None:
        raise InvalidDicomError("no PixelData (read_dcm(with_pixels=True) required)")
    n = n_frames * rows * cols
    arr = np.frombuffer(raw, dtype=dtype, count=n).reshape(n_frames, rows, cols)
    slope = float(ds.get("RescaleSlope") or 1.0)
    inter = float(ds.get("RescaleIntercept") or 0.0)
    out = arr.astype(np.float32)
    if slope != 1.0 or inter != 0.0:
        out = out * slope + inter
    return out


def _geometry(ds: DicomDataset):
    iop = np.asarray(ds.get("ImageOrientationPatient") or
                     [1, 0, 0, 0, 1, 0], np.float64)
    row_dir = iop[:3]                 # along increasing column index (x)
    col_dir = iop[3:]                 # along increasing row index (y)
    normal = np.cross(row_dir, col_dir)
    ps = np.atleast_1d(np.asarray(ds.get("PixelSpacing") or [1.0, 1.0], np.float64))
    dy, dx = (float(ps[0]), float(ps[-1]))
    return row_dir, col_dir, normal, dx, dy


def series_to_volume(paths: Sequence[str]) -> Tuple[Volume, DicomDataset]:
    """Assemble one classic series (one slice per file) into a Volume.

    Returns (volume, dataset-of-first-slice). Also handles a single
    enhanced multi-frame file (len(paths) == 1 with NumberOfFrames > 1).
    """
    if not paths:
        raise ValueError("empty series")
    datasets = [read_dcm(p, with_pixels=True) for p in paths]
    ref = datasets[0]
    row_dir, col_dir, normal, dx, dy = _geometry(ref)

    if len(datasets) == 1 and int(ref.get("NumberOfFrames") or 1) > 1:
        n_frames = int(ref.get("NumberOfFrames"))
        data = _pixel_array(ref, n_frames)
        dz = float(ref.get("SpacingBetweenSlices") or ref.get("SliceThickness") or 1.0)
        origin = np.asarray(ref.get("ImagePositionPatient") or [0, 0, 0], np.float64)
        # per-frame positions, when present, refine origin/spacing
        pf = ref.get("PerFrameFunctionalGroupsSequence")
        if pf:
            pos = []
            for item in pf:
                pps = item.get("PlanePositionSequence")
                if pps and pps[0].get("ImagePositionPatient") is not None:
                    pos.append(np.asarray(pps[0].get("ImagePositionPatient"), np.float64))
            if len(pos) == n_frames:
                proj = [float(np.dot(p, normal)) for p in pos]
                order = np.argsort(proj)
                data = data[order]
                origin = pos[int(order[0])]
                if n_frames > 1:
                    dz = float(np.median(np.diff(np.sort(proj))))
    else:
        slices = []
        for p, ds in zip(paths, datasets):
            ipp = np.asarray(ds.get("ImagePositionPatient") or [0, 0, 0], np.float64)
            inst = ds.get("InstanceNumber")
            slices.append((float(np.dot(ipp, normal)),
                           float(inst) if inst is not None else 0.0, ipp, ds))
        slices.sort(key=lambda s: (s[0], s[1]))
        if len(slices) > 1:
            proj = np.asarray([s[0] for s in slices])
            dup = np.any(np.abs(np.diff(proj)) < 1e-3)
            if dup:
                # stacking repeated positions would interleave echoes /
                # repetitions into one bogus volume — refuse loudly (the
                # ingest path groups by (series, EchoTime) and never hits this)
                tes = {ds.get("EchoTime") for _, _, _, ds in slices}
                hint = (" split the series by EchoTime first"
                        if len(tes) > 1 else "")
                raise ValueError(
                    f"series has {len(slices)} files but repeated slice "
                    f"positions (multiple echoes/repetitions?);{hint}")
        data = np.stack([_pixel_array(ds, 1)[0] for _, _, _, ds in slices])
        origin = slices[0][2]
        if len(slices) > 1:
            steps = np.diff([s[0] for s in slices])
            dz = float(np.median(steps))
            if dz <= 0:
                dz = float(ref.get("SliceThickness") or 1.0)
        else:
            dz = float(ref.get("SpacingBetweenSlices")
                       or ref.get("SliceThickness") or 1.0)

    direction = np.stack([row_dir, col_dir, normal], axis=1)  # columns: x,y,z
    vol = Volume(
        data=np.ascontiguousarray(data, np.float32),
        spacing=(dx, dy, abs(dz) if dz else 1.0),
        origin=tuple(float(o) for o in origin),
        direction=tuple(direction.reshape(-1)),
    )
    return vol, ref


def _sidecar(ds: DicomDataset) -> Dict:
    """BIDS sidecar dict with the keys the pipeline reads downstream."""
    iop = ds.get("ImageOrientationPatient")
    ps = ds.get("PixelSpacing")
    ps = np.atleast_1d(np.asarray(ps, float)) if ps is not None else None
    side = {
        "EchoTime": (float(ds.get("EchoTime")) / 1000.0
                     if ds.get("EchoTime") is not None else None),
        "RepetitionTime": (float(ds.get("RepetitionTime")) / 1000.0
                           if ds.get("RepetitionTime") is not None else None),
        "SliceThickness": (float(ds.get("SliceThickness"))
                           if ds.get("SliceThickness") is not None else None),
        "FlipAngle": (float(ds.get("FlipAngle"))
                      if ds.get("FlipAngle") is not None else None),
        "MagneticFieldStrength": ds.get("MagneticFieldStrength"),
        "SeriesDescription": ds.get("SeriesDescription"),
        "Modality": ds.get("Modality"),
        # the reference's converter name: the conversion is the same, and
        # sidecars from either package stay interchangeable
        "ConversionSoftware": "fetal_t2mapping_tpu.dcm2nifti",
        "Rows": int(ds.get("Rows")) if ds.get("Rows") is not None else None,
        "Columns": int(ds.get("Columns")) if ds.get("Columns") is not None else None,
        "ImageOrientationPatientDICOM": (list(np.asarray(iop, float))
                                         if iop is not None else None),
    }
    if ps is not None:
        side["PixelSpacingX"] = float(ps[0])
        side["PixelSpacingY"] = float(ps[-1])
    return side


def _disk_dtype(data: np.ndarray) -> np.dtype:
    """On-disk dtype for a converted series: int16 when the (rescaled)
    values are integral and fit, else uint16, else float32 — the same
    lossless-integer preference as dcm2niix, whose output files the
    reference pipeline consumes (reference utils/dcm_utils.py:259-312).
    Integer storage halves the file and every later device transfer of it."""
    if data.size == 0:
        return np.dtype(np.float32)
    lo, hi = float(data.min()), float(data.max())
    if not np.isfinite(lo) or not np.isfinite(hi):
        return np.dtype(np.float32)
    if np.all(np.mod(data, 1.0) == 0.0):
        if -32768 <= lo and hi <= 32767:
            return np.dtype(np.int16)
        if 0 <= lo and hi <= 65535:
            return np.dtype(np.uint16)
    return np.dtype(np.float32)


def convert_series(paths: Sequence[str], out_base: str) -> Tuple[str, str]:
    """Convert one series to ``out_base``.nii.gz + ``out_base``.json.

    Mirrors the dcm2niix call contract in utils.ingest.run_dcm2niix
    (reference utils/dcm_utils.py:259-312: -z y gzip output, -b y sidecar).
    """
    vol, ref = series_to_volume(paths)
    nii_path = out_base + ".nii.gz"
    json_path = out_base + ".json"
    nifti.write(nii_path, vol, dtype=_disk_dtype(np.asarray(vol.data)))
    with open(json_path, "w") as f:
        json.dump(_sidecar(ref), f, indent=2, sort_keys=True)
    return nii_path, json_path


def group_series(paths: Sequence[str]) -> Dict[str, List[str]]:
    """Group DICOM files by SeriesInstanceUID (fallback: SeriesNumber)."""
    groups: Dict[str, List[str]] = {}
    for p in paths:
        ds = read_dcm(p)
        key = str(ds.get("SeriesInstanceUID") or ds.get("SeriesNumber") or "series")
        groups.setdefault(key, []).append(p)
    return groups
