"""Minimal pure-Python DICOM (Part-10) tag reader.

The execution image has no pydicom, so the framework ships a small reader
covering what the ingest stage needs (reference utils/dcm_utils.py uses
pydicom only to probe validity and pull a handful of attributes:
AcquisitionDateTime, SeriesDescription, Rows/Columns, ImageOrientationPatient,
PixelSpacing from the per-frame functional groups). Supports explicit and
implicit VR little-endian transfer syntaxes (plus deflated), including
nested sequences with defined or undefined lengths. Pixel data is returned
raw for the native syntaxes and DECODED for the compressed ones scanners
actually export (reference utils/dcm_utils.py:259-312 delegates these to
the dcm2niix binary): RLE Lossless (1.2.840.10008.1.2.5, PS3.5 Annex G)
JPEG Lossless Process 14 / SV1 (1.2.840.10008.1.2.4.57/.70, via the host
library's ft2_jpegll_decode, ``build.jpegll_decode``; a stream outside its
scope goes to utils/jpegll.py, which raises the specific error), and
JPEG 2000 / JPEG 2000 Lossless (1.2.840.10008.1.2.4.90/.91, via the
image's OpenJPEG through PIL — writing an EBCOT Tier-1 coder in-repo buys
nothing over the system codec), and lossy classic JPEG
(1.2.840.10008.1.2.4.50/.51: 8-bit via PIL/libjpeg, 12-bit Extended via
the in-repo sequential-DCT codec utils/jpegdct.py). Every transfer syntax
dcm2niix handles now decodes in-repo.

If pydicom IS importable it is used transparently (read_dcm prefers it).

A copy of ``fetal_t2mapping_tpu.utils.dicom``: the same elements and the
same decoded pixels in every transfer syntax.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_TAG_NAMES = {
    (0x0008, 0x0020): "StudyDate",
    (0x0008, 0x002A): "AcquisitionDateTime",
    (0x0008, 0x0060): "Modality",
    (0x0008, 0x103E): "SeriesDescription",
    (0x0008, 0x1090): "ManufacturerModelName",
    (0x0010, 0x0010): "PatientName",
    (0x0018, 0x0050): "SliceThickness",
    (0x0018, 0x0080): "RepetitionTime",
    (0x0018, 0x0081): "EchoTime",
    (0x0018, 0x0087): "MagneticFieldStrength",
    (0x0018, 0x1314): "FlipAngle",
    (0x0018, 0x0088): "SpacingBetweenSlices",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0011): "SeriesNumber",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0020, 0x9113): "PlanePositionSequence",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
    (0x0028, 0x9110): "PixelMeasuresSequence",
    (0x5200, 0x9229): "SharedFunctionalGroupsSequence",
    (0x5200, 0x9230): "PerFrameFunctionalGroupsSequence",
    (0x0018, 0x9112): "MRTimingAndRelatedParametersSequence",
    (0x0018, 0x9114): "MREchoSequence",
    (0x0018, 0x9082): "EffectiveEchoTime",
    # sequence-parameter summary attributes (utils.ingest.gen_seq_json;
    # reference utils/dcm_utils.py:369-419)
    (0x0008, 0x0070): "Manufacturer",
    (0x0008, 0x0080): "InstitutionName",
    (0x0008, 0x0081): "InstitutionAddress",
    (0x0008, 0x1010): "StationName",
    (0x0008, 0x1030): "StudyDescription",
    (0x0018, 0x0015): "BodyPartExamined",
    (0x0018, 0x0023): "MRAcquisitionType",
    (0x0018, 0x0086): "EchoNumbers",
    (0x0018, 0x0091): "EchoTrainLength",
    (0x0018, 0x0095): "PixelBandwidth",
    (0x0018, 0x1000): "DeviceSerialNumber",
    (0x0018, 0x1020): "SoftwareVersions",
    (0x0018, 0x1030): "ProtocolName",
    (0x0018, 0x9078): "ParallelAcquisitionTechnique",
    (0x0018, 0x9081): "PartialFourier",
    (0x0018, 0x9115): "MRModifierSequence",
    (0x0018, 0x9240): "RFEchoTrainLength",
}
_NAME_TO_TAG = {v: k for k, v in _TAG_NAMES.items()}

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}
_STOP_TAG = (0x7FE0, 0x0010)  # PixelData — parsed only when pixels requested

# VRs of binary tags under implicit-VR-little-endian (otherwise they would
# decode as text garbage; only the tags the converter needs numerically)
_IMPLICIT_VRS = {
    (0x0018, 0x0050): b"DS",   # SliceThickness
    (0x0018, 0x0080): b"DS",   # RepetitionTime
    (0x0018, 0x0081): b"DS",   # EchoTime
    (0x0018, 0x0087): b"DS",   # MagneticFieldStrength
    (0x0018, 0x0088): b"DS",   # SpacingBetweenSlices
    (0x0018, 0x1314): b"DS",   # FlipAngle
    (0x0020, 0x0011): b"IS",   # SeriesNumber
    (0x0020, 0x0013): b"IS",   # InstanceNumber
    (0x0020, 0x0032): b"DS",   # ImagePositionPatient
    (0x0020, 0x0037): b"DS",   # ImageOrientationPatient
    (0x0028, 0x0002): b"US",
    (0x0028, 0x0008): b"IS",
    (0x0028, 0x0010): b"US",
    (0x0028, 0x0011): b"US",
    (0x0028, 0x0030): b"DS",   # PixelSpacing
    (0x0028, 0x0100): b"US",
    (0x0028, 0x0103): b"US",
    (0x0028, 0x1052): b"DS",   # RescaleIntercept
    (0x0028, 0x1053): b"DS",   # RescaleSlope
    (0x0018, 0x0086): b"IS",   # EchoNumbers
    (0x0018, 0x0091): b"IS",   # EchoTrainLength
    (0x0018, 0x0095): b"DS",   # PixelBandwidth
    (0x0018, 0x9240): b"US",   # RFEchoTrainLength
}


class InvalidDicomError(ValueError):
    pass


class DicomDataset:
    """Flat mapping of parsed elements; sequences hold lists of datasets."""

    def __init__(self, elements: Dict[Tuple[int, int], Any]):
        self._el = elements

    def get(self, key, default=None):
        tag = _NAME_TO_TAG.get(key, key) if isinstance(key, str) else key
        return self._el.get(tag, default)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        tag = _NAME_TO_TAG.get(name)
        if tag is not None and tag in self._el:
            return self._el[tag]
        raise AttributeError(f"no DICOM attribute {name!r} parsed")

    def __contains__(self, key):
        tag = _NAME_TO_TAG.get(key, key) if isinstance(key, str) else key
        return tag in self._el

    def keys(self):
        return [(f"{g:04x},{e:04x}", _TAG_NAMES.get((g, e))) for g, e in self._el]


def _decode_value(vr: bytes, raw: bytes):
    if vr in (b"US",):
        return struct.unpack("<" + "H" * (len(raw) // 2), raw)[0] if len(raw) >= 2 else None
    if vr in (b"UL",):
        return struct.unpack("<" + "I" * (len(raw) // 4), raw)[0] if len(raw) >= 4 else None
    if vr in (b"SS",):
        return struct.unpack("<h", raw[:2])[0] if len(raw) >= 2 else None
    if vr in (b"SL",):
        return struct.unpack("<i", raw[:4])[0] if len(raw) >= 4 else None
    if vr in (b"FL",):
        vals = struct.unpack("<" + "f" * (len(raw) // 4), raw)
        return vals[0] if len(vals) == 1 else list(vals)
    if vr in (b"FD",):
        vals = struct.unpack("<" + "d" * (len(raw) // 8), raw)
        return vals[0] if len(vals) == 1 else list(vals)
    text = raw.decode("ascii", errors="replace").strip("\x00 ")
    if vr in (b"DS", b"IS"):
        parts = [p.strip() for p in text.split("\\") if p.strip()]
        try:
            nums = [float(p) if vr == b"DS" else int(p) for p in parts]
        except ValueError:
            return text
        return nums[0] if len(nums) == 1 else nums
    if "\\" in text:
        return [p.strip() for p in text.split("\\")]
    return text


def _parse_elements(buf: memoryview, offset: int, end: int, explicit: bool,
                    stop_at_pixeldata: bool = True) -> Tuple[Dict, int]:
    out: Dict[Tuple[int, int], Any] = {}
    pos = offset
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        if tag == (0xFFFE, 0xE00D) or tag == (0xFFFE, 0xE0DD):  # item/seq delimiter
            return out, pos + 8
        if explicit and group != 0xFFFE:
            vr = bytes(buf[pos + 4:pos + 6])
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                hdr = 8
        else:
            vr = _IMPLICIT_VRS.get(tag, b"UN")
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            hdr = 8
        body = pos + hdr
        if tag == _STOP_TAG:
            if stop_at_pixeldata:
                return out, end
            if length == 0xFFFFFFFF:
                # encapsulated PixelData (PS3.5 A.4): Basic Offset Table
                # item + one fragment item per frame; decoding is transfer-
                # syntax dependent and happens in read_dcm
                out[tag] = _Encapsulated(_parse_fragments(buf, body, end))
                return out, end
            out[tag] = bytes(buf[body:body + length])
            return out, body + length

        is_sq = vr == b"SQ" or (vr == b"UN" and length == 0xFFFFFFFF) or (
            not explicit and tag in _TAG_NAMES and _TAG_NAMES[tag].endswith("Sequence"))
        if is_sq:
            items: List[DicomDataset] = []
            sq_end = end if length == 0xFFFFFFFF else body + length
            ipos = body
            while ipos + 8 <= sq_end:
                ig, ie = struct.unpack_from("<HH", buf, ipos)
                if (ig, ie) == (0xFFFE, 0xE0DD):
                    ipos += 8
                    break
                if (ig, ie) != (0xFFFE, 0xE000):
                    break
                ilen = struct.unpack_from("<I", buf, ipos + 4)[0]
                istart = ipos + 8
                iend = sq_end if ilen == 0xFFFFFFFF else istart + ilen
                el, newpos = _parse_elements(buf, istart, iend, explicit, False)
                items.append(DicomDataset(el))
                ipos = newpos if ilen == 0xFFFFFFFF else iend
            out[tag] = items
            pos = sq_end if length != 0xFFFFFFFF else ipos
            continue

        if length == 0xFFFFFFFF:
            raise InvalidDicomError(f"undefined length on non-sequence tag {tag}")
        raw = bytes(buf[body:body + length])
        if tag in _TAG_NAMES or group in (0x0008, 0x0010, 0x0018, 0x0020, 0x0028):
            out[tag] = _decode_value(vr, raw)
        pos = body + length
    return out, pos


class _Encapsulated:
    """Marker for undecoded encapsulated PixelData fragments."""

    def __init__(self, fragments):
        self.fragments = fragments


def _parse_fragments(buf: memoryview, pos: int, end: int):
    """Items of an encapsulated PixelData sequence -> list of fragment bytes
    (the first item, the Basic Offset Table, is dropped)."""
    frags = []
    while pos + 8 <= end:
        g, e = struct.unpack_from("<HH", buf, pos)
        ln = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (g, e) == (0xFFFE, 0xE0DD):
            break
        if (g, e) != (0xFFFE, 0xE000):
            raise InvalidDicomError(f"bad encapsulated item tag {(g, e)}")
        frags.append(bytes(buf[pos:pos + ln]))
        pos += ln
    return frags[1:]  # frags[0] = Basic Offset Table (possibly empty)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits (PS3.5 G.3.1): the RLE segment byte-decompressor."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 128:                       # ctrl+1 literal bytes
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
        elif ctrl > 128:                     # repeat next byte 257-ctrl times
            out += data[i:i + 1] * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op
    if len(out) < expected:
        raise InvalidDicomError(
            f"RLE segment underrun: {len(out)} < {expected} bytes")
    return bytes(out[:expected])


def _rle_decode_frame(frag: bytes, rows: int, cols: int,
                      bytes_per_sample: int, samples: int = 1) -> np.ndarray:
    """One RLE frame (PS3.5 Annex G) -> (rows, cols[, samples]) uint array.

    Header = 16 little-endian uint32: segment count + up to 15 offsets.
    Each segment is one PackBits-compressed BYTE PLANE, most significant
    byte first within each sample (G.2.1 composite pixel code order).
    """
    if len(frag) < 64:
        raise InvalidDicomError("RLE frame shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frag, 0)
    nseg = header[0]
    if nseg != samples * bytes_per_sample:
        raise InvalidDicomError(
            f"RLE segment count {nseg} != samples {samples} x "
            f"{bytes_per_sample} bytes/sample")
    offsets = list(header[1:1 + nseg]) + [len(frag)]
    npix = rows * cols
    planes = []
    for s in range(nseg):
        seg = frag[offsets[s]:offsets[s + 1]]
        planes.append(np.frombuffer(_packbits_decode(seg, npix), np.uint8))
    out = np.zeros((samples, npix), np.uint32)
    for s in range(samples):
        for b in range(bytes_per_sample):       # planes are MSB first
            shift = 8 * (bytes_per_sample - 1 - b)
            out[s] |= planes[s * bytes_per_sample + b].astype(np.uint32) << shift
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bytes_per_sample]
    arr = out.astype(dtype).reshape(samples, rows, cols)
    return arr[0] if samples == 1 else np.moveaxis(arr, 0, -1)


_TS_RLE = "1.2.840.10008.1.2.5"
# JPEG Lossless Process 14 (.4.57) and its SV1 restriction (.4.70) — the
# compressed syntaxes scanners actually emit; decoded in-repo (the host
# library's ft2_jpegll_decode; utils/jpegll.py for streams outside its scope)
_TS_JPEGLL = ("1.2.840.10008.1.2.4.57", "1.2.840.10008.1.2.4.70")
# JPEG 2000 Lossless Only (.4.90) and JPEG 2000 (.4.91) — decoded through
# PIL/OpenJPEG (baked into the image); PS3.5 A.4.4: each frame is one raw
# JPEG 2000 codestream (SOC marker FF4F FF51), JP2 wrapping tolerated
_TS_J2K = ("1.2.840.10008.1.2.4.90", "1.2.840.10008.1.2.4.91")
_J2K_SOC = b"\xff\x4f\xff\x51"
_JP2_SIG = b"\x00\x00\x00\x0cjP"
# Lossy classic JPEG: Baseline Process 1 (.4.50) and Extended Process 2&4
# (.4.51). 8-bit streams decode through PIL/libjpeg; 12-bit Extended
# streams (outside stock libjpeg) decode through the in-repo sequential-DCT
# codec (utils/jpegdct.py) — every transfer syntax dcm2niix covers now
# decodes in-repo.
_TS_JPEG_LOSSY = ("1.2.840.10008.1.2.4.50", "1.2.840.10008.1.2.4.51")


def _jpeg_stream_precision(stream: bytes) -> int:
    """Sample precision from the first SOF0/SOF1 segment (0 if not found)."""
    pos = 2
    while pos + 4 <= len(stream):
        marker = struct.unpack_from(">H", stream, pos)[0]
        if marker in (0xFFC0, 0xFFC1):
            return stream[pos + 4]
        if marker in (0xFFD9, 0xFFDA):
            break
        if not (0xFF01 <= marker <= 0xFFFE):
            break
        pos += 2 + struct.unpack_from(">H", stream, pos + 2)[0]
    return 0


def _jpeg_lossy_decode_stream(stream: bytes, path: str) -> np.ndarray:
    """One baseline/extended JPEG stream -> numpy array.

    8-bit goes through PIL/libjpeg (fast C, handles YBR subsampling);
    12-bit Extended goes through the in-repo DCT codec, which stock
    libjpeg cannot represent (the reference needs the dcm2niix binary for
    these, utils/dcm_utils.py:259-312)."""
    import io

    if _jpeg_stream_precision(stream) > 8:
        from . import jpegdct

        try:
            return jpegdct.decode(stream)
        except jpegdct.JpegError as e:
            raise InvalidDicomError(
                f"{path}: 12-bit extended JPEG decode failed: {e}") from e
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is in the image
        raise InvalidDicomError(
            f"{path}: lossy JPEG PixelData needs PIL (not importable "
            "here); convert with dcm2niix") from e
    try:
        with Image.open(io.BytesIO(stream)) as im:
            arr = np.asarray(im)
    except Exception as e:
        raise InvalidDicomError(
            f"{path}: lossy JPEG decode failed ({e})") from e
    return arr


def _jpegll_frame_streams(fragments) -> list:
    """Group encapsulation fragments into complete JPEG streams.

    A frame may span multiple fragments (PS3.5 A.4); each new frame starts
    with an SOI marker at a fragment boundary. Byte stuffing keeps FFD8 out
    of entropy-coded data, but APPn payloads (e.g. embedded thumbnails) can
    contain it — so a fragment only starts a new frame if the accumulated
    stream already ends with the EOI marker (FFD9, optionally padded)."""
    streams, cur = [], b""
    for f in fragments:
        done = cur.rstrip(b"\x00")[-2:] == b"\xff\xd9"
        if f[:2] == b"\xff\xd8" and cur and done:
            streams.append(cur)
            cur = b""
        cur += f
    if cur:
        streams.append(cur)
    return streams


def _jpegll_decode_stream(stream: bytes, path: str) -> np.ndarray:
    from . import jpegll as _pyjpegll
    from .. import build

    try:
        arr = build.jpegll_decode(stream)
    except ValueError as e:
        raise InvalidDicomError(f"{path}: {e}") from e
    if arr is None:   # parseable but outside the library's lossless scope
        try:
            arr = _pyjpegll.decode(stream)
        except _pyjpegll.JpegError as e:
            raise InvalidDicomError(
                f"{path}: lossless JPEG decode failed: {e}") from e
    return arr


def _j2k_frame_streams(fragments) -> list:
    """Group encapsulation fragments into complete JPEG 2000 codestreams.

    A frame may span multiple fragments (PS3.5 A.4); each new frame starts
    with an SOC marker (or a JP2 signature box) at a fragment boundary.
    Unlike classic JPEG (where byte stuffing keeps FFD8 out of entropy
    data), the SOC pattern CAN occur inside J2K packet bodies — so a
    fragment only starts a new frame if the accumulated stream already ends
    with the EOC marker (FFD9, optionally padded to even length)."""
    streams, cur = [], b""
    for f in fragments:
        starts = f[:4] == _J2K_SOC or f[:6] == _JP2_SIG
        done = cur.rstrip(b"\x00")[-2:] == b"\xff\xd9"
        if starts and cur and done:
            streams.append(cur)
            cur = b""
        cur += f
    if cur:
        streams.append(cur)
    return streams


def _j2k_decode_stream(stream: bytes, path: str) -> np.ndarray:
    """One JPEG 2000 codestream (or JP2 file) -> 2-D/3-D numpy array."""
    import io

    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is in the image
        raise InvalidDicomError(
            f"{path}: JPEG 2000 PixelData needs PIL/OpenJPEG (not "
            "importable here); convert with dcm2niix") from e
    try:
        with Image.open(io.BytesIO(stream)) as im:
            arr = np.asarray(im)
    except Exception as e:
        raise InvalidDicomError(
            f"{path}: JPEG 2000 decode failed: {e}") from e
    return arr


def _decode_encapsulated(ds_elements: Dict, ts: str, path: str) -> None:
    """Replace an _Encapsulated PixelData entry with native-endian bytes."""
    enc = ds_elements.get(_STOP_TAG)
    if not isinstance(enc, _Encapsulated):
        return
    if ts not in (_TS_RLE,) + _TS_JPEGLL + _TS_J2K + _TS_JPEG_LOSSY:
        raise InvalidDicomError(
            f"{path}: encapsulated PixelData with transfer syntax {ts} "
            "unsupported (RLE Lossless, JPEG Lossless P14/SV1, JPEG 2000 "
            "and 8-bit lossy JPEG are decoded in-repo; convert other "
            "syntaxes with dcm2niix)")
    rows = int(ds_elements.get((0x0028, 0x0010)) or 0)
    cols = int(ds_elements.get((0x0028, 0x0011)) or 0)
    bits = int(ds_elements.get((0x0028, 0x0100)) or 16)
    samples = int(ds_elements.get((0x0028, 0x0002)) or 1)
    if not rows or not cols:
        raise InvalidDicomError(f"{path}: compressed PixelData without Rows/Columns")
    first_stream = None
    if ts in _TS_JPEGLL + _TS_J2K + _TS_JPEG_LOSSY:
        if ts in _TS_JPEGLL:
            streams, decode = _jpegll_frame_streams, _jpegll_decode_stream
        elif ts in _TS_J2K:
            streams, decode = _j2k_frame_streams, _j2k_decode_stream
        else:
            streams, decode = _jpegll_frame_streams, _jpeg_lossy_decode_stream
        pixrep = int(ds_elements.get((0x0028, 0x0103)) or 0)
        if bits > 16:
            want = np.int32 if pixrep else np.uint32
        elif bits > 8:
            want = np.int16 if pixrep else np.uint16
        else:
            want = np.int8 if pixrep else np.uint8
        frames = []
        for stream in streams(enc.fragments):
            if first_stream is None:
                first_stream = stream
            arr = decode(stream, path)
            fr, fc = arr.shape[:2]
            fs = arr.shape[2] if arr.ndim == 3 else 1
            if (fr, fc, fs) != (rows, cols, samples):
                raise InvalidDicomError(
                    f"{path}: JPEG frame {fr}x{fc}x{fs} != dataset "
                    f"{rows}x{cols}x{samples}")
            frames.append(arr.astype(want))
    else:
        bps = max(1, bits // 8)
        frames = [_rle_decode_frame(f, rows, cols, bps, samples)
                  for f in enc.fragments]
    stacked = frames[0] if len(frames) == 1 else np.stack(frames)
    ds_elements[_STOP_TAG] = np.ascontiguousarray(stacked).astype(
        stacked.dtype.newbyteorder("<")).tobytes()
    if (ts in _TS_JPEG_LOSSY and samples > 1
            and first_stream is not None
            and _jpeg_stream_precision(first_stream) <= 8):
        # PIL hands back RGB-converted pixels for YBR-coded 8-bit lossy
        # streams; rewrite PhotometricInterpretation so a consumer honoring
        # it does not color-convert a second time. 12-bit (.4.51) streams
        # go through the in-repo DCT codec (utils/jpegdct.py), which
        # returns the coded planes UNconverted — their tag stays truthful.
        ds_elements[(0x0028, 0x0004)] = "RGB"


def is_dcm_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(132)
        return len(head) == 132 and head[128:132] == b"DICM"
    except OSError:
        return False


def read_dcm(path: str, with_pixels: bool = False) -> DicomDataset:
    """Parse a Part-10 DICOM file's data elements.

    with_pixels=True also captures the raw (uncompressed) PixelData bytes
    under the 'PixelData' key — the DICOM->NIfTI converter's input."""
    try:
        import pydicom  # type: ignore

        return pydicom.dcmread(path, stop_before_pixels=not with_pixels)
    except ImportError:
        pass

    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 132 or data[128:132] != b"DICM":
        raise InvalidDicomError(f"{path}: missing DICM magic")
    buf = memoryview(data)

    # file meta group (always explicit VR LE); read group length to bound it
    glen = struct.unpack_from("<I", buf, 132 + 8)[0]
    meta_end = 132 + 12 + glen
    ts = None
    # transfer syntax UID tag (0002,0010)
    pos = 132
    while pos + 8 <= meta_end:
        g, e = struct.unpack_from("<HH", buf, pos)
        vr = bytes(buf[pos + 4:pos + 6])
        if vr in _EXPLICIT_LONG_VRS:
            ln = struct.unpack_from("<I", buf, pos + 8)[0]
            hdr = 12
        else:
            ln = struct.unpack_from("<H", buf, pos + 6)[0]
            hdr = 8
        if (g, e) == (0x0002, 0x0010):
            ts = bytes(buf[pos + hdr:pos + hdr + ln]).decode("ascii").strip("\x00 ")
        pos += hdr + ln

    explicit = ts != "1.2.840.10008.1.2"
    if ts is not None and ts.startswith("1.2.840.10008.1.2.2"):
        raise InvalidDicomError(f"{path}: big-endian transfer syntax unsupported")
    if ts == "1.2.840.10008.1.2.1.99":
        # deflated explicit VR LE: everything after the meta group is one
        # raw DEFLATE stream (PS3.5 A.5)
        import zlib

        try:
            inflated = zlib.decompress(bytes(buf[meta_end:]), wbits=-15)
        except zlib.error as e:
            raise InvalidDicomError(f"{path}: bad deflated stream: {e}") from e
        buf = memoryview(inflated)
        meta_end = 0
        data = inflated
    elements, _ = _parse_elements(buf, meta_end, len(data), explicit,
                                  not with_pixels)
    if with_pixels and ts is not None:
        _decode_encapsulated(elements, ts, path)
    return DicomDataset(elements)
