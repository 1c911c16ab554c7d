"""JPEG Lossless (ITU-T T.81 process 14) codec — pure-Python reference.

DICOM's lossless-JPEG transfer syntaxes wrap ordinary T.81 lossless scans:

* 1.2.840.10008.1.2.4.57 — JPEG Lossless, Non-Hierarchical (Process 14)
* 1.2.840.10008.1.2.4.70 — Process 14, first-order prediction (SV1), the
  most common compressed syntax scanners emit.

The reference pipeline delegates these to the dcm2niix C++ binary
(reference utils/dcm_utils.py:259-312). Here they are decoded in-repo:
the host library built from ``csrc/dicom_host.cpp`` (ft2_jpegll_decode,
bound in ``build.py``) decodes every stream within its scope; this module
decodes the rest, so that an unsupported stream raises its specific
``JpegError``, and is the fixture *encoder* (dcm2niix has no encoder
either — fixtures must be synthesized). A copy of
``fetal_t2mapping_tpu.utils.jpegll``: equal bytes out of ``encode``,
equal arrays out of ``decode``.

Scope: SOF3 frames, 2-16 bit precision, 1-4 components with Hi=Vi=1
(interleaved single scan), predictors 0-7, point transform, restart
markers. That covers every lossless-JPEG DICOM we have seen; anything
else raises ``JpegError``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SOI, EOI = 0xFFD8, 0xFFD9
SOF3, DHT, SOS, DRI = 0xFFC3, 0xFFC4, 0xFFDA, 0xFFDD
_SOF_UNSUPPORTED = {0xFFC0, 0xFFC1, 0xFFC2, 0xFFC5, 0xFFC6, 0xFFC7,
                    0xFFC9, 0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF}


class JpegError(ValueError):
    pass


# --------------------------------------------------------------- Huffman

def _build_decode_table(bits: List[int], values: List[int]):
    """T.81 F.2.2.3 decode tables: (mincode, maxcode, valptr) per length."""
    code, k = 0, 0
    mincode, maxcode, valptr = [0] * 17, [-1] * 17, [0] * 17
    for ln in range(1, 17):
        if bits[ln - 1]:
            valptr[ln] = k
            mincode[ln] = code
            code += bits[ln - 1]
            k += bits[ln - 1]
            maxcode[ln] = code - 1
        code <<= 1
    return mincode, maxcode, valptr, values


class _BitReader:
    """Entropy-coded-segment bit reader with 0xFF00 unstuffing."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos          # next byte index
        self.acc = 0
        self.nbits = 0
        self.marker = None      # marker encountered mid-stream (RST/EOI)

    def _fill(self):
        d = self.data
        if self.pos >= len(d):
            raise JpegError("truncated entropy-coded segment")
        b = d[self.pos]
        self.pos += 1
        if b == 0xFF:
            nxt = d[self.pos] if self.pos < len(d) else 0xD9
            if nxt == 0x00:
                self.pos += 1
            else:                      # a real marker terminates the bits
                self.marker = 0xFF00 | nxt
                self.pos += 1
                b = 0                  # pad (only padding bits follow)
        self.acc = (self.acc << 8) | b
        self.nbits += 8

    def read(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        return v

    def read_bit(self) -> int:
        return self.read(1)

    def align_and_take_marker(self) -> int:
        """Drop padding bits, consume the 2-byte marker at the boundary."""
        self.nbits = 0
        self.acc = 0
        if self.marker is not None:
            m, self.marker = self.marker, None
            return m
        d = self.data
        p = self.pos
        while p + 1 < len(d) and d[p] == 0xFF and d[p + 1] == 0xFF:
            p += 1                      # fill bytes before a marker
        if p + 1 >= len(d) or d[p] != 0xFF:
            raise JpegError("expected marker at restart boundary")
        self.pos = p + 2
        return 0xFF00 | d[p + 1]


def _decode_huff(r: _BitReader, tbl) -> int:
    mincode, maxcode, valptr, values = tbl
    code = r.read_bit()
    ln = 1
    while code > maxcode[ln]:
        ln += 1
        if ln > 16:
            raise JpegError("invalid Huffman code")
        code = (code << 1) | r.read_bit()
    return values[valptr[ln] + code - mincode[ln]]


def _extend(v: int, t: int) -> int:
    if t == 0:
        return 0
    if t == 16:
        return 32768
    if v < (1 << (t - 1)):
        v += (-1 << t) + 1
    return v


# ---------------------------------------------------------------- decode

def _predict(ra: int, rb: int, rc: int, sel: int) -> int:
    if sel == 1:
        return ra
    if sel == 2:
        return rb
    if sel == 3:
        return rc
    if sel == 4:
        return ra + rb - rc
    if sel == 5:
        return ra + ((rb - rc) >> 1)
    if sel == 6:
        return rb + ((ra - rc) >> 1)
    if sel == 7:
        return (ra + rb) >> 1
    return 0  # sel 0: no prediction (valid only in hierarchical mode)


def decode(data: bytes) -> np.ndarray:
    """Decode one lossless-JPEG stream -> (rows, cols[, comps]) uint16/uint8."""
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != SOI:
        raise JpegError("missing SOI")
    pos = 2
    precision = rows = cols = 0
    comps: List[Tuple[int, int, int]] = []   # (id, HV, Tq)
    htabs: Dict[int, tuple] = {}
    restart = 0
    scan = None
    while pos + 4 <= len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == EOI:
            break
        if not (0xFFC0 <= marker <= 0xFFFE):
            raise JpegError(f"bad marker 0x{marker:04x}")
        if marker in _SOF_UNSUPPORTED:
            raise JpegError(f"not a lossless (SOF3) frame: 0x{marker:04x}")
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + ln]
        pos += 2 + ln
        if marker == SOF3:
            precision, rows, cols, nf = struct.unpack_from(">BHHB", body, 0)
            comps = [(body[6 + 3 * i], body[7 + 3 * i], body[8 + 3 * i])
                     for i in range(nf)]
        elif marker == DHT:
            o = 0
            while o < len(body):
                tc_th = body[o]
                bits = list(body[o + 1:o + 17])
                nv = sum(bits)
                vals = list(body[o + 17:o + 17 + nv])
                htabs[tc_th & 0x0F] = _build_decode_table(bits, vals)
                o += 17 + nv
        elif marker == DRI:
            restart = struct.unpack_from(">H", body, 0)[0]
        elif marker == SOS:
            ns = body[0]
            sel_tabs = [(body[1 + 2 * i], body[2 + 2 * i] >> 4)
                        for i in range(ns)]
            ss, _se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            pt = ahal & 0x0F
            scan = (sel_tabs, ss, pt)
            scan_start = pos
            break
    if scan is None or not comps:
        raise JpegError("no SOS/SOF3 found")
    if rows == 0 or cols == 0:
        raise JpegError("zero image dimensions")
    for _cid, hv, _tq in comps:
        if hv != 0x11:
            raise JpegError("subsampled lossless scans unsupported")
    sel_tabs, predictor, pt = scan
    nf = len(comps)
    if len(sel_tabs) != nf:
        raise JpegError("non-interleaved multi-scan lossless unsupported")
    tabs = []
    for _cs, td in sel_tabs:
        if td not in htabs:
            raise JpegError(f"missing Huffman table {td}")
        tabs.append(htabs[td])

    # SOF dims are untrusted input: cap the allocation (65535^2 x 4 comps
    # would be ~68 GB of int32). 2^26 pixels dwarfs any real DICOM frame.
    if nf * rows * cols > (1 << 26):
        raise JpegError(f"implausible frame header {rows}x{cols}x{nf}")
    out = np.zeros((nf, rows, cols), np.int32)
    r = _BitReader(data, scan_start)
    default = 1 << (precision - pt - 1)
    till_restart = restart if restart else -1
    # T.81 H.1.2.1: the FIRST sample at scan start (and after each restart)
    # predicts from 2^(P-Pt-1); the rest of that first LINE uses Ra.
    fresh, first_line = True, True
    for y in range(rows):
        for x in range(cols):
            if x == 0 and not fresh:
                first_line = False
            if till_restart == 0:
                m = r.align_and_take_marker()
                if not (0xFFD0 <= m <= 0xFFD7):
                    raise JpegError(f"expected RST marker, got 0x{m:04x}")
                till_restart = restart
                fresh, first_line = True, True
            for c in range(nf):
                t = _decode_huff(r, tabs[c])
                diff = _extend(r.read(t) if 0 < t < 16 else 0, t)
                plane = out[c]
                if fresh:
                    px = default
                elif first_line:
                    px = plane[y, x - 1]
                elif x == 0:
                    px = plane[y - 1, 0]
                else:
                    px = _predict(int(plane[y, x - 1]), int(plane[y - 1, x]),
                                  int(plane[y - 1, x - 1]), predictor)
                plane[y, x] = (px + diff) & 0xFFFF
            fresh = False
            if till_restart > 0:
                till_restart -= 1
    arr = (out.astype(np.uint16) << pt) & 0xFFFF
    if precision <= 8:
        arr = arr.astype(np.uint8)
    arr = arr[0] if nf == 1 else np.moveaxis(arr, 0, -1)
    return np.ascontiguousarray(arr)


# ---------------------------------------------------------------- encode

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, n: int):
        self.acc = (self.acc << n) | (code & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)       # byte stuffing

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)  # 1-bits padding per T.81


# Fixed code-length template: 17 slots (SSSS 0..16), Kraft-valid, <=14 bits.
_ENC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]


def _ssss(v: int) -> int:
    return 0 if v == 0 else (16 if v == 32768 else int(v).bit_length()
                             if v > 0 else int(-v).bit_length())


def encode(img: np.ndarray, predictor: int = 1, point_transform: int = 0,
           precision: int | None = None, restart_interval: int = 0) -> bytes:
    """Encode a 2-D unsigned image as a single-component lossless JPEG.

    ``predictor`` is the SOS selection value Ss (1-7); SV1 (predictor=1)
    gives the DICOM .4.70 syntax, any value the .4.57 one.
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise JpegError("encoder handles single-component 2-D images")
    if not 1 <= predictor <= 7:
        raise JpegError("predictor selection must be 1..7")
    rows, cols = img.shape
    if precision is None:
        precision = max(2, int(img.max()).bit_length()) if img.size else 8
    if precision < 2 or precision > 16:
        raise JpegError("precision must be 2..16")
    pt = point_transform
    samples = (img.astype(np.int64) >> pt) & 0xFFFF
    default = 1 << (precision - pt - 1)

    # pass 1: diffs (mod 2^16 -> [-32768, 32767], -32768 coded as SSSS 16)
    diffs = np.zeros((rows, cols), np.int64)
    till = restart_interval if restart_interval else -1
    fresh, first_line = True, True
    for y in range(rows):
        for x in range(cols):
            if x == 0 and not fresh:
                first_line = False
            if till == 0:
                till = restart_interval
                fresh, first_line = True, True
            if fresh:
                px = default
            elif first_line:
                px = samples[y, x - 1]
            elif x == 0:
                px = samples[y - 1, 0]
            else:
                px = _predict(int(samples[y, x - 1]), int(samples[y - 1, x]),
                              int(samples[y - 1, x - 1]), predictor)
            diffs[y, x] = ((int(samples[y, x]) - int(px) + 32768) & 0xFFFF) - 32768
            fresh = False
            if till > 0:
                till -= 1
    v = diffs.ravel()
    cats = np.array([_ssss(32768 if int(x) == -32768 else int(x)) for x in v])

    # canonical Huffman table: all 17 symbols, ordered by frequency
    freq = np.bincount(cats, minlength=17)
    order = sorted(range(17), key=lambda s: (-freq[s], s))
    huffval = order
    codes: Dict[int, Tuple[int, int]] = {}
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(_ENC_BITS[ln - 1]):
            codes[huffval[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    header = struct.pack(">H", SOI)
    header += seg(SOF3, struct.pack(">BHHB", precision, rows, cols, 1)
                  + bytes([1, 0x11, 0]))
    header += seg(DHT, bytes([0x00]) + bytes(_ENC_BITS) + bytes(huffval))
    if restart_interval:
        header += seg(DRI, struct.pack(">H", restart_interval))
    header += seg(SOS, bytes([1, 1, 0x00, predictor, 0, pt]))

    w = _BitWriter()
    till = restart_interval if restart_interval else -1
    rst = 0
    body = bytearray()
    for i, d in enumerate(v):
        if till == 0:
            w.flush()
            body += w.out
            body += struct.pack(">H", 0xFFD0 | (rst & 7))
            rst += 1
            w = _BitWriter()
            till = restart_interval
        d = int(d)
        t = _ssss(32768 if d == -32768 else d)
        c, ln = codes[t]
        w.write(c, ln)
        if 0 < t < 16:
            w.write(d if d >= 0 else d - 1, t)
        if till > 0:
            till -= 1
    w.flush()
    body += w.out
    return header + bytes(body) + struct.pack(">H", EOI)
