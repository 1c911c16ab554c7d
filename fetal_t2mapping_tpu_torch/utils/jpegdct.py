"""Sequential DCT JPEG codec (ITU-T T.81 processes 1, 2/4) — pure Python.

DICOM's lossy classic-JPEG transfer syntaxes:

* 1.2.840.10008.1.2.4.50 — Baseline (Process 1), 8-bit
* 1.2.840.10008.1.2.4.51 — Extended (Process 2 & 4), 8-bit AND 12-bit

8-bit streams decode through PIL/libjpeg (utils/dicom.py). 12-bit Extended
streams are outside stock libjpeg — the reference delegates them to the
dcm2niix binary (reference utils/dcm_utils.py:259-312); this module
decodes them in-repo. A copy of ``fetal_t2mapping_tpu.utils.jpegdct``. It
shares the Huffman machinery (bit reader, decode tables,
value extension) with the lossless codec in ``utils/jpegll.py``.

Scope: Huffman sequential DCT scans (SOF0/SOF1), 2-12 bit precision,
1-4 components with Hi=Vi=1 (no chroma subsampling — DICOM MR is
grayscale; YBR 4:2:2 still goes through PIL), single interleaved scan,
restart markers, 8- and 16-bit quantization tables. Progressive (SOF2)
and arithmetic coding raise ``JpegError``.

Also provides an ``encode()`` used by the test fixtures: no tool in this
image can produce 12-bit JPEG streams, so fixtures must be synthesized
(same situation as the lossless codec).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .jpegll import (
    JpegError,
    _BitReader,
    _BitWriter,
    _build_decode_table,
    _decode_huff,
    _extend,
    _ssss,
)

SOI, EOI = 0xFFD8, 0xFFD9
SOF0, SOF1, DHT, DQT, SOS, DRI = 0xFFC0, 0xFFC1, 0xFFC4, 0xFFDB, 0xFFDA, 0xFFDD
_SOF_OTHER = {0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7,
              0xFFC9, 0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF}

# T.81 Figure A.6 zigzag order: _ZIGZAG[k] = flat (row*8+col) index of the
# k-th coefficient in transmission order.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)


def _idct_blocks(blocks: np.ndarray) -> np.ndarray:
    """Batched 2-D type-III DCT with orthonormal scaling == the T.81 IDCT."""
    from scipy.fft import idctn

    return idctn(blocks.reshape(-1, 8, 8), axes=(1, 2), norm="ortho")


def _dct_blocks(blocks: np.ndarray) -> np.ndarray:
    from scipy.fft import dctn

    return dctn(blocks.reshape(-1, 8, 8), axes=(1, 2), norm="ortho")


def decode(data: bytes) -> np.ndarray:
    """Decode one sequential-DCT JPEG stream -> (rows, cols[, comps]).

    dtype is uint8 for precision <= 8, uint16 above.
    """
    if len(data) < 4 or struct.unpack_from(">H", data, 0)[0] != SOI:
        raise JpegError("missing SOI")
    pos = 2
    precision = rows = cols = 0
    comps: List[Tuple[int, int, int]] = []   # (id, HV, Tq)
    htabs: Dict[Tuple[int, int], tuple] = {}
    qtabs: Dict[int, np.ndarray] = {}
    restart = 0
    scan = None
    scan_start = 0
    while pos + 4 <= len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == EOI:
            break
        if not (0xFFC0 <= marker <= 0xFFFE):
            raise JpegError(f"bad marker 0x{marker:04x}")
        if marker in _SOF_OTHER:
            raise JpegError(
                f"not a sequential-DCT (SOF0/SOF1) frame: 0x{marker:04x}")
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + ln]
        pos += 2 + ln
        if marker in (SOF0, SOF1):
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
                htabs[(tc_th >> 4, tc_th & 0x0F)] = _build_decode_table(bits, vals)
                o += 17 + nv
        elif marker == DQT:
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 0x0F
                if pq:
                    q = np.frombuffer(body, ">u2", 64, o + 1).astype(np.int64)
                    o += 1 + 128
                else:
                    q = np.frombuffer(body, np.uint8, 64, o + 1).astype(np.int64)
                    o += 1 + 64
                qtabs[tq] = q                      # zigzag order
        elif marker == DRI:
            restart = struct.unpack_from(">H", body, 0)[0]
        elif marker == SOS:
            ns = body[0]
            scan = [(body[1 + 2 * i], body[2 + 2 * i] >> 4,
                     body[2 + 2 * i] & 0x0F) for i in range(ns)]
            scan_start = pos
            break
    if scan is None or not comps:
        raise JpegError("no SOS/SOF found")
    if rows == 0 or cols == 0:
        raise JpegError("zero image dimensions")
    if precision > 12:
        raise JpegError(f"precision {precision} outside sequential-DCT scope")
    nf = len(comps)
    if nf * rows * cols > (1 << 26):   # untrusted header dims: cap the alloc
        raise JpegError(f"implausible frame header {rows}x{cols}x{nf}")
    if len(scan) != nf:
        raise JpegError("non-interleaved multi-scan DCT unsupported")
    for _cid, hv, _tq in comps:
        if hv != 0x11:
            raise JpegError("chroma-subsampled scans unsupported "
                            "(grayscale/444 only; use PIL for YBR 4:2:2)")
    dc_tabs, ac_tabs, qs = [], [], []
    for (cid, hv, tq), (_cs, td, ta) in zip(comps, scan):
        if (0, td) not in htabs or (1, ta) not in htabs:
            raise JpegError(f"missing Huffman table DC{td}/AC{ta}")
        if tq not in qtabs:
            raise JpegError(f"missing quantization table {tq}")
        dc_tabs.append(htabs[(0, td)])
        ac_tabs.append(htabs[(1, ta)])
        qs.append(qtabs[tq])

    bx = -(-cols // 8)
    by = -(-rows // 8)
    coefs = [np.zeros((by * bx, 64), np.int64) for _ in range(nf)]
    r = _BitReader(data, scan_start)
    pred = [0] * nf
    till = restart if restart else -1
    for b in range(by * bx):
        if till == 0:
            m = r.align_and_take_marker()
            if not (0xFFD0 <= m <= 0xFFD7):
                raise JpegError(f"expected RST marker, got 0x{m:04x}")
            pred = [0] * nf
            till = restart
        for c in range(nf):
            blk = coefs[c][b]
            t = _decode_huff(r, dc_tabs[c])
            if t > 15:
                raise JpegError("invalid DC category")
            pred[c] += _extend(r.read(t) if t else 0, t)
            blk[0] = pred[c]
            k = 1
            while k < 64:
                rs = _decode_huff(r, ac_tabs[c])
                rr, ss = rs >> 4, rs & 0x0F
                if ss == 0:
                    if rr == 15:            # ZRL: 16 zeros
                        k += 16
                        continue
                    break                   # EOB
                k += rr
                if k > 63:
                    raise JpegError("AC run past block end")
                blk[k] = _extend(r.read(ss), ss)
                k += 1
        if till > 0:
            till -= 1

    shift = 1 << (precision - 1)
    top = (1 << precision) - 1
    planes = []
    for c in range(nf):
        deq = np.zeros((by * bx, 64), np.float64)
        deq[:, _ZIGZAG] = coefs[c] * qs[c]          # dequant + un-zigzag
        pix = _idct_blocks(deq) + shift
        pix = np.clip(np.round(pix), 0, top)
        # (by*bx, 8, 8) -> (by*8, bx*8) -> crop
        img = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        planes.append(img[:rows, :cols])
    arr = np.stack(planes, axis=-1) if nf > 1 else planes[0]
    return np.ascontiguousarray(
        arr.astype(np.uint8 if precision <= 8 else np.uint16))


# ---------------------------------------------------------------- encode

def _canonical_table(freq: np.ndarray) -> Tuple[List[int], List[int], Dict[int, Tuple[int, int]]]:
    """Equal-length canonical code over the USED symbols: correctness-first
    (fixtures only — compression ratio is irrelevant there). All used
    symbols get length L with 2^L > n_used, so the all-ones code of any
    length is never assigned (T.81 C.2)."""
    used = [int(s) for s in np.flatnonzero(freq)]
    if not used:
        used = [0]
    L = max(2, int(np.ceil(np.log2(len(used) + 1))))
    bits = [0] * 16
    bits[L - 1] = len(used)
    codes = {}
    code = 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            codes[used[len(codes)]] = (code, ln)
            code += 1
        code <<= 1
    return bits, used, codes


def encode(img: np.ndarray, *, precision: int | None = None,
           quant: "np.ndarray | int" = 1,
           restart_interval: int = 0) -> bytes:
    """Encode a 2-D unsigned image as a single-component extended
    sequential DCT JPEG (SOF1 — the DICOM .4.51 syntax; 12-bit capable).

    ``quant``: scalar or 64-entry zigzag-order quantization table.
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise JpegError("encoder handles single-component 2-D images")
    rows, cols = img.shape
    if precision is None:
        precision = max(2, int(img.max()).bit_length()) if img.size else 8
    if precision > 12:
        raise JpegError("sequential DCT precision must be 2..12")
    q = (np.full(64, int(quant), np.int64) if np.isscalar(quant)
         else np.asarray(quant, np.int64))
    if q.shape != (64,) or (q < 1).any() or (q > 65535).any():
        raise JpegError("quant must be scalar or 64 zigzag entries in 1..65535")

    shift = 1 << (precision - 1)
    by, bx = -(-rows // 8), -(-cols // 8)
    padded = np.empty((by * 8, bx * 8), np.float64)
    padded[:rows, :cols] = img.astype(np.float64)
    padded[rows:, :cols] = padded[rows - 1:rows, :cols]   # edge replicate
    padded[:, cols:] = padded[:, cols - 1:cols]
    blocks = (padded.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
              .reshape(-1, 8, 8) - shift)
    coef = _dct_blocks(blocks).reshape(-1, 64)
    zz = np.round(coef[:, _ZIGZAG] / q).astype(np.int64)

    # pass 1: symbol statistics
    dc_freq = np.zeros(17, np.int64)
    ac_freq = np.zeros(256, np.int64)
    till = restart_interval if restart_interval else -1
    prev = 0
    for b in range(zz.shape[0]):
        if till == 0:
            prev = 0
            till = restart_interval
        diff = int(zz[b, 0]) - prev
        prev = int(zz[b, 0])
        dc_freq[_ssss(diff)] += 1
        run = 0
        for k in range(1, 64):
            v = int(zz[b, k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                ac_freq[0xF0] += 1
                run -= 16
            ac_freq[(run << 4) | _ssss(v)] += 1
            run = 0
        if run:
            ac_freq[0x00] += 1                    # EOB
        if till > 0:
            till -= 1
    dc_bits, dc_vals, dc_codes = _canonical_table(dc_freq)
    ac_bits, ac_vals, ac_codes = _canonical_table(ac_freq)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    pq = 1 if (q > 255).any() else 0
    qbody = bytes([pq << 4]) + (q.astype(">u2").tobytes() if pq
                                else q.astype(np.uint8).tobytes())
    header = struct.pack(">H", SOI)
    header += seg(DQT, qbody)
    header += seg(SOF1, struct.pack(">BHHB", precision, rows, cols, 1)
                  + bytes([1, 0x11, 0]))
    header += seg(DHT, bytes([0x00]) + bytes(dc_bits) + bytes(dc_vals))
    header += seg(DHT, bytes([0x10]) + bytes(ac_bits) + bytes(ac_vals))
    if restart_interval:
        header += seg(DRI, struct.pack(">H", restart_interval))
    header += seg(SOS, bytes([1, 1, 0x00, 0, 63, 0]))

    w = _BitWriter()
    body = bytearray()
    till = restart_interval if restart_interval else -1
    prev = 0
    rst = 0
    for b in range(zz.shape[0]):
        if till == 0:
            w.flush()
            body += w.out
            body += struct.pack(">H", 0xFFD0 | (rst & 7))
            rst += 1
            w = _BitWriter()
            prev = 0
            till = restart_interval
        diff = int(zz[b, 0]) - prev
        prev = int(zz[b, 0])
        t = _ssss(diff)
        c, ln = dc_codes[t]
        w.write(c, ln)
        if t:
            w.write(diff if diff >= 0 else diff - 1, t)
        run = 0
        for k in range(1, 64):
            v = int(zz[b, k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c, ln = ac_codes[0xF0]
                w.write(c, ln)
                run -= 16
            s = _ssss(v)
            c, ln = ac_codes[(run << 4) | s]
            w.write(c, ln)
            w.write(v if v >= 0 else v - 1, s)
            run = 0
        if run:
            c, ln = ac_codes[0x00]
            w.write(c, ln)
        if till > 0:
            till -= 1
    w.flush()
    body += w.out
    return header + bytes(body) + struct.pack(">H", EOI)
