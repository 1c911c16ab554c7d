// Host library of the port's DICOM ingest: the Part-10 magic probe and the
// JPEG-lossless (T.81 process 14) decoder, for utils/ingest.py and
// utils/dicom.py.
//
// A copy of the ingest entries of the JAX package's native/ft2io.cpp
// (ft2_dicom_probe_batch, ft2_jpegll_info, ft2_jpegll_decode, ft2_free,
// ft2_version); its gzip file reads and writes are in gzio_host.cpp, a
// library of its own that needs zlib. Host C++, not a GPU kernel: build.py
// builds it with g++ (-O3 -fPIC -shared -std=c++17 -pthread) into _build/
// at first use and binds it with ctypes.
//
// Plain C ABI. Every function returns 0 on success or a negative code.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static const char kVersion[] = "dicom_host 1.0";

const char* ft2_version() { return kVersion; }

void ft2_free(uint8_t* p) { free(p); }

// Part-10 files carry "DICM" at offset 128. The reference validates DICOM
// candidates by fully parsing each file (utils/dcm_utils.py:54-65) — a
// directory walk over thousands of files reads gigabytes; this probe reads
// 132 bytes. is_dcm[i]: 1 = Part-10 DICOM, 0 = not, -1 = unreadable.
static void probe_one(const char* path, int32_t* flag) {
  FILE* f = fopen(path, "rb");
  if (!f) { *flag = -1; return; }
  uint8_t hdr[132];
  size_t n = fread(hdr, 1, sizeof hdr, f);
  fclose(f);
  *flag = (n == sizeof hdr && memcmp(hdr + 128, "DICM", 4) == 0) ? 1 : 0;
}

int ft2_dicom_probe_batch(const char** paths, int32_t n, int32_t* is_dcm,
                          int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      probe_one(paths[i], &is_dcm[i]);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(n_threads));
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

// ------------------------------------------------- JPEG Lossless (T.81 P14)
// Decoder for DICOM's lossless-JPEG transfer syntaxes (1.2.840.10008.1.2.4.57
// and .4.70/SV1), which the reference hands to the dcm2niix binary
// (reference utils/dcm_utils.py:259-312). Scope mirrors utils/jpegll.py:
// SOF3, 2-16 bit, 1-4 components with Hi=Vi=1, predictors 0-7, point
// transform, restart markers. Its output is bitwise that of
// utils/jpegll.decode (tests/test_torch_jpeg.py).
//
// Error codes: -10 malformed stream, -11 unsupported feature (the caller
//              hands such a stream to utils/jpegll.decode, which names the
//              feature), -12 caller buffer size mismatch.

namespace jpegll {

struct Huff {
  int32_t mincode[17], maxcode[17], valptr[17];
  uint8_t vals[256];
  bool present = false;
};

struct BitReader {
  const uint8_t* d;
  uint64_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int32_t marker = -1;  // marker met mid-stream (RST/EOI)
  bool bad = false;

  void fill() {
    if (pos >= n) { bad = true; acc <<= 8; nbits += 8; return; }
    uint8_t b = d[pos++];
    if (b == 0xFF) {
      uint8_t nxt = pos < n ? d[pos] : 0xD9;
      if (nxt == 0x00) {
        ++pos;
      } else {  // real marker terminates the entropy bits
        marker = 0xFF00 | nxt;
        ++pos;
        b = 0;
      }
    }
    acc = (acc << 8) | b;
    nbits += 8;
  }
  uint32_t read(int k) {
    while (nbits < k) fill();
    nbits -= k;
    return static_cast<uint32_t>(acc >> nbits) & ((1u << k) - 1u);
  }
  int32_t align_take_marker() {
    nbits = 0;
    acc = 0;
    if (marker >= 0) { int32_t m = marker; marker = -1; return m; }
    uint64_t p = pos;
    while (p + 1 < n && d[p] == 0xFF && d[p + 1] == 0xFF) ++p;  // fill bytes
    if (p + 1 >= n || d[p] != 0xFF) return -1;
    pos = p + 2;
    return 0xFF00 | d[p + 1];
  }
};

static int decode_huff(BitReader& r, const Huff& h) {
  int32_t code = static_cast<int32_t>(r.read(1));
  int ln = 1;
  while (code > h.maxcode[ln]) {
    if (++ln > 16) return -1;
    code = (code << 1) | static_cast<int32_t>(r.read(1));
  }
  return h.vals[h.valptr[ln] + code - h.mincode[ln]];
}

static inline int32_t extend(uint32_t v, int t) {
  if (t == 0) return 0;
  if (t == 16) return 32768;
  if (v < (1u << (t - 1))) return static_cast<int32_t>(v) + ((-1) << t) + 1;
  return static_cast<int32_t>(v);
}

static inline int32_t predict(int32_t ra, int32_t rb, int32_t rc, int sel) {
  switch (sel) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    case 7: return (ra + rb) >> 1;
    default: return 0;
  }
}

struct Header {
  int precision = 0, rows = 0, cols = 0, nf = 0;
  int comp_td[4] = {0, 0, 0, 0};
  int predictor = 0, pt = 0, restart = 0;
  Huff tabs[16];
  uint64_t scan_start = 0;
};

static inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

static int parse_header(const uint8_t* d, uint64_t n, Header* h) {
  if (n < 4 || be16(d) != 0xFFD8) return -10;
  uint64_t pos = 2;
  bool got_sof = false, got_sos = false;
  int comp_hv[4];
  while (pos + 4 <= n) {
    uint16_t marker = be16(d + pos);
    if (marker == 0xFFD9) break;
    if (marker < 0xFFC0 || marker > 0xFFFE) return -10;
    if (marker == 0xFFC0 || marker == 0xFFC1 || marker == 0xFFC2 ||
        marker == 0xFFC5 || marker == 0xFFC6 || marker == 0xFFC7 ||
        marker == 0xFFC9 || marker == 0xFFCA || marker == 0xFFCB ||
        marker == 0xFFCD || marker == 0xFFCE || marker == 0xFFCF)
      return -11;  // not a lossless (SOF3) frame
    uint16_t ln = be16(d + pos + 2);
    if (ln < 2 || pos + 2 + ln > n) return -10;
    const uint8_t* body = d + pos + 4;
    uint16_t blen = ln - 2;
    pos += 2 + static_cast<uint64_t>(ln);
    if (marker == 0xFFC3) {
      if (blen < 6) return -10;
      h->precision = body[0];
      h->rows = be16(body + 1);
      h->cols = be16(body + 3);
      h->nf = body[5];
      if (h->nf < 1 || h->nf > 4 || blen < 6 + 3 * h->nf) return -11;
      for (int i = 0; i < h->nf; ++i) comp_hv[i] = body[7 + 3 * i];
      got_sof = true;
    } else if (marker == 0xFFC4) {
      uint32_t o = 0;
      while (o + 17 <= blen) {
        int id = body[o] & 0x0F;
        const uint8_t* bits = body + o + 1;
        int nv = 0;
        for (int i = 0; i < 16; ++i) nv += bits[i];
        if (nv > 256 || o + 17 + nv > blen) return -10;
        Huff& t = h->tabs[id];
        memcpy(t.vals, body + o + 17, static_cast<size_t>(nv));
        int32_t code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
          t.valptr[l] = k;
          t.mincode[l] = code;
          if (bits[l - 1]) {
            code += bits[l - 1];
            k += bits[l - 1];
            t.maxcode[l] = code - 1;
          } else {
            t.maxcode[l] = -1;
          }
          code <<= 1;
        }
        t.present = true;
        o += 17 + static_cast<uint32_t>(nv);
      }
    } else if (marker == 0xFFDD) {
      if (blen < 2) return -10;
      h->restart = be16(body);
    } else if (marker == 0xFFDA) {
      if (blen < 1) return -10;
      int ns = body[0];
      if (!got_sof || ns != h->nf) return -11;  // non-interleaved: unsupported
      if (blen < static_cast<uint16_t>(4 + 2 * ns)) return -10;
      for (int i = 0; i < ns; ++i) h->comp_td[i] = body[2 + 2 * i] >> 4;
      h->predictor = body[1 + 2 * ns];
      h->pt = body[3 + 2 * ns] & 0x0F;
      h->scan_start = pos;
      got_sos = true;
      break;
    }
  }
  if (!got_sof || !got_sos) return -10;
  if (h->rows == 0 || h->cols == 0) return -10;
  if (h->precision < 2 || h->precision > 16) return -11;
  for (int i = 0; i < h->nf; ++i) {
    if (comp_hv[i] != 0x11) return -11;  // subsampled lossless: unsupported
    if (!h->tabs[h->comp_td[i]].present) return -10;
  }
  return 0;
}

}  // namespace jpegll

// Fills dims so the caller can size the output buffer (comps-interleaved
// uint16 row-major, rows*cols*comps elements).
int ft2_jpegll_info(const uint8_t* data, uint64_t len, int32_t* rows,
                    int32_t* cols, int32_t* comps, int32_t* precision) {
  jpegll::Header h;
  int rc = jpegll::parse_header(data, len, &h);
  if (rc != 0) return rc;
  *rows = h.rows;
  *cols = h.cols;
  *comps = h.nf;
  *precision = h.precision;
  return 0;
}

int ft2_jpegll_decode(const uint8_t* data, uint64_t len, uint16_t* out,
                      uint64_t out_elems) {
  jpegll::Header h;
  int rc = jpegll::parse_header(data, len, &h);
  if (rc != 0) return rc;
  const int rows = h.rows, cols = h.cols, nf = h.nf;
  const uint64_t need = static_cast<uint64_t>(rows) * cols * nf;
  if (out_elems != need) return -12;

  jpegll::BitReader r{data, len, h.scan_start};
  const int32_t dflt = 1 << (h.precision - h.pt - 1);
  int64_t till = h.restart ? h.restart : -1;
  bool fresh = true, first_line = true;
  int rst_next = 0;
  // out layout: interleaved (y, x, c); strides for neighbour reads
  const int64_t xs = nf, ys = static_cast<int64_t>(cols) * nf;
  for (int y = 0; y < rows; ++y) {
    for (int x = 0; x < cols; ++x) {
      if (x == 0 && !fresh) first_line = false;
      if (till == 0) {
        int32_t m = r.align_take_marker();
        if (m < 0xFFD0 || m > 0xFFD7) return -10;
        if ((m & 7) != (rst_next & 7)) return -10;
        ++rst_next;
        till = h.restart;
        fresh = true;
        first_line = true;
      }
      uint16_t* p = out + static_cast<int64_t>(y) * ys + x * xs;
      for (int c = 0; c < nf; ++c) {
        int t = jpegll::decode_huff(r, h.tabs[h.comp_td[c]]);
        if (t < 0 || t > 16 || r.bad) return -10;
        int32_t diff =
            jpegll::extend((t > 0 && t < 16) ? r.read(t) : 0, t);
        int32_t px;
        if (fresh) {
          px = dflt;
        } else if (first_line) {
          px = p[c - xs];
        } else if (x == 0) {
          px = p[c - ys];
        } else {
          px = jpegll::predict(p[c - xs], p[c - ys], p[c - ys - xs],
                               h.predictor);
        }
        p[c] = static_cast<uint16_t>((px + diff) & 0xFFFF);
      }
      fresh = false;
      if (till > 0) --till;
    }
  }
  if (r.bad) return -10;
  if (h.pt) {
    for (uint64_t i = 0; i < need; ++i)
      out[i] = static_cast<uint16_t>(out[i] << h.pt);
  }
  return 0;
}

}  // extern "C"
