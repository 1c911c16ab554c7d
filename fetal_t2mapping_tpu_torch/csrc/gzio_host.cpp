// Host library of the port's NIfTI I/O: gzip-transparent file reads, a
// thread-pool batch reader and gzip writes, for core/nifti.py through
// native.py.
//
// A copy of the file entries of the JAX package's native/ft2io.cpp
// (ft2_read_file, ft2_read_batch, ft2_write_file): zlib's gzread/gzwrite
// loops, the truncated-member check, and the std::thread batch pool. Host
// C++, not a GPU kernel: build.py builds it with g++ (-O3 -fPIC -shared
// -std=c++17 -pthread, linked with -lz) into _build/ at first use and binds
// it with ctypes. ctypes releases the GIL around every call, so the writer
// pool's gzip compressions run in parallel.
//
// Plain C ABI. Every function returns 0 on success or a negative code;
// buffers are malloc'd here and released with ft2_gz_free.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

static const char kVersion[] = "gzio_host 1.0";

const char* ft2_gz_version() { return kVersion; }

void ft2_gz_free(uint8_t* p) { free(p); }

// gz-transparent read: zlib's gzread inflates gzip members and passes raw
// bytes through for uncompressed files, so one path serves .nii and .nii.gz.
static int read_file_impl(const char* path, uint8_t** out, uint64_t* len) {
  *out = nullptr;
  *len = 0;
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  (void)gzbuffer(f, 1 << 20);

  uint64_t cap = 1 << 22;  // 4 MiB start; doubles as needed
  uint8_t* buf = static_cast<uint8_t*>(malloc(cap));
  if (!buf) { gzclose(f); return -2; }
  uint64_t total = 0;
  for (;;) {
    if (total == cap) {
      cap *= 2;
      uint8_t* nb = static_cast<uint8_t*>(realloc(buf, cap));
      if (!nb) { free(buf); gzclose(f); return -2; }
      buf = nb;
    }
    unsigned chunk = static_cast<unsigned>(
        cap - total > (1u << 30) ? (1u << 30) : cap - total);
    int n = gzread(f, buf + total, chunk);
    if (n < 0) { free(buf); gzclose(f); return -3; }
    if (n == 0) {
      // gzread returns 0 both at a clean end of stream AND when the last
      // gzip member is truncated (it reports the premature end only via
      // gzerror as Z_BUF_ERROR). Returning the partial inflate as success
      // would hand a short payload to the NIfTI parser: a read error.
      int errnum = Z_OK;
      gzerror(f, &errnum);
      if (errnum != Z_OK || !gzeof(f)) { free(buf); gzclose(f); return -3; }
      break;
    }
    total += static_cast<uint64_t>(n);
  }
  gzclose(f);
  *out = buf;
  *len = total;
  return 0;
}

int ft2_read_file(const char* path, uint8_t** out, uint64_t* len) {
  return read_file_impl(path, out, len);
}

// Thread-pool batch read: atomically claim indices until the list drains.
// Returns the number of paths that failed (errs[i] holds each one's code).
int ft2_read_batch(const char** paths, int32_t n, uint8_t** outs,
                   uint64_t* lens, int32_t* errs, int32_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      errs[i] = read_file_impl(paths[i], &outs[i], &lens[i]);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(n_threads));
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int32_t bad = 0;
  for (int32_t i = 0; i < n; ++i)
    if (errs[i] != 0) ++bad;
  return bad;
}

// level >= 0: gzip at that level (capped at 9); level < 0: raw write.
int ft2_write_file(const char* path, const uint8_t* buf, uint64_t len,
                   int32_t level) {
  if (level < 0) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t w = fwrite(buf, 1, len, f);
    int rc = fclose(f);  // a buffered flush can fail here (e.g. ENOSPC)
    return (w == len && rc == 0) ? 0 : -4;
  }
  char mode[8];
  snprintf(mode, sizeof mode, "wb%d", level > 9 ? 9 : level);
  gzFile f = gzopen(path, mode);
  if (!f) return -1;
  (void)gzbuffer(f, 1 << 20);
  uint64_t done = 0;
  while (done < len) {
    unsigned chunk = static_cast<unsigned>(
        len - done > (1u << 30) ? (1u << 30) : len - done);
    int w = gzwrite(f, buf + done, chunk);
    if (w <= 0) { gzclose(f); return -4; }
    done += static_cast<uint64_t>(w);
  }
  return gzclose(f) == Z_OK ? 0 : -4;
}

}  // extern "C"
