// Device helpers shared by the fit kernels (gauss_fit.cu, gr_varpro_fit.cu,
// fit3.cu): NaN-keeping clips, left-to-right echo sums, the weighted
// log-linear start, the exact T = 3 gaussian_rician interpolant, the bound
// on a buffer's live rows, and the worklist that compacts the voxels still
// running into a tail kernel.
//
// Numerics follow fetal_t2mapping_tpu_torch/models/fused_fit.py op for op
// (which follows the JAX package's kernels): each helper rounds where its
// plain version rounds, and the libraries are built with -fmad=false so no
// multiply-add is fused. Constants that the reference computes between
// Python floats arrive precomputed in float64 and rounded, in the
// parameter structs.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace ft2 {

constexpr int kMaxTE = 8;
constexpr int kGrid = 12;
constexpr int kInterp = 16;
constexpr int kThreads = 128;

// jnp.maximum / jnp.minimum / jnp.clip (and torch.maximum / clamp): a NaN
// operand gives NaN (fmaxf/fminf would drop it).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

// 1.0 where a coordinate is free, 0.0 where it is pinned at a bound with
// its gradient pointing outward (the KKT active set).
__device__ __forceinline__ float free_of(float x, float g, float lo_thr,
                                         float hi_thr) {
  return ((x <= lo_thr && g > 0.0f) || (x >= hi_thr && g < 0.0f)) ? 0.0f
                                                                   : 1.0f;
}

// the projected gradient component the gtol test reads
__device__ __forceinline__ float proj_grad(float x, float g, float lo_thr,
                                           float hi_thr) {
  return (x <= lo_thr) ? nmin(g, 0.0f) : (x >= hi_thr) ? nmax(g, 0.0f) : g;
}

// sum_t a[t] * b[t], left to right from the first echo
template <int T>
__device__ __forceinline__ float dot(const float (&a)[T], const float (&b)[T]) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int t = 1; t < T; ++t) acc = acc + a[t] * b[t];
  return acc;
}
template <int T>
__device__ __forceinline__ float dot(const float (&a)[T], const float* b) {
  float acc = a[0] * b[0];
#pragma unroll
  for (int t = 1; t < T; ++t) acc = acc + a[t] * b[t];
  return acc;
}

// voxel i's T echoes of an (n, T) row-major signal
template <int T>
__device__ __forceinline__ void load_signal(const float* signal, long long i, float (&s)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = signal[i * T + t];
}

// weighted log-linear (k, t2) estimate, unclipped (_loglin_tiles)
template <int T>
__device__ __forceinline__ void loglin(const float (&s)[T], const float* te,
                                       float& k, float& t2) {
  float sw = 0.f, st = 0.f, stt = 0.f, sy = 0.f, sty = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float sv = nmax(s[t], 1e-6f);
    const float y = logf(sv), w = sv * sv, w_te = w * te[t];
    sw = (t == 0) ? w : sw + w;
    st = (t == 0) ? w_te : st + w_te;
    stt = (t == 0) ? w_te * te[t] : stt + w_te * te[t];
    sy = (t == 0) ? w * y : sy + w * y;
    sty = (t == 0) ? w_te * y : sty + w_te * y;
  }
  float det = sw * stt - st * st;
  det = (fabsf(det) < 1e-30f) ? 1e-30f : det;
  const float b = (sw * sty - st * sy) / det;
  const float a = (sy - b * st) / sw;
  t2 = (b < -1e-12f) ? -1.0f / b : 2000.0f;
  k = expf(clip(a, -30.0f, 30.0f));
}

// The exact 0-dof interpolation start of gaussian_rician at T = 3
// (_interp_start_gr): t2 solves (s1^2-s2^2)(E2-E3) = (s2^2-s3^2)(E1-E2),
// E_i = exp(-2 te_i/t2); bracket it on the static 16-point grid (the E
// differences arrive precomputed), bisect geometrically ``n_bisect``
// times, then k^2 and sigma^2 in closed form, clipped into the box. Voxels
// with no interpolant take the clipped protocol guess ``fb``.
__device__ __forceinline__ void interp_start_gr(
    const float (&s)[3], const float* ts, const float* t12, const float* t01,
    const float* m2te, const float* lo, const float* hi, const float* fb,
    int n_bisect, float& k_out, float& t2_out, float& sg_out) {
  const float sq0 = s[0] * s[0], sq1 = s[1] * s[1], sq2 = s[2] * s[2];
  const float d12 = sq0 - sq1, d23 = sq1 - sq2;
  float a = ts[0], b = ts[kInterp - 1];
  float g_prev = d12 * t12[0] - d23 * t01[0];
  float ga = g_prev;
  bool found = false;
#pragma unroll
  for (int i = 0; i < kInterp - 1; ++i) {
    const float g_next = d12 * t12[i + 1] - d23 * t01[i + 1];
    const bool cross = (g_prev * g_next <= 0.0f) && !found;
    if (cross) {
      a = ts[i];
      b = ts[i + 1];
      ga = g_prev;
      found = true;
    }
    g_prev = g_next;
  }
  for (int it = 0; it < n_bisect; ++it) {
    const float m = sqrtf(a * b);
    const float e0 = expf(m2te[0] / m), e1 = expf(m2te[1] / m),
                e2 = expf(m2te[2] / m);
    const float gm = d12 * (e1 - e2) - d23 * (e0 - e1);
    if ((gm > 0.0f) == (ga > 0.0f)) {
      a = m;
      ga = gm;
    } else {
      b = m;
    }
  }
  const float t2r = sqrtf(a * b);
  const float e0 = expf(m2te[0] / t2r), e1 = expf(m2te[1] / t2r),
              e2 = expf(m2te[2] / t2r);
  const float denom = e0 - e1;
  const float k2 = d12 / ((fabsf(denom) < 1e-30f) ? 1e-30f : denom);
  const float sg2 = sq2 - k2 * e2;
  const bool valid = found && (d12 > 0.0f) && (d23 > 0.0f) && (k2 > 0.0f);
  k_out = valid ? clip(sqrtf(nmax(k2, 0.0f)), lo[0], hi[0]) : fb[0];
  t2_out = valid ? t2r : fb[1];
  sg_out = valid ? clip(sqrtf(nmax(sg2, 0.0f)), lo[2], hi[2]) : fb[2];
}

// ---- the live rows of a fit buffer
//
// A caller that knows on the device how many leading blocks of its buffer
// hold voxels it will read (the block layout's touched-block count) passes
// that count: the fit then takes rows [0, live_rows) only. A row at or
// past the bound is written as an unfitted voxel (parameters, objective,
// converged and n_iter all 0) and never enters a worklist; a thread block
// whose first row is past it does nothing else. The launch keeps the
// buffer's size, so the host reads nothing. Without a count every row is
// live.
struct RowBound {
  const int* live_blocks;  // device count of live blocks, or null: every row
  int block;               // rows per block
};

__device__ __forceinline__ long long live_rows(const RowBound& bound, long long n) {
  if (bound.live_blocks == nullptr) return n;
  const long long rows = (long long)*bound.live_blocks * bound.block;
  return rows < n ? rows : n;
}

// An unfitted row of the (3, n) parameter and stats arrays (k, t2, sigma;
// f, converged, n_iter) of the 3-parameter fits.
__device__ __forceinline__ void write_unfitted3(long long n, long long i, float* x_out,
                                                float* st_out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[c * n + i] = 0.0f;
    st_out[c * n + i] = 0.0f;
  }
}

// Bits of a voxel index in a float worklist row, and back.
__device__ __forceinline__ float index_bits(int i) {
  float f;
  memcpy(&f, &i, sizeof(f));
  return f;
}
__device__ __forceinline__ int index_of(float f) {
  int i;
  memcpy(&i, &f, sizeof(i));
  return i;
}

#ifdef __CUDACC__
// ---- the worklist of voxels still running
//
// A warp issues instructions until its slowest lane stops, so a voxel that
// needs many iterations holds 31 lanes idle. A fit therefore runs in two
// kernels: a head, one thread per voxel, writes the voxels that stopped
// and pushes the state of the others into a slot-indexed worklist
// (structure of arrays: row r of slot k at rows[r * capacity + k]); a
// persistent tail drains it, refilling each lane as its voxel stops.
// counters[0] counts the pushed slots, counters[1] hands them out; both
// start at 0 (the wrapper zeroes them), and the kernels allocate nothing.

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
// Voxels a worklist takes: slots, indices and the hand-out counter are
// ints, and the counter may pass the count by 32 per warp of the tail.
constexpr long long kMaxWorklist = 1LL << 30;

// Blocks of a persistent grid of `kernel`: as many as the card holds at
// once. A failed query leaves its error for the launch's check.
template <class Kernel>
inline unsigned persistent_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return (unsigned)(sms * per_sm > 0 ? sms * per_sm : 1);
}

// The worklist slot of each thread whose `push` is set, or -1: one
// atomicAdd per block of kBlock threads (with one per warp, the short
// continuation sweep waited on the one hot counter), and a block's slots
// consecutive so its row writes coalesce. Every thread of the block calls
// it (it holds two __syncthreads).
template <int kBlock>
__device__ __forceinline__ int push_slot(bool push, int* counters) {
  __shared__ int warp_base[kBlock / kWarp];
  __shared__ int block_base;
  const unsigned want = __ballot_sync(kFullMask, push);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) warp_base[warp] = __popc(want);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kBlock / kWarp; ++w) {
      const int count = warp_base[w];
      warp_base[w] = total;
      total += count;
    }
    block_base = total > 0 ? atomicAdd(&counters[0], total) : 0;
  }
  __syncthreads();
  return push ? block_base + warp_base[warp] + __popc(want & ((1u << lane) - 1u)) : -1;
}

// The tail's persistent pop loop. Each turn, idle lanes take slots
// (job.load(slot)) and every lane with a voxel runs one iteration
// (job.step(), true when the voxel stopped; job.store() then writes its
// outputs and the lane is idle again), so a warp never waits on one lane
// while slots remain. A warp reserves 32 slots at a time with one
// atomicAdd on counters[1] and hands them to its idle lanes in turn.
// Which lane runs which voxel changes from run to run; no result depends
// on it. Every lane of the warp calls it.
template <class Job>
__device__ __forceinline__ void drain(Job& job, int* counters) {
  const int n_slots = counters[0];
  const unsigned below = (1u << (threadIdx.x % kWarp)) - 1u;
  int from = 0, to = 0;  // the warp's reserved slots not yet handed out
  bool dry = false, busy = false;
  for (;;) {
    const unsigned idle = __ballot_sync(kFullMask, !busy);
    if (idle != 0 && from == to && !dry) {
      int base = 0;
      if (threadIdx.x % kWarp == 0) base = atomicAdd(&counters[1], kWarp);
      base = __shfl_sync(kFullMask, base, 0);
      dry = base >= n_slots;
      from = dry ? 0 : base;
      to = dry ? 0 : min(base + kWarp, n_slots);
    }
    if (idle != 0 && from < to) {
      const int take = min(__popc(idle), to - from);
      const int rank = __popc(idle & below);
      if (!busy && rank < take) {
        job.load(from + rank);
        busy = true;
      }
      from += take;
    }
    if (!__any_sync(kFullMask, busy)) break;  // only once dry: see above
    if (busy && job.step()) {
      job.store();
      busy = false;
    }
  }
}
#endif  // __CUDACC__

}  // namespace ft2
