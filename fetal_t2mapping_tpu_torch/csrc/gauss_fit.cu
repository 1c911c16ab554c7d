// Gaussian voxel T2 fit for Hopper (sm_90a): a lock-step head kernel and a
// persistent tail over the voxels still running.
//
// Replaces fetal_t2mapping_tpu/models/pallas_fit.py::_gauss_kernel_body
// (launcher _gauss_fit_tiles, init _loglin_tiles): fit S = k*exp(-TE/T2) per
// voxel by a weighted log-linear init, a 12-point static T2 grid scan, then
// the VARPRO loop — k at its clipped closed-form optimum, a 1-D
// Marquardt-damped Newton step in T2 on the Schur-reduced curvature, a KKT
// active set for the bounds — stopping on ftol (lambda <= 1), xtol, gtol,
// lambda >= 1e6, or `stall_iters` slow accepted steps in a row.
//
// What bounds it: issue slots, and how many of them a warp's idle lanes
// waste. A voxel reads T floats and writes 17 bytes once; in between it
// runs up to max_iters iterations of T expf plus ~24*T flops on values in
// registers. A warp issues instructions until its slowest lane stops, and
// the iterations a voxel needs vary from 1 to the budget: at 256^3 x 3 TEs
// one pass in one thread per voxel ran 11.0 iterations per warp for 3.9
// per voxel (bench tolerances; 14.4 for 7.7 at the pipeline's), measured
// on an H100. So the fit runs as two kernels over fit_common.cuh's
// worklist. The head, one thread per voxel, runs the init, the scan and
// kHeadIters iterations in lock-step (every voxel needs them), writes the
// voxels that stopped and pushes the carried state of the others; a
// persistent tail resumes them, refilling each lane as its voxel stops.
// What the pair still pays over its input sorted by iterations (at 256^3
// x 3 TEs on an H100, PERF.md) is the worklist's traffic (0.15-0.3 ms, paid
// even on sorted input), the tail's refills (gauss's step is short, and
// some lane of a tail warp refills on most turns: 0.15-0.3 ms) and, at the
// bench's tolerances, where the voxels still running lie (~0.27 ms).
// full_budget, a measurement instrument, keeps the one-pass kernel.
//
// Numerics follow the reference op for op so that the port agrees with it
// to float32 rounding: sums over echoes run left to right from the first
// echo, the grid-scan constants arrive precomputed in float64 and rounded
// (GaussParams), expf/logf and IEEE division (no fast math), clips that
// propagate NaN as jnp.clip does, and the library is built with
// -fmad=false so no multiply-add is fused behind the reference's back.
// Every variable crosses the split, so head + tail give the bits of one
// pass.

#include <cstdint>
#include <cstring>

#include "fit_common.cuh"

namespace {

using namespace ft2;

// Field order is mirrored by fused_fit._GAUSS_FIELDS.
struct GaussParams {
  float lo_k, hi_k, lo_t2, hi_t2;
  float tol_k;                 // 1e-8*max(hi_k-lo_k,1) (per voxel under no_prior)
  float t2_lo_thr, t2_hi_thr;  // lo_t2 + tol_t, hi_t2 - tol_t
  float ftol, gtol, stall_tol;
  float te[kMaxTE];
  float grid_t2[kGrid];
  float grid_ee[kGrid];        // sum_t grid_e[g][t]^2, summed in float64
  float grid_e[kGrid][kMaxTE]; // exp(-te/grid_t2), in float64
};
constexpr int kParamFloats = 10 + kMaxTE + 2 * kGrid + kGrid * kMaxTE;
static_assert(sizeof(GaussParams) == kParamFloats * sizeof(float),
              "GaussParams must be a packed float array");

template <int T>
__device__ __forceinline__ float sse(const float (&s)[T], float k,
                                     const float (&e)[T]) {
  constexpr float kInvT = (float)(1.0 / T);
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float d = s[t] - k * e[t];
    acc = (t == 0) ? d * d : acc + d * d;
  }
  return acc * kInvT;
}

template <int T>
__device__ __forceinline__ void exps_at(const GaussParams& p, float t2,
                                        float (&e)[T]) {
  const float u = -1.0f / t2;
#pragma unroll
  for (int t = 0; t < T; ++t) e[t] = expf(p.te[t] * u);
}

// A voxel's k bounds and the KKT thresholds inside them: the scalar box, or
// under no_prior the voxel's own lower bound, its signal at the shortest TE
// (echoes are TE-sorted: s[0]).
struct KBox {
  float lo, hi, lo_thr, hi_thr;
};

__device__ __forceinline__ KBox k_box(float s0, const GaussParams& p, bool no_prior) {
  float lo = p.lo_k, tol = p.tol_k;
  if (no_prior) {
    lo = nmax(s0, lo);
    tol = 1e-8f * nmax(p.hi_k - lo, 1.0f);
  }
  return KBox{lo, p.hi_k, lo + tol, p.hi_k - tol};
}

// What a voxel carries from one loop turn to the next. e = exp(-te/t2) at
// the iterate: exps_at(t2), except where the grid scan won and no step has
// been accepted since, when it is the scan's float64-built row
// p.grid_e[grid] (grid is -1 otherwise), which exps_at need not reproduce.
// f is always sse(s, k, e).
template <int T>
struct Gauss {
  float k, t2, f, lam, scnt, nit;
  float e[T];
  int grid;
};

// The weighted log-linear init (pallas_fit._loglin_tiles) and the T2 grid
// scan (basin selection on the static candidates).
template <int T>
__device__ __forceinline__ void prelude(const float (&s)[T], const GaussParams& p,
                                        const KBox& b, Gauss<T>& v) {
  loglin<T>(s, p.te, v.k, v.t2);
  v.k = clip(v.k, b.lo, b.hi);
  v.t2 = clip(v.t2, p.lo_t2, p.hi_t2);
  exps_at<T>(p, v.t2, v.e);
  v.f = sse<T>(s, v.k, v.e);
  v.grid = -1;
#pragma unroll
  for (int g = 0; g < kGrid; ++g) {
    float eg[T];
#pragma unroll
    for (int t = 0; t < T; ++t) eg[t] = p.grid_e[g][t];
    float num = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) num = (t == 0) ? s[t] * eg[t] : num + s[t] * eg[t];
    const float kg = clip(num / p.grid_ee[g], b.lo, b.hi);
    const float fg = sse<T>(s, kg, eg);
    if (fg < v.f) {
      v.k = kg;
      v.t2 = p.grid_t2[g];
      v.f = fg;
#pragma unroll
      for (int t = 0; t < T; ++t) v.e[t] = eg[t];
      v.grid = g;
    }
  }
  v.lam = 1e-3f;
  v.scnt = 0.0f;
  v.nit = 0.0f;
}

// One loop turn. `conv` is the voxel's flag before it (a converged voxel
// stays frozen, which only full_budget reaches); returns the flag after.
template <int T>
__device__ __forceinline__ bool step(const float (&s)[T], const GaussParams& p,
                                     const KBox& b, int stall_iters, bool conv,
                                     Gauss<T>& v) {
  constexpr float kC2 = (float)(2.0 * (1.0 / T));
  constexpr float kCm2 = (float)(-2.0 * (1.0 / T));
  constexpr float kXtol2 = (float)(1e-6 * 1e-6);

  float m[T], r[T], u[T], dm[T];
  const float inv_t2 = 1.0f / v.t2;
  const float inv_t2sq = inv_t2 * inv_t2;
  float srd = 0.f, sdd = 0.f, see = 0.f, seum = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    m[t] = v.k * v.e[t];
    r[t] = s[t] - m[t];
    u[t] = p.te[t] * inv_t2sq;  // d(-te/t2)/dt2
    dm[t] = m[t] * u[t];        // dm/dt2
    const float rd = r[t] * dm[t], dd = dm[t] * dm[t], ee = v.e[t] * v.e[t];
    const float eum = v.e[t] * u[t] * m[t];
    srd = (t == 0) ? rd : srd + rd;
    sdd = (t == 0) ? dd : sdd + dd;
    see = (t == 0) ? ee : see + ee;
    seum = (t == 0) ? eum : seum + eum;
  }
  const float g_t = kCm2 * srd;
  float h_tt = kC2 * sdd;
  const float h_kk = kC2 * see;
  const float h_kt = kC2 * seum;
  // reduced curvature: Schur complement of the Gauss-Newton 2x2
  const bool free_k = (v.k > b.lo_thr) && (v.k < b.hi_thr);
  const float h_red = h_tt - (free_k ? h_kt * h_kt / nmax(h_kk, 1e-30f) : 0.0f);
  h_tt = nmax(h_red, 0.0f);

  // KKT active set: pinned at a bound with outward gradient
  const bool pinned = ((v.t2 <= p.t2_lo_thr) && (g_t > 0.0f)) ||
                      ((v.t2 >= p.t2_hi_thr) && (g_t < 0.0f));
  const float ft = pinned ? 0.0f : 1.0f;
  float a22 = h_tt * ft + (1.0f - ft);
  a22 = a22 + v.lam * nmax(fabsf(a22), 1e-12f);
  const float p_t = -(g_t * ft) / a22;

  const float t2_new = clip(v.t2 + p_t, p.lo_t2, p.hi_t2);
  float en[T];
  exps_at<T>(p, t2_new, en);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    num = (t == 0) ? s[t] * en[t] : num + s[t] * en[t];
    den = (t == 0) ? en[t] * en[t] : den + en[t] * en[t];
  }
  const float k_new = clip(num / nmax(den, 1e-30f), b.lo, b.hi);
  const float f_new = sse<T>(s, k_new, en);

  const bool accept = f_new <= v.f;  // false on NaN
  const float rel_red =
      (v.f - f_new) / nmax(nmax(fabsf(v.f), fabsf(f_new)), 1.0f);
  const bool conv_f = accept && (rel_red <= p.ftol) && (v.lam <= 1.0f);
  const float dk = k_new - v.k, dt = t2_new - v.t2;
  const bool conv_x = dk * dk + dt * dt <= kXtol2 * ((1.0f + v.k * v.k) + v.t2 * v.t2);
  bool conv_g = false;
  if (p.gtol > 0.0f) {
    float sre = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) sre = (t == 0) ? r[t] * v.e[t] : sre + r[t] * v.e[t];
    const float g_k = kCm2 * sre;
    const float pg_k = proj_grad(v.k, g_k, b.lo_thr, b.hi_thr);
    const float pg_t = proj_grad(v.t2, g_t, p.t2_lo_thr, p.t2_hi_thr);
    conv_g = nmax(fabsf(pg_k), fabsf(pg_t)) <= p.gtol;
  }
  bool newly = (conv_f || conv_x || conv_g || (v.lam >= 1e6f)) && !conv;
  if (stall_iters > 0) {
    // scipy-ftol-style stop: stall_iters accepted-but-slow steps in a row
    const bool slow_acc = accept && (rel_red <= p.stall_tol) && !conv;
    const bool real_prog = accept && (rel_red > p.stall_tol);
    v.scnt = (conv || real_prog) ? 0.0f : (slow_acc ? v.scnt + 1.0f : v.scnt);
    newly = newly || ((v.scnt >= (float)stall_iters) && !conv);
  }

  if (accept && !conv) {
    v.k = k_new;
    v.t2 = t2_new;
    v.f = f_new;
#pragma unroll
    for (int t = 0; t < T; ++t) v.e[t] = en[t];
    v.grid = -1;
    v.nit += 1.0f;
  }
  if (!conv) v.lam = clip(accept ? v.lam * 0.2f : v.lam * 5.0f, 1e-12f, 1e10f);
  return conv || newly;
}

// The whole fit of one voxel in one pass; returns its converged flag.
// full_budget runs every voxel to max_iters.
template <int T>
__device__ __forceinline__ bool fit_voxel(const float (&s)[T], const GaussParams& p,
                                          const KBox& b, int max_iters, int stall_iters,
                                          bool full_budget, Gauss<T>& v) {
  prelude<T>(s, p, b, v);
  bool conv = false;
  for (int it = 0; it < max_iters; ++it) {
    if (conv && !full_budget) break;
    conv = step<T>(s, p, b, stall_iters, conv, v);
  }
  return conv;
}

// The same fit split in two at a resumable boundary. The head: the prelude
// and at most `head_iters` loop turns; true when the voxel still runs, to be
// resumed for the remaining max_iters - head_iters (a voxel still running
// has run exactly head_iters turns).
template <int T>
__device__ __forceinline__ bool head_voxel(const float (&s)[T], const GaussParams& p,
                                           const KBox& b, int max_iters, int stall_iters,
                                           int head_iters, Gauss<T>& v, bool& conv) {
  prelude<T>(s, p, b, v);
  conv = false;
  const int turns = head_iters < max_iters ? head_iters : max_iters;
  for (int it = 0; it < turns && !conv; ++it) conv = step<T>(s, p, b, stall_iters, false, v);
  return !conv && turns < max_iters;
}

// The tail: one loop turn of a resumed voxel with `left` (> 0) turns of
// budget; true when it stopped (conv tells how).
template <int T>
__device__ __forceinline__ bool tail_step(const float (&s)[T], const GaussParams& p,
                                          const KBox& b, int stall_iters, Gauss<T>& v,
                                          bool& conv, int& left) {
  conv = step<T>(s, p, b, stall_iters, false, v);
  return conv || --left == 0;
}

// A worklist slot holds what a resumed voxel needs, contiguous and padded
// to whole float4s: its index, k, t2, lam, the stall count, n_iter, e[T]
// (which t2 cannot always rebuild) and its signal s[T], so that resuming is
// a few vector loads, none of them waiting on the index. f is recomputed as
// sse(s, k, e) on loading, the converged flag is false in every pushed
// state, and the k box is rebuilt from the signal.
template <int T>
constexpr int kSlotFloats = (6 + 2 * T + 3) / 4 * 4;

template <int T>
constexpr int slot_rows() { return kSlotFloats<T>; }

// Slot `slot` of the worklist.
template <int T>
__device__ __forceinline__ void save_slot(float* rows, long long slot, int index,
                                          const float (&s)[T], const Gauss<T>& v) {
  float w[kSlotFloats<T>];
  w[0] = index_bits(index);
  w[1] = v.k;
  w[2] = v.t2;
  w[3] = v.lam;
  w[4] = v.scnt;
  w[5] = v.nit;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    w[6 + t] = v.e[t];
    w[6 + T + t] = s[t];
  }
#pragma unroll
  for (int j = 6 + 2 * T; j < kSlotFloats<T>; ++j) w[j] = 0.0f;
  float4* d = reinterpret_cast<float4*>(rows) + slot * (kSlotFloats<T> / 4);
#pragma unroll
  for (int j = 0; j < kSlotFloats<T> / 4; ++j)
    d[j] = float4{w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]};
}

// A slot's voxel: returns its index, and fills its signal and its state.
template <int T>
__device__ __forceinline__ int load_slot(const float* rows, long long slot, float (&s)[T],
                                         Gauss<T>& v) {
  float w[kSlotFloats<T>];
  const float4* src = reinterpret_cast<const float4*>(rows) + slot * (kSlotFloats<T> / 4);
#pragma unroll
  for (int j = 0; j < kSlotFloats<T> / 4; ++j) {
    const float4 q = src[j];
    w[4 * j] = q.x;
    w[4 * j + 1] = q.y;
    w[4 * j + 2] = q.z;
    w[4 * j + 3] = q.w;
  }
  v.k = w[1];
  v.t2 = w[2];
  v.lam = w[3];
  v.scnt = w[4];
  v.nit = w[5];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    v.e[t] = w[6 + t];
    s[t] = w[6 + T + t];
  }
  v.grid = -1;  // not read again: a resumed voxel is never pushed
  v.f = sse<T>(s, v.k, v.e);
  return index_of(w[0]);
}

}  // namespace

// ---- kernel and C entry

namespace {

// Loop turns of the head kernel. Every voxel runs at least one (only a
// step's tests stop it), so the first leaves no lane idle in the head and
// spares the worklist the voxels it stops: after one turn 65% of the
// voxels still run at the bench's tolerances (ftol = gtol = 1e-2), 97% at
// the pipeline's (ftol 1e-9, gtol 0), at 256^3 x 3 TEs on an H100
// (chip_smoke.warp_profile). A second turn idles the lanes of the voxels
// the first stopped. Against 0, 2 and 4 turns, in five alternating rounds
// per call, three runs on an H100 (chip_smoke.gauss_head_lengths): at the
// pipeline's tolerances, which the main path runs, 1 and 2 were level
// (within 0.02 ms) and 0 and 4 0.07-0.14 ms slower; at the bench's, 0 was
// level with 1 or up to 0.04 ms faster, 2 and 4 0.08-0.11 and 0.19-0.25 ms
// slower. 1 is the only length within 0.05 ms of the fastest at both.
constexpr int kHeadIters = 1;

template <int T>
__device__ __forceinline__ void write_result(long long i, const Gauss<T>& v, bool conv,
                                             float* k_out, float* t2_out, float* f_out,
                                             uint8_t* conv_out, int32_t* nit_out) {
  k_out[i] = v.k;
  t2_out[i] = v.t2;
  f_out[i] = v.f;
  conv_out[i] = conv ? 1 : 0;
  nit_out[i] = (int32_t)v.nit;
}

// full_budget (a measurement instrument): every voxel to max_iters in one pass.
template <int T>
__global__ void __launch_bounds__(kThreads)
gauss_single_kernel(const float* __restrict__ signal, long long n,
                    const GaussParams p, int max_iters, int stall_iters,
                    bool no_prior, float* __restrict__ k_out,
                    float* __restrict__ t2_out, float* __restrict__ f_out,
                    uint8_t* __restrict__ conv_out, int32_t* __restrict__ nit_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s[T];
  load_signal<T>(signal, i, s);
  const KBox b = k_box(s[0], p, no_prior);
  Gauss<T> v;
  const bool conv = fit_voxel<T>(s, p, b, max_iters, stall_iters, true, v);
  write_result<T>(i, v, conv, k_out, t2_out, f_out, conv_out, nit_out);
}

// The head: one thread per voxel; a voxel that stopped writes its results,
// one still running pushes its state to the worklist. Threads past the end
// take part in the push (it holds __syncthreads) with nothing to push.
template <int T>
__global__ void __launch_bounds__(kThreads)
gauss_head_kernel(const float* __restrict__ signal, long long n,
                  const GaussParams p, int max_iters, int stall_iters,
                  bool no_prior, float* __restrict__ k_out,
                  float* __restrict__ t2_out, float* __restrict__ f_out,
                  uint8_t* __restrict__ conv_out, int32_t* __restrict__ nit_out,
                  float* __restrict__ rows, int* counters) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float s[T];
  Gauss<T> v;
  bool runs = false;
  if (i < n) {
    load_signal<T>(signal, i, s);
    const KBox b = k_box(s[0], p, no_prior);
    bool conv;
    runs = head_voxel<T>(s, p, b, max_iters, stall_iters, kHeadIters, v, conv);
    if (!runs) write_result<T>(i, v, conv, k_out, t2_out, f_out, conv_out, nit_out);
  }
  const int slot = push_slot<kThreads>(runs, counters);  // every thread of the block
  if (runs) save_slot<T>(rows, slot, (int)i, s, v);
}

// One lane's voxel in the tail (ft2::drain's job).
template <int T>
struct TailJob {
  const GaussParams& p;
  const float* rows;
  int budget, stall_iters;
  bool no_prior;
  float* k_out;
  float* t2_out;
  float* f_out;
  uint8_t* conv_out;
  int32_t* nit_out;
  float s[T];
  KBox b;
  Gauss<T> v;
  int index, left;
  bool conv;

  __device__ __forceinline__ void load(int slot) {
    index = load_slot<T>(rows, slot, s, v);
    b = k_box(s[0], p, no_prior);
    left = budget;
  }
  __device__ __forceinline__ bool step() {
    return tail_step<T>(s, p, b, stall_iters, v, conv, left);
  }
  __device__ __forceinline__ void store() {
    write_result<T>(index, v, conv, k_out, t2_out, f_out, conv_out, nit_out);
  }
};

// The tail: a persistent grid drains the worklist, each lane refilled as
// its voxel stops. The pushed count stays on the device; a slot carries
// its voxel's signal.
template <int T>
__global__ void __launch_bounds__(kThreads)
gauss_tail_kernel(const GaussParams p, int max_iters, int stall_iters, bool no_prior,
                  float* __restrict__ k_out, float* __restrict__ t2_out,
                  float* __restrict__ f_out, uint8_t* __restrict__ conv_out,
                  int32_t* __restrict__ nit_out, const float* __restrict__ rows,
                  int* counters) {
  TailJob<T> job{p, rows, max_iters - kHeadIters, stall_iters, no_prior,
                 k_out, t2_out, f_out, conv_out, nit_out};
  drain(job, counters);
}

template <int T>
int launch(const float* signal, long long n, const GaussParams& p, int max_iters,
           int stall_iters, bool no_prior, bool full_budget, float* k, float* t2,
           float* f, uint8_t* conv, int32_t* nit, float* rows, int* counters,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (full_budget) {
    gauss_single_kernel<T><<<blocks, kThreads, 0, stream>>>(
        signal, n, p, max_iters, stall_iters, no_prior, k, t2, f, conv, nit);
    return (int)cudaGetLastError();
  }
  gauss_head_kernel<T><<<blocks, kThreads, 0, stream>>>(
      signal, n, p, max_iters, stall_iters, no_prior, k, t2, f, conv, nit, rows, counters);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gauss_tail_kernel<T><<<persistent_blocks(gauss_tail_kernel<T>, kThreads), kThreads, 0,
                         stream>>>(
      p, max_iters, stall_iters, no_prior, k, t2, f, conv, nit, rows, counters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ft2_gauss_params_floats() { return kParamFloats; }

// Loop turns the head kernel runs before the tail takes over.
extern "C" int ft2_gauss_head_iters() { return kHeadIters; }

// Floats of worklist per voxel at n_te echoes (the wrapper allocates
// n_te-dependent rows of n floats).
extern "C" int ft2_gauss_slot_rows(int n_te) {
  switch (n_te) {
    case 2: return slot_rows<2>();
    case 3: return slot_rows<3>();
    case 4: return slot_rows<4>();
    case 5: return slot_rows<5>();
    case 6: return slot_rows<6>();
    case 7: return slot_rows<7>();
    case 8: return slot_rows<8>();
    default: return 0;
  }
}

// signal: (n, n_te) row-major float32 on the device; params: kParamFloats
// host floats (GaussParams). Outputs are device arrays of length n. rows:
// ft2_gauss_slot_rows(n_te) x n device floats of worklist; counters: 2
// device ints, zero. Unless full_budget, two kernels run, the head and the
// tail; returns cudaGetLastError() after the first launch that failed or
// the last one (0 = launched).
extern "C" int ft2_gauss_fit(const float* signal, long long n, int n_te,
                             const float* params, int max_iters,
                             int stall_iters, int no_prior, int full_budget,
                             float* k, float* t2, float* f,
                             unsigned char* conv, int* nit, float* rows,
                             int* counters, void* stream) {
  GaussParams p;
  std::memcpy(&p, params, sizeof(p));
  if (n <= 0 || n > kMaxWorklist) return (int)cudaErrorInvalidValue;
  if (!full_budget && (rows == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool np = no_prior != 0, fb = full_budget != 0;
  switch (n_te) {
    case 2: return launch<2>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 3: return launch<3>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 4: return launch<4>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 5: return launch<5>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 6: return launch<6>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 7: return launch<7>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    case 8: return launch<8>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, rows, counters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
