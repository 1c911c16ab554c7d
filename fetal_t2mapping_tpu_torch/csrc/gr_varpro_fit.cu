// gaussian_rician voxel fit by variable projection, one thread per voxel,
// for Hopper (sm_90a).
//
// Replaces fetal_t2mapping_tpu/models/pallas_fit.py::_gr_varpro_kernel_body
// (launcher _gr_varpro_fit_tiles, start _interp_start_gr). The objective
// f = mean_t (s - sqrt(a E_t + b))^2, E = exp(-2 te/t2), is linear in
// (a, b) = (k^2, sigma^2) under the square root, and its profile over the
// (a, b) box at fixed t2 is convex: an exp-free projected 2x2 Newton
// ("inner") profiles (a, b), and a Marquardt-damped 1-D Newton step walks
// t2 along the envelope F(t2) = min_{a,b} f, on the Schur-reduced
// Gauss-Newton curvature, with a KKT active set for the bounds. Basin
// selection before the loop: the log-linear start, the exact T = 3
// interpolant (8 bisections), a 12-point static t2 grid scored by a
// closed-form s^2-space least-squares fit, then one exact polish. Stops on
// ftol (lambda <= 1), xtol, gtol, lambda >= 1e6, or `stall_iters` slow
// accepted steps in a row (stall_tol = max(ftol, 1e-3)).
//
// What bounds it: instruction issue. A voxel reads T floats and writes 24
// bytes; in between, the prelude costs ~45 expf plus ~10 inner steps of T
// reciprocal square roots each, and every outer iteration T expf (E at the
// candidate; E at the current iterate is carried) plus 3 inner steps. One
// thread owns one voxel's state in registers and T is a template parameter
// so the echo loops unroll. But a warp issues until its slowest lane
// stops, and the voxels that need many iterations are few and scattered:
// at 256^3 x 3 TEs one voxel in eight still runs after the first
// iteration, and a warp holding one pays its whole budget. So the fit runs
// in two kernels split at a resumable boundary. The head (one thread per
// voxel) runs the prelude and kHeadIters outer iterations, writes the
// voxels that stopped and pushes the state of the others (t2, a, b, f,
// lam, the stall count, n_iter and E: 8 + T floats with the index) into a
// worklist; a persistent tail resumes them, each lane taking the next
// voxel as soon as its own stops (fit_common.cuh: push_slot, drain). Each
// voxel runs the same iterations on the same state as in one pass, so the
// results are those of one pass, whatever lane or order the tail gives it;
// a converged voxel is frozen, so they equal the TPU kernel's block-wide
// loop. full_budget (a measurement instrument) keeps the single pass.
// Given a live-row bound (fit_common.cuh's RowBound), the head and the
// single pass fit only the rows before it and write the others unfitted;
// the tail drains only what the head pushed.
//
// Everything above the "kernel and C entry" marker is per-thread code that
// also compiles as host C++ (tests/test_torch_gr_varpro_host.py runs the
// head, the worklist and the tail there against the plain version).
//
// Numerics follow fused_fit._gr_varpro_fit_plain op for op: left-to-right
// echo sums, the grid's E, sum E, sum E^2 and 1/det and the interpolant's
// bracket grid precomputed in float64 and rounded (GrParams), expf/logf,
// IEEE division and square root, NaN-keeping clips, and -fmad=false.
// lax.rsqrt is rsqrtf here: it is what torch.rsqrt runs on the card, so
// the plain version (torch.rsqrt) and the kernel agree to the bit
// (ft2_rsqrt_probe checks that on the card).

#include <cstdint>
#include <cstring>

#include "fit_common.cuh"

namespace {

using namespace ft2;

// Field order is mirrored by fused_fit._GR_FIELDS.
struct GrParams {
  float lo[3], hi[3];            // (k, t2, sigma) box
  float ab[4];                   // alo, ahi, blo, bhi = the box of (k^2, sigma^2)
  float thr[6];                  // pinned-bound thresholds of a, b, t2 (lo, hi)
  float b_init;                  // sigma^2 start: guess^2 clipped
  float fb[3];                   // clipped guess: the interpolant's fallback
  float tols[3];                 // ftol, gtol, stall_tol
  float te[kMaxTE];
  float m2te[kMaxTE];            // -2 te
  float grid_t2[kGrid];
  float grid_e[kGrid][kMaxTE];   // exp(-2 te/grid_t2)
  float grid_se[kGrid], grid_se2[kGrid], grid_idet[kGrid];
  float it_ts[kInterp], it_d12[kInterp], it_d01[kInterp];
};
constexpr int kParamFloats = 23 + 2 * kMaxTE + kGrid * (4 + kMaxTE) + 3 * kInterp;
static_assert(sizeof(GrParams) == kParamFloats * sizeof(float),
              "GrParams must be a packed float array");

__device__ __forceinline__ float minv_of(float q) {
  // q >= blo normally; the 1e-6 guard keeps degenerate boxes in fp32
  return rsqrtf(nmax(q, 1e-6f));
}

template <int T>
struct VarPro {
  static constexpr float kInvT = (float)(1.0 / T);
  static constexpr float kCm1 = (float)(-(1.0 / T));
  static constexpr float kCh = (float)(0.5 * (1.0 / T));
  static constexpr float kCm2 = (float)(-2.0 * (1.0 / T));
  static constexpr float kC2 = (float)(2.0 * (1.0 / T));

  const GrParams& p;
  const float (&s)[T];

  __device__ __forceinline__ void E_at(float t2, float (&E)[T]) const {
    const float u = -2.0f / t2;
#pragma unroll
    for (int t = 0; t < T; ++t) E[t] = expf(p.te[t] * u);
  }

  // ``iters`` projected-Newton steps on the convex (a, b) profile
  __device__ __forceinline__ void inner(const float (&E)[T], float& a, float& b,
                        int iters) const {
    for (int it = 0; it < iters; ++it) {
      float m[T], r[T], w[T];
      float sre = 0.f, sr = 0.f, see = 0.f, sew = 0.f, sw = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float q = a * E[t] + b;
        m[t] = minv_of(q);
        r[t] = s[t] - q * m[t];
        w[t] = s[t] * m[t] * m[t] * m[t];
        const float v_re = r[t] * E[t] * m[t], v_r = r[t] * m[t];
        const float v_ee = E[t] * E[t] * w[t], v_ew = E[t] * w[t];
        sre = (t == 0) ? v_re : sre + v_re;
        sr = (t == 0) ? v_r : sr + v_r;
        see = (t == 0) ? v_ee : see + v_ee;
        sew = (t == 0) ? v_ew : sew + v_ew;
        sw = (t == 0) ? w[t] : sw + w[t];
      }
      const float ga = kCm1 * sre, gb = kCm1 * sr;
      const float haa = kCh * see, hab = kCh * sew, hbb = kCh * sw;
      const float fa = free_of(a, ga, p.thr[0], p.thr[1]);
      const float fb = free_of(b, gb, p.thr[2], p.thr[3]);
      const float a00 = haa * fa + (1.0f - fa);
      const float a11 = hbb * fb + (1.0f - fb);
      const float a01 = hab * fa * fb;
      const float b0 = ga * fa, b1 = gb * fb;
      const float det = a00 * a11 - a01 * a01;
      const float idet = 1.0f / ((fabsf(det) < 1e-30f) ? 1e-30f : det);
      a = clip(a - (a11 * b0 - a01 * b1) * idet * fa, p.ab[0], p.ab[1]);
      b = clip(b - (a00 * b1 - a01 * b0) * idet * fb, p.ab[2], p.ab[3]);
    }
  }

  template <class Es>
  __device__ __forceinline__ float f_of(const Es& E, float a, float b) const {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float q = a * E[t] + b;
      const float d = s[t] - q * minv_of(q);
      acc = (t == 0) ? d * d : acc + d * d;
    }
    return kInvT * acc;
  }
};

// The outer loop's carried state: all that crosses from the head kernel to
// the tail. E (exp(-2 te/t2) at the iterate) comes from the grid table or
// the interpolant as often as from expf, so it is carried, never
// recomputed.
template <int T>
struct Outer {
  float t2, a, b, f, lam, convf, scnt, nit;
  float E[T];
};

// Basin selection (loglinear, exact interpolant, static t2 grid, one
// polish) and the outer loop's initial state.
template <int T>
__device__ __forceinline__ void prelude(const float (&s)[T], const GrParams& p,
                                        Outer<T>& o) {
  const VarPro<T> vp{p, s};
  const float lo_t2 = p.lo[1], hi_t2 = p.hi[1];
  float &t2 = o.t2, &a = o.a, &b = o.b, &f = o.f;
  float (&E)[T] = o.E;

  float k_ll, t2_ll;
  loglin<T>(s, p.te, k_ll, t2_ll);
  t2 = clip(t2_ll, lo_t2, hi_t2);
  const float kc = clip(k_ll, p.lo[0], p.hi[0]);
  a = clip(kc * kc, p.ab[0], p.ab[1]);
  b = p.b_init;
  vp.E_at(t2, E);
  vp.inner(E, a, b, 2);
  f = vp.f_of(E, a, b);

  if constexpr (T == 3) {
    float ki, t2i, sgi;
    interp_start_gr(s, p.it_ts, p.it_d12, p.it_d01, p.m2te, p.lo, p.hi, p.fb,
                    8, ki, t2i, sgi);
    float Ei[T];
    vp.E_at(t2i, Ei);
    float ai = ki * ki, bi = sgi * sgi;
    vp.inner(Ei, ai, bi, 2);
    const float fi = vp.f_of(Ei, ai, bi);
    if (fi < f) {
      t2 = t2i;
      a = ai;
      b = bi;
      f = fi;
#pragma unroll
      for (int t = 0; t < T; ++t) E[t] = Ei[t];
    }
  }

  float sq[T];
#pragma unroll
  for (int t = 0; t < T; ++t) sq[t] = s[t] * s[t];
  float sq_sum = sq[0];
#pragma unroll
  for (int t = 1; t < T; ++t) sq_sum = sq_sum + sq[t];
#pragma unroll
  for (int g = 0; g < kGrid; ++g) {
    const float* Eg = p.grid_e[g];
    const float s1 = dot<T>(sq, Eg);
    const float ag = clip(((float)T * s1 - p.grid_se[g] * sq_sum) * p.grid_idet[g],
                          p.ab[0], p.ab[1]);
    const float bg = clip((p.grid_se2[g] * sq_sum - p.grid_se[g] * s1) * p.grid_idet[g],
                          p.ab[2], p.ab[3]);
    const float fg = vp.f_of(Eg, ag, bg);
    if (fg < f) {
      t2 = p.grid_t2[g];
      a = ag;
      b = bg;
      f = fg;
#pragma unroll
      for (int t = 0; t < T; ++t) E[t] = Eg[t];
    }
  }
  {  // ONE exact polish of the winner; keep (a, b, f) consistent
    float a2 = a, b2 = b;
    vp.inner(E, a2, b2, 3);
    const float f2 = vp.f_of(E, a2, b2);
    if (f2 <= f) {
      a = a2;
      b = b2;
      f = f2;
    }
  }
  o.lam = 1e-3f;
  o.convf = 0.0f;
  o.scnt = 0.0f;
  o.nit = 0.0f;
}

// One iteration of the outer damped 1-D Newton on the envelope F(t2).
// `conv`: the voxel converged before it (only full_budget runs those, and
// they stay frozen).
template <int T>
__device__ __forceinline__ void outer_step(const float (&s)[T], const GrParams& p,
                                           int stall_iters, bool conv, Outer<T>& o) {
  constexpr float kXtol2 = (float)(1e-6 * 1e-6);
  const VarPro<T> vp{p, s};
  const float lo_t2 = p.lo[1], hi_t2 = p.hi[1];
  const float ftol = p.tols[0], gtol = p.tols[1], stall_tol = p.tols[2];
  float &t2 = o.t2, &a = o.a, &b = o.b, &f = o.f;
  float &lam = o.lam, &convf = o.convf, &scnt = o.scnt, &nit = o.nit;
  float (&E)[T] = o.E;

  const float inv_t2 = 1.0f / t2;
  const float inv_t2sq = inv_t2 * inv_t2;
  float dMt[T], dMa[T], dMb[T], r[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float q = a * E[t] + b;
    const float m = minv_of(q);
    r[t] = s[t] - q * m;
    // dM/dt2 = a E te / (t2^2 M);  dM/da = E/(2M);  dM/db = 1/(2M)
    dMt[t] = a * E[t] * (p.te[t] * inv_t2sq) * m;
    dMa[t] = 0.5f * E[t] * m;
    dMb[t] = 0.5f * m;
  }
  const float g_t = VarPro<T>::kCm2 * dot<T>(r, dMt);
  const float ga = VarPro<T>::kCm2 * dot<T>(r, dMa);
  const float gb = VarPro<T>::kCm2 * dot<T>(r, dMb);
  // Gauss-Newton pieces (PSD) for the Schur-reduced curvature
  const float htt = VarPro<T>::kC2 * dot<T>(dMt, dMt);
  const float hta = VarPro<T>::kC2 * dot<T>(dMt, dMa);
  const float htb = VarPro<T>::kC2 * dot<T>(dMt, dMb);
  const float haa = VarPro<T>::kC2 * dot<T>(dMa, dMa);
  const float hab = VarPro<T>::kC2 * dot<T>(dMa, dMb);
  const float hbb = VarPro<T>::kC2 * dot<T>(dMb, dMb);
  const float fa = free_of(a, ga, p.thr[0], p.thr[1]);
  const float fb = free_of(b, gb, p.thr[2], p.thr[3]);
  const float a00 = haa * fa + (1.0f - fa);
  const float a11 = hbb * fb + (1.0f - fb);
  const float a01 = hab * fa * fb;
  const float det = nmax(a00 * a11 - a01 * a01, 1e-30f);
  const float v0 = hta * fa, v1 = htb * fb;
  const float schur = (a11 * v0 * v0 - 2.0f * a01 * v0 * v1 + a00 * v1 * v1) / det;
  const float h_red = nmax(htt - schur, 0.0f);
  const float ft = free_of(t2, g_t, p.thr[4], p.thr[5]);
  float a22 = h_red * ft + (1.0f - ft);
  a22 = a22 + lam * nmax(fabsf(a22), 1e-12f);
  const float p_t = -(g_t * ft) / a22;

  const float t2_new = clip(t2 + p_t, lo_t2, hi_t2);
  float En[T];
  vp.E_at(t2_new, En);
  float a_new = a, b_new = b;
  vp.inner(En, a_new, b_new, 3);
  const float f_new = vp.f_of(En, a_new, b_new);

  const bool accept = f_new <= f;  // false on NaN
  const float rel_red = (f - f_new) / nmax(nmax(fabsf(f), fabsf(f_new)), 1.0f);
  const bool conv_f = accept && (rel_red <= ftol) && (lam <= 1.0f);
  const float dt = t2_new - t2;
  const bool conv_x = dt * dt <= kXtol2 * (1.0f + t2 * t2);
  bool conv_g = false;
  if (gtol > 0.0f) {
    // projected gradient in (k, t2, sigma): df/dk = 2k df/da, df/dsg = 2sg df/db
    const float g_k = 2.0f * sqrtf(a) * ga;
    const float g_s = 2.0f * sqrtf(b) * gb;
    const float pg_k = proj_grad(a, g_k, p.thr[0], p.thr[1]);
    const float pg_t = proj_grad(t2, g_t, p.thr[4], p.thr[5]);
    const float pg_s = proj_grad(b, g_s, p.thr[2], p.thr[3]);
    conv_g = nmax(nmax(fabsf(pg_k), fabsf(pg_t)), fabsf(pg_s)) <= gtol;
  }
  bool newly = (conv_f || conv_x || conv_g || (lam >= 1e6f)) && !conv;
  if (stall_iters > 0) {
    // scipy-ftol-style stop: stall_iters accepted-but-slow steps in a row
    const bool slow_acc = accept && (rel_red <= stall_tol) && !conv;
    const bool real_prog = accept && (rel_red > stall_tol);
    scnt = (conv || real_prog) ? 0.0f : (slow_acc ? scnt + 1.0f : scnt);
    newly = newly || ((scnt >= (float)stall_iters) && !conv);
  }

  if (accept && !conv) {
    a = a_new;
    b = b_new;
    t2 = t2_new;
    f = f_new;
#pragma unroll
    for (int t = 0; t < T; ++t) E[t] = En[t];
    nit += 1.0f;
  }
  if (!conv) lam = clip(accept ? lam * 0.2f : lam * 5.0f, 1e-12f, 1e10f);
  convf = nmax(convf, newly ? 1.0f : 0.0f);
}

// (k, t2, sigma) and (f, convf, n_iter) of a voxel's final state
template <int T>
__device__ __forceinline__ void finish(const GrParams& p, const Outer<T>& o,
                                       float (&x_out)[3], float (&st_out)[3]) {
  x_out[0] = clip(sqrtf(o.a), p.lo[0], p.hi[0]);
  x_out[1] = o.t2;
  x_out[2] = clip(sqrtf(o.b), p.lo[2], p.hi[2]);
  st_out[0] = o.f;
  st_out[1] = o.convf;
  st_out[2] = o.nit;
}

// The whole fit of one voxel in one pass: s[T] in, (k, t2, sigma),
// (f, convf, n_iter) out. full_budget runs every voxel to max_iters.
template <int T>
__device__ __forceinline__ void fit_voxel(const float (&s)[T],
                                          const GrParams& p, int max_iters,
                                          int stall_iters, bool full_budget,
                                          float (&x_out)[3], float (&st_out)[3]) {
  Outer<T> o;
  prelude<T>(s, p, o);
  for (int it = 0; it < max_iters; ++it) {
    const bool conv = o.convf > 0.5f;
    if (conv && !full_budget) break;
    outer_step<T>(s, p, stall_iters, conv, o);
  }
  finish<T>(p, o, x_out, st_out);
}

// The same fit split in two at a resumable boundary. The head: the prelude
// and at most `head_iters` outer iterations; true when the voxel still
// runs, its state to be resumed for the remaining max_iters - head_iters.
template <int T>
__device__ __forceinline__ bool head_voxel(const float (&s)[T], const GrParams& p,
                                           int max_iters, int stall_iters,
                                           int head_iters, Outer<T>& o) {
  prelude<T>(s, p, o);
  const int k = head_iters < max_iters ? head_iters : max_iters;
  for (int it = 0; it < k; ++it) {
    if (o.convf > 0.5f) break;
    outer_step<T>(s, p, stall_iters, false, o);
  }
  return !(o.convf > 0.5f) && k < max_iters;
}

// The tail: one outer iteration of a resumed voxel with `left` (> 0)
// iterations of budget; true when it stopped.
template <int T>
__device__ __forceinline__ bool tail_step(const float (&s)[T], const GrParams& p,
                                          int stall_iters, Outer<T>& o, int& left) {
  outer_step<T>(s, p, stall_iters, false, o);
  return o.convf > 0.5f || --left == 0;
}

// A worklist slot: the voxel's index, then its carried state, one row
// each (convf is 0 in every pushed state, so it is not stored).
template <int T>
constexpr int slot_rows() { return 8 + T; }

template <int T>
__device__ __forceinline__ void save_slot(float* rows, long long cap, long long slot,
                                          int index, const Outer<T>& o) {
  float* r = rows + slot;
  r[0] = index_bits(index);
  r[cap] = o.t2;
  r[2 * cap] = o.a;
  r[3 * cap] = o.b;
  r[4 * cap] = o.f;
  r[5 * cap] = o.lam;
  r[6 * cap] = o.scnt;
  r[7 * cap] = o.nit;
#pragma unroll
  for (int t = 0; t < T; ++t) r[(8 + t) * cap] = o.E[t];
}

template <int T>
__device__ __forceinline__ int load_slot(const float* rows, long long cap, long long slot,
                                         Outer<T>& o) {
  const float* r = rows + slot;
  o.t2 = r[cap];
  o.a = r[2 * cap];
  o.b = r[3 * cap];
  o.f = r[4 * cap];
  o.lam = r[5 * cap];
  o.scnt = r[6 * cap];
  o.nit = r[7 * cap];
#pragma unroll
  for (int t = 0; t < T; ++t) o.E[t] = r[(8 + t) * cap];
  o.convf = 0.0f;
  return index_of(r[0]);
}

}  // namespace

// ---- kernel and C entry

namespace {

// Outer iterations of the head kernel. Measured at 256^3 x 3 TEs on an
// H100 (chip_smoke.warp_profile): after one iteration 12.5% of the voxels
// still run at the bench's tolerances (ftol = gtol = 1e-2) and 98% at the
// pipeline's (ftol 1e-9, gtol 0). One keeps the whole grid's second
// iteration (a warp with a straggler pays it in full) out of the head at
// the bench's tolerances, where the tail is short.
constexpr int kHeadIters = 1;

template <int T>
__device__ __forceinline__ void write_result(const GrParams& p, const Outer<T>& o, long long n,
                                             long long i, float* x_out, float* st_out) {
  float x[3], st[3];
  finish<T>(p, o, x, st);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[c * n + i] = x[c];
    st_out[c * n + i] = st[c];
  }
}

// full_budget (a measurement instrument): every voxel in one pass.
template <int T>
__global__ void __launch_bounds__(kThreads)
gr_varpro_single_kernel(const float* __restrict__ signal, long long n,
                        const GrParams p, int max_iters, int stall_iters,
                        const RowBound bound, float* __restrict__ x_out,
                        float* __restrict__ st_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (i >= live_rows(bound, n)) {
    write_unfitted3(n, i, x_out, st_out);
    return;
  }
  float s[T];
  load_signal<T>(signal, i, s);
  float x[3], st[3];
  fit_voxel<T>(s, p, max_iters, stall_iters, true, x, st);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[c * n + i] = x[c];
    st_out[c * n + i] = st[c];
  }
}

// The head: one thread per voxel; a voxel that stopped writes its
// results, one still running pushes its state to the worklist. Rows past
// the live bound are written unfitted; a block wholly past it returns.
template <int T>
__global__ void __launch_bounds__(kThreads)
gr_varpro_head_kernel(const float* __restrict__ signal, long long n,
                      const GrParams p, int max_iters, int stall_iters,
                      const RowBound bound, float* __restrict__ x_out,
                      float* __restrict__ st_out, float* __restrict__ rows, int* counters) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long live = live_rows(bound, n);
  if (i >= live && i < n) write_unfitted3(n, i, x_out, st_out);
  if ((long long)blockIdx.x * kThreads >= live) return;  // the whole block
  Outer<T> o;
  bool runs = false;
  if (i < live) {
    float s[T];
    load_signal<T>(signal, i, s);
    runs = head_voxel<T>(s, p, max_iters, stall_iters, kHeadIters, o);
    if (!runs) write_result<T>(p, o, n, i, x_out, st_out);
  }
  const int slot = push_slot<kThreads>(runs, counters);  // every thread of the block
  if (runs) save_slot<T>(rows, n, slot, (int)i, o);
}

// One lane's voxel in the tail (ft2::drain's job).
template <int T>
struct TailJob {
  const float* signal;
  const GrParams& p;
  const float* rows;
  long long n;
  int budget, stall_iters;
  float* x_out;
  float* st_out;
  float s[T];
  Outer<T> o;
  int index, left;

  __device__ __forceinline__ void load(int slot) {
    index = load_slot<T>(rows, n, slot, o);
    load_signal<T>(signal, index, s);
    left = budget;
  }
  __device__ __forceinline__ bool step() { return tail_step<T>(s, p, stall_iters, o, left); }
  __device__ __forceinline__ void store() { write_result<T>(p, o, n, index, x_out, st_out); }
};

// The tail: a persistent grid drains the worklist, each lane refilled as
// its voxel stops. The pushed count stays on the device.
template <int T>
__global__ void __launch_bounds__(kThreads)
gr_varpro_tail_kernel(const float* __restrict__ signal, long long n,
                      const GrParams p, int max_iters, int stall_iters,
                      float* __restrict__ x_out, float* __restrict__ st_out,
                      const float* __restrict__ rows, int* counters) {
  TailJob<T> job{signal, p, rows, n, max_iters - kHeadIters, stall_iters, x_out, st_out};
  drain(job, counters);
}

template <int T>
int launch(const float* signal, long long n, const GrParams& p, int max_iters,
           int stall_iters, bool full_budget, const RowBound& bound, float* x, float* st,
           float* rows, int* counters, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (full_budget) {
    gr_varpro_single_kernel<T><<<blocks, kThreads, 0, stream>>>(
        signal, n, p, max_iters, stall_iters, bound, x, st);
    return (int)cudaGetLastError();
  }
  gr_varpro_head_kernel<T><<<blocks, kThreads, 0, stream>>>(
      signal, n, p, max_iters, stall_iters, bound, x, st, rows, counters);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gr_varpro_tail_kernel<T><<<persistent_blocks(gr_varpro_tail_kernel<T>, kThreads),
                             kThreads, 0, stream>>>(
      signal, n, p, max_iters, stall_iters, x, st, rows, counters);
  return (int)cudaGetLastError();
}

__global__ void rsqrt_probe_kernel(const float* __restrict__ in, long long n,
                                   float* __restrict__ out_rsqrtf,
                                   float* __restrict__ out_div) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out_rsqrtf[i] = rsqrtf(in[i]);
  out_div[i] = 1.0f / sqrtf(in[i]);
}

}  // namespace

extern "C" int ft2_gr_params_floats() { return kParamFloats; }

// Outer iterations the head kernel runs before the tail takes over.
extern "C" int ft2_gr_head_iters() { return kHeadIters; }

// Floats of worklist per voxel at n_te echoes (the wrapper allocates
// n_te-dependent rows of n floats).
extern "C" int ft2_gr_slot_rows(int n_te) {
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
// host floats (GrParams). x_out, st_out: (3, n) device arrays, rows
// (k, t2, sigma) and (f, converged 0/1, n_iter). rows: ft2_gr_slot_rows(n_te)
// x n device floats of worklist; counters: 2 device ints, zeroed here on
// `stream`. live_blocks: a device int, the count of leading `block`-row
// blocks to fit (rows past count * block are written unfitted: all 0), or
// null for every row. Unless full_budget, two kernels run, the head and the
// tail; returns cudaGetLastError() after the first launch that failed or
// the last one (0 = launched).
extern "C" int ft2_gr_varpro_fit(const float* signal, long long n, int n_te,
                                 const float* params, int max_iters,
                                 int stall_iters, int full_budget,
                                 float* x_out, float* st_out, float* rows,
                                 int* counters, const int* live_blocks, int block,
                                 void* stream) {
  GrParams p;
  std::memcpy(&p, params, sizeof(p));
  if (n <= 0 || n > kMaxWorklist || (live_blocks != nullptr && block < 1))
    return (int)cudaErrorInvalidValue;
  if (!full_budget && (rows == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!full_budget) {  // the worklist's counters start at zero
    const cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  const bool fb = full_budget != 0;
  const RowBound b{live_blocks, block};
  switch (n_te) {
    case 2: return launch<2>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 3: return launch<3>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 4: return launch<4>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 5: return launch<5>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 6: return launch<6>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 7: return launch<7>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    case 8: return launch<8>(signal, n, p, max_iters, stall_iters, fb, b, x_out, st_out, rows, counters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Both candidate reciprocal square roots of ``in`` (n device floats), so a
// caller can hold them against torch.rsqrt on the same card.
extern "C" int ft2_rsqrt_probe(const float* in, long long n, float* out_rsqrtf,
                               float* out_div, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  rsqrt_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, n, out_rsqrtf, out_div);
  return (int)cudaGetLastError();
}
