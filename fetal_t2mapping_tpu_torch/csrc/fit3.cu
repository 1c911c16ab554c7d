// 3-parameter voxel fits (gaussian_rician, rician) by a 3-start damped
// projected Newton, one thread per (voxel, start), for Hopper (sm_90a).
//
// Replaces two TPU kernels of fetal_t2mapping_tpu/models/pallas_fit.py:
// - ft2_fit3_multistart: _kernel3_body (launcher _fit3_tiles, loop
//   _newton3, solve _masked_solve3) and the per-voxel argmin over starts
//   that _fit3_tiles ran after it. Starts: the log-linear estimate with an
//   RMS-residual sigma, the 12-point T2 grid scan, and the clipped
//   protocol guess — or, for gaussian_rician at T = 3, the exact
//   interpolant (16 bisections). Each runs the Newton loop in (k, T2,
//   sigma): full Hessian of the model's objective (models/fgh.py), a KKT
//   active set, Marquardt damping, a closed-form 3x3 adjugate solve. The
//   block keeps the start with the lowest objective (the first minimum,
//   and the first NaN, as jnp.argmin).
// - ft2_fit3_cont: _kernel3_cont_body, which resumes the winner of a short
//   multistart prefix for the rest of the budget from (x0, convf0, nit0).
//   It stays a second launch: lambda and the stall counter restart at the
//   boundary and f0 is re-evaluated at the clipped x0, so one fused loop
//   would give other results.
// Stops on ftol (lambda <= 1), xtol, gtol, lambda >= 1e6, or 3 slow
// accepted steps in a row (stall_tol = max(ftol, 1e-6)).
//
// What bounds it: instruction issue. A voxel reads T floats (plus 6 for
// the continuation) and writes 24 bytes, once; each Newton iteration
// evaluates the model's f/g/H from the carried exponentials (rician: the
// Bessel pair, a log and an exp per echo) and the candidate's objective
// (T expf, and T logf + Bessel for rician), all in IEEE division, sqrtf,
// expf and logf, with most warps running both sides of the Bessel knee.
// So the kernel does no arithmetic beyond the plain version's:
// - the multistart runs one thread per (voxel, start): a block is three
//   warps over 32 voxels, warp w running start w (so a warp never diverges
//   on the kind of start), and the lowest-objective start is picked in
//   shared memory after the block's barrier, in jnp.argmin's order;
// - the continuation is two kernels: a warp issues until its slowest lane
//   stops, and after the prefix most voxels have converged while the few
//   that have not are scattered (4% at 256^3 x 3 TEs under the bench's
//   tolerances), so one thread per voxel held nearly every warp for a
//   straggler's budget. A sweep, one thread per voxel, enters every
//   voxel's loop (the objective at x0: the same work on every lane),
//   writes the voxels that enter converged and pushes the entered state of
//   the others (x, f, convf, nit) into a worklist; a persistent tail resumes them, each lane
//   taking the next voxel as soon as its own stops (fit_common.cuh);
// - T and the model are template parameters so the echo loops unroll, each
//   thread stops when its own start converged (a converged voxel is frozen,
//   so results equal the TPU kernel's block-wide loop and do not depend on
//   which lane runs a voxel), the per-voxel log of the signal and the
//   per-evaluation log of sigma^2 are computed once, not per echo, and the
//   gradient pass takes i0e and i1e of one argument in one branch.
// On the H100 the three starts spread over three threads ran about as fast
// as the three in one thread: more warps in flight do not help a kernel
// bound by issue; doing less does. Given a row list (fit_common.cuh's
// RowList: the block layout's kept masked voxels, which its gather lists),
// the multistart and the sweep run densely over the list: a multistart
// block takes 32 consecutive entries and a sweep thread one, so the filler
// rows between masked voxels, and the slots past the touched blocks, take
// no lane; blocks past the list's count exit at once, the tail drains only
// what the sweep pushed, and a row not listed comes back unfitted (the
// multistart's entry zeroes its outputs first; the continuation's zeroes
// them too, unless it runs in place over the multistart's, whose rows not
// listed are zero already).
//
// Numerics follow fused_fit._fit3_plain / _fit3_cont_plain and models/fgh.py
// op for op: left-to-right echo sums, the grid and bracket constants
// precomputed in float64 and rounded (Fit3Params), expf/logf, IEEE
// division and square root, NaN-keeping clips, and -fmad=false.
//
// Everything above the "kernel and C entry" marker is per-thread code that
// also compiles as host C++ (tests/test_torch_fit3_host.py runs it there:
// one voxel's three starts in turn, and the continuation's sweep, worklist
// and tail, against the plain versions).

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "fit_common.cuh"

namespace {

using namespace ft2;

constexpr int kStallIters = 3;

// Field order is mirrored by fused_fit._FIT3_FIELDS.
struct Fit3Params {
  float lo[3], hi[3];            // (k, t2, sigma) box
  float lo_thr[3], hi_thr[3];    // pinned-bound thresholds: lo + tol, hi - tol
  float fb[3];                   // clipped protocol guess (third start / fallback)
  float tols[3];                 // ftol, gtol, stall_tol
  float te[kMaxTE];
  float m2te[kMaxTE];            // -2 te
  float grid_t2[kGrid];
  float grid_ee[kGrid];          // sum_t grid_e^2
  float grid_e[kGrid][kMaxTE];   // exp(-te/grid_t2)
  float it_ts[kInterp], it_d12[kInterp], it_d01[kInterp];
};
constexpr int kParamFloats = 18 + 2 * kMaxTE + kGrid * (2 + kMaxTE) + 3 * kInterp;
static_assert(sizeof(Fit3Params) == kParamFloats * sizeof(float),
              "Fit3Params must be a packed float array");

// ---- the objectives (models/fgh.py)

// A&S 9.8.1-9.8.4, coefficients as float64 values rounded once
__device__ __forceinline__ float poly_i0_small(float z) {
  float acc = (float)0.0045813;
  acc = acc * z + (float)0.0360768;
  acc = acc * z + (float)0.2659732;
  acc = acc * z + (float)1.2067492;
  acc = acc * z + (float)3.0899424;
  acc = acc * z + (float)3.5156229;
  return acc * z + 1.0f;
}
__device__ __forceinline__ float poly_i0_large(float z) {
  float acc = (float)0.00392377;
  acc = acc * z + (float)-0.01647633;
  acc = acc * z + (float)0.02635537;
  acc = acc * z + (float)-0.02057706;
  acc = acc * z + (float)0.00916281;
  acc = acc * z + (float)-0.00157565;
  acc = acc * z + (float)0.00225319;
  acc = acc * z + (float)0.01328592;
  return acc * z + (float)0.39894228;
}
__device__ __forceinline__ float poly_i1_small(float z) {
  float acc = (float)0.00032411;
  acc = acc * z + (float)0.00301532;
  acc = acc * z + (float)0.02658733;
  acc = acc * z + (float)0.15084934;
  acc = acc * z + (float)0.51498869;
  acc = acc * z + (float)0.87890594;
  return acc * z + 0.5f;
}
__device__ __forceinline__ float poly_i1_large(float z) {
  float acc = (float)-0.00420059;
  acc = acc * z + (float)0.01787654;
  acc = acc * z + (float)-0.02895312;
  acc = acc * z + (float)0.02282967;
  acc = acc * z + (float)-0.01031555;
  acc = acc * z + (float)0.00163801;
  acc = acc * z + (float)-0.00362018;
  acc = acc * z + (float)-0.03988024;
  return acc * z + (float)0.39894228;
}

// exp(-|x|) I0(x); the branch not taken is the one jnp.where / torch.where
// discards
__device__ __forceinline__ float i0e(float x) {
  x = fabsf(x);
  if (x < 3.75f) {
    const float z = x / 3.75f;
    return poly_i0_small(z * z) * expf(-x);
  }
  const float xm = nmax(x, 3.75f);
  return poly_i0_large(3.75f / xm) / sqrtf(xm);
}

// exp(-|x|) I0(x) and exp(-|x|) I1(|x|) at once, for the gradient pass
// (fgh.i0e, fgh.i1e): the two share |x|, the branch, and x/3.75 and
// exp(-x) or 3.75/x and sqrt(x), each computed once — the same ops on the
// same operands as computing the two apart, so the same bits.
__device__ __forceinline__ void i0e_i1e(float x, float& i0, float& i1) {
  x = fabsf(x);
  if (x < 3.75f) {
    const float z = x / 3.75f;
    const float zz = z * z;
    const float ex = expf(-x);
    i0 = poly_i0_small(zz) * ex;
    i1 = poly_i1_small(zz) * x * ex;
  } else {
    const float xm = nmax(x, 3.75f);
    const float r = 3.75f / xm;
    const float sq = sqrtf(xm);
    i0 = poly_i0_large(r) / sq;
    i1 = poly_i1_large(r) / sq;
  }
}

struct GaussRician {
  // per-voxel invariants of value_e: none
  template <int T>
  __device__ __forceinline__ static void prepare(const float (&)[T], float (&)[T]) {}

  // (objective, exp(-te/t2) per echo) — gaussian_rician_value_e
  template <int T>
  __device__ __forceinline__ static float value_e(const float (&x)[3],
                                                  const float (&s)[T],
                                                  const float (&)[T],
                                                  const Fit3Params& p,
                                                  float (&e)[T]) {
    const float k = x[0], t2 = x[1], sg = x[2];
    const float u_inv = -1.0f / t2;
    float f = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      e[t] = expf(p.te[t] * u_inv);
      const float a = k * e[t];
      const float r = s[t] - sqrtf(a * a + sg * sg);
      f = f + r * r;
    }
    return f / (float)T;
  }

  // gradient and Hessian at x from the carried exponentials — gaussian_rician_fgh
  template <int T>
  __device__ __forceinline__ static void fgh(const float (&x)[3],
                                             const float (&s)[T],
                                             const Fit3Params& p,
                                             const float (&e)[T], float (&g)[3],
                                             float (&h)[3][3]) {
    constexpr float kC2 = (float)(2.0 * (1.0 / T));
    const float k = x[0], t2 = x[1], sg = x[2];
    const float sg2 = sg * sg;
    const float inv_t2 = 1.0f / t2;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) h[i][j] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float et = e[t];
      const float a = k * et;
      const float u = p.te[t] / (t2 * t2);
      const float a2 = a * a;
      const float q = a2 + sg2;
      const float M = sqrtf(nmax(q, 1e-30f));
      const float r = s[t] - M;
      const float inv_m = 1.0f / M;
      const float qk = 2.0f * k * et * et;
      const float qt = 2.0f * a2 * u;
      const float qs = 2.0f * sg;
      const float dm[3] = {0.5f * qk * inv_m, 0.5f * qt * inv_m, 0.5f * qs * inv_m};
      const float qkk = 2.0f * et * et;
      const float qkt = 4.0f * k * et * et * u;
      const float qtt = 4.0f * a2 * u * (u - inv_t2);
      const float qss = 2.0f;
      const float inv_m3 = inv_m * inv_m * inv_m;
      // d2M = d2q/(2M) - dq_x dq_y/(4 M^3)
      const float mkk = 0.5f * qkk * inv_m - 0.25f * qk * qk * inv_m3;
      const float mkt = 0.5f * qkt * inv_m - 0.25f * qk * qt * inv_m3;
      const float mtt = 0.5f * qtt * inv_m - 0.25f * qt * qt * inv_m3;
      const float mss = 0.5f * qss * inv_m - 0.25f * qs * qs * inv_m3;
      const float mks = 0.0f * inv_m - 0.25f * qk * qs * inv_m3;
      const float mts = 0.0f * inv_m - 0.25f * qt * qs * inv_m3;
      const float d2[3][3] = {{mkk, mkt, mks}, {mkt, mtt, mts}, {mks, mts, mss}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g[i] = g[i] - kC2 * r * dm[i];
#pragma unroll
        for (int j = i; j < 3; ++j)
          h[i][j] = h[i][j] + kC2 * (dm[i] * dm[j] - r * d2[i][j]);
      }
    }
    h[1][0] = h[0][1];
    h[2][0] = h[0][2];
    h[2][1] = h[1][2];
  }
};

struct Rician {
  // per-voxel invariants of value_e: ls[t] = log(max(s[t], 1e-20))
  template <int T>
  __device__ __forceinline__ static void prepare(const float (&s)[T], float (&ls)[T]) {
#pragma unroll
    for (int t = 0; t < T; ++t) ls[t] = logf(nmax(s[t], 1e-20f));
  }

  // (negative log-likelihood, exp(-te/t2) per echo) — rician_value_e. The
  // two invariant logs are hoisted (same op on the same operand: the same
  // bits as computing them per echo).
  template <int T>
  __device__ __forceinline__ static float value_e(const float (&x)[3],
                                                  const float (&s)[T],
                                                  const float (&ls)[T],
                                                  const Fit3Params& p,
                                                  float (&e)[T]) {
    const float k = x[0], t2 = x[1], sg = x[2];
    const float u_inv = -1.0f / t2;
    const float sg2 = sg * sg;
    const float log_sg2 = logf(sg2);
    float f = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      e[t] = expf(p.te[t] * u_inv);
      const float m = k * e[t];
      const float xb = m * s[t] / sg2;
      const float d_sm = fabsf(s[t]) - fabsf(m);
      const float L = ls[t] - log_sg2
                      - d_sm * d_sm * 0.5f / sg2
                      + logf(nmax(i0e(xb), 1e-30f));
      f = f - L;
    }
    return f;
  }

  // gradient and Hessian at x from the carried exponentials — rician_fgh
  template <int T>
  __device__ __forceinline__ static void fgh(const float (&x)[3],
                                             const float (&s)[T],
                                             const Fit3Params& p,
                                             const float (&e)[T], float (&g)[3],
                                             float (&h)[3][3]) {
    const float k = x[0], t2 = x[1], sg = x[2];
    const float sg2 = sg * sg;
    const float inv_s2 = 1.0f / sg2;
    const float inv_s3 = inv_s2 / sg;
    const float two_t2 = 2.0f / t2;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) h[i][j] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float et = e[t], st = s[t];
      const float m = k * et;
      const float u = p.te[t] / (t2 * t2);
      const float xb = m * st * inv_s2;
      float i0, i1;
      i0e_i1e(xb, i0, i1);
      const float R = i1 / nmax(i0, 1e-30f);
      // R/x -> 1/2 as x -> 0: the series below the fp32 knee
      const float r_over_x = (xb > 1e-4f) ? R / nmax(xb, 1e-30f)
                                          : 0.5f - xb * xb / 16.0f;
      const float Rp = 1.0f - r_over_x - R * R;
      const float core = (-m + R * st) * inv_s2;
      const float n_ = -2.0f * sg2 + st * st + m * m - 2.0f * R * m * st;
      g[0] = g[0] - et * core;
      g[1] = g[1] - m * u * core;
      g[2] = g[2] - n_ * inv_s3;
      const float W = Rp * st * st * inv_s2 - 1.0f;
      const float mw_rs = m * W + R * st;
      const float hkk = et * et * inv_s2 * W;
      const float hkt = et * u * (core * sg2 + m * W) * inv_s2;
      const float htt = m * u * (u - two_t2) * core + m * m * u * u * inv_s2 * W;
      const float hks = -2.0f * et * inv_s3 * mw_rs;
      const float hts = -2.0f * m * u * inv_s3 * mw_rs;
      const float dN = -4.0f * sg + 4.0f * Rp * m * m * st * st * inv_s3;
      const float hss = dN * inv_s3 - 3.0f * n_ * inv_s3 / sg;
      h[0][0] = h[0][0] - hkk;
      h[0][1] = h[0][1] - hkt;
      h[1][1] = h[1][1] - htt;
      h[0][2] = h[0][2] - hks;
      h[1][2] = h[1][2] - hts;
      h[2][2] = h[2][2] - hss;
    }
    h[1][0] = h[0][1];
    h[2][0] = h[0][2];
    h[2][1] = h[1][2];
  }
};

// Damped reduced 3x3 Newton solve (_masked_solve3): pinned coordinates get
// identity rows/columns; Marquardt damping scales each diagonal by 1 + lam.
__device__ __forceinline__ void masked_solve3(const float (&h)[3][3],
                                              const float (&g)[3],
                                              const float (&fm)[3], float lam,
                                              float (&p)[3]) {
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = h[i][j] * fm[i] * fm[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i][i] = a[i][i] + (1.0f - fm[i]);
    a[i][i] = a[i][i] + lam * nmax(fabsf(a[i][i]), 1e-12f);
  }
  const float b0 = g[0] * fm[0], b1 = g[1] * fm[1], b2 = g[2] * fm[2];
  const float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  det = (fabsf(det) < 1e-30f) ? 1e-30f : det;
  const float c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  const float c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  const float c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  const float c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  const float c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float inv_det = 1.0f / det;
  p[0] = -(c00 * b0 + c10 * b1 + c20 * b2) * inv_det * fm[0];
  p[1] = -(c01 * b0 + c11 * b1 + c21 * b2) * inv_det * fm[1];
  p[2] = -(c02 * b0 + c12 * b1 + c22 * b2) * inv_det * fm[2];
}

// The Newton loop's carried state for one start.
template <int T>
struct Newton {
  float x[3], f, lam, scnt, convf, nit;
  float e[T];  // exp(-te/t2) at x
};

// lam and the stall counter as every run of the loop starts them
template <int T>
__device__ __forceinline__ void newton3_restart(Newton<T>& st) {
  st.lam = 1e-3f;
  st.scnt = 0.0f;
}

// Enter the loop (_newton3's prologue): x clipped into the box, f and e
// evaluated there, lam and the stall counter restarted; convf and nit are
// the caller's (0 for a fresh start).
template <class Model, int T>
__device__ __forceinline__ void newton3_begin(const float (&s)[T], const float (&ls)[T],
                                              const Fit3Params& p, Newton<T>& st) {
#pragma unroll
  for (int i = 0; i < 3; ++i) st.x[i] = clip(st.x[i], p.lo[i], p.hi[i]);
  st.f = Model::template value_e<T>(st.x, s, ls, p, st.e);
  newton3_restart(st);
}

// One iteration of a start that has not converged (convf <= 0.5 or NaN;
// _newton3's loop body, whose terms for a frozen voxel drop out).
template <class Model, int T>
__device__ __forceinline__ void newton3_step(const float (&s)[T], const float (&ls)[T],
                                             const Fit3Params& p, Newton<T>& st) {
  constexpr float kXtol2 = (float)(1e-6 * 1e-6);
  const float ftol = p.tols[0], gtol = p.tols[1], stall_tol = p.tols[2];
  float (&x)[3] = st.x;
  float &f = st.f, &lam = st.lam, &scnt = st.scnt, &convf = st.convf;
  float g[3], h[3][3], fm[3], step[3], xn[3], en[T];
  Model::template fgh<T>(x, s, p, st.e, g, h);
#pragma unroll
  for (int i = 0; i < 3; ++i) fm[i] = free_of(x[i], g[i], p.lo_thr[i], p.hi_thr[i]);
  masked_solve3(h, g, fm, lam, step);
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[i] = clip(x[i] + step[i], p.lo[i], p.hi[i]);
  const float f_new = Model::template value_e<T>(xn, s, ls, p, en);

  const bool accept = f_new <= f;  // false on NaN
  const float rel_red = (f - f_new) / nmax(nmax(fabsf(f), fabsf(f_new)), 1.0f);
  const bool conv_f = accept && (rel_red <= ftol) && (lam <= 1.0f);
  const float d0 = xn[0] - x[0], d1 = xn[1] - x[1], d2 = xn[2] - x[2];
  const float step_sq = d0 * d0 + d1 * d1 + d2 * d2;
  const float x_sq = 1.0f + (x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  const bool conv_x = step_sq <= kXtol2 * x_sq;
  bool conv_g = false;
  if (gtol > 0.0f) {
    const float pg0 = proj_grad(x[0], g[0], p.lo_thr[0], p.hi_thr[0]);
    const float pg1 = proj_grad(x[1], g[1], p.lo_thr[1], p.hi_thr[1]);
    const float pg2 = proj_grad(x[2], g[2], p.lo_thr[2], p.hi_thr[2]);
    conv_g = nmax(nmax(fabsf(pg0), fabsf(pg1)), fabsf(pg2)) <= gtol;
  }
  bool newly = conv_f || conv_x || conv_g || (lam >= 1e6f);
  // scipy-ftol-style stop: kStallIters accepted-but-slow steps in a row
  const bool slow_acc = accept && (rel_red <= stall_tol);
  const bool real_prog = accept && (rel_red > stall_tol);
  scnt = real_prog ? 0.0f : (slow_acc ? scnt + 1.0f : scnt);
  newly = newly || (scnt >= (float)kStallIters);

  if (accept) {
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = xn[i];
    f = f_new;
#pragma unroll
    for (int t = 0; t < T; ++t) st.e[t] = en[t];
    st.nit += 1.0f;
  }
  lam = clip(accept ? lam * 0.2f : lam * 5.0f, 1e-12f, 1e10f);
  convf = nmax(convf, newly ? 1.0f : 0.0f);
}

// Bounded damped-Newton loop for one start (_newton3). st.x enters as the
// start (clipped here) and leaves as the last accepted iterate; st.convf
// and st.nit enter as the resumed state (0 for a fresh start).
template <class Model, int T>
__device__ __forceinline__ void newton3(const float (&s)[T], const float (&ls)[T],
                                        const Fit3Params& p, int max_iters,
                                        Newton<T>& st) {
  newton3_begin<Model, T>(s, ls, p, st);
  for (int it = 0; it < max_iters; ++it) {
    if (st.convf > 0.5f) break;
    newton3_step<Model, T>(s, ls, p, st);
  }
}

// log-linear (k, t2) + RMS-residual sigma (_loglin_start3)
template <int T>
__device__ __forceinline__ void loglin_start3(const float (&s)[T],
                                              const Fit3Params& p,
                                              float (&x)[3]) {
  float k, t2;
  loglin<T>(s, p.te, k, t2);
  const float t2c = clip(t2, p.lo[1], p.hi[1]);
  const float u_inv = -1.0f / t2c;
  const float kc = clip(k, p.lo[0], p.hi[0]);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float d = s[t] - kc * expf(p.te[t] * u_inv);
    acc = (t == 0) ? d * d : acc + d * d;
  }
  const float sg = sqrtf(acc / (float)T + 1e-12f);
  x[0] = kc;
  x[1] = t2c;
  x[2] = clip(sg, p.lo[2], p.hi[2]);
}

// 12-point T2 grid-scan basin selection (_grid_start3)
template <int T>
__device__ __forceinline__ void grid_start3(const float (&s)[T],
                                            const Fit3Params& p,
                                            float (&x)[3]) {
  float best_sse = 0.f, best_k = 0.f, best_t2 = 0.f;
#pragma unroll
  for (int g = 0; g < kGrid; ++g) {
    const float* e = p.grid_e[g];
    const float kg = clip(dot<T>(s, e) / p.grid_ee[g], p.lo[0], p.hi[0]);
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float d = s[t] - kg * e[t];
      acc = (t == 0) ? d * d : acc + d * d;
    }
    const float sse = acc / (float)T;
    if (g == 0) {
      best_sse = sse;
      best_k = kg;
      best_t2 = p.grid_t2[g];
    } else {
      if (sse < best_sse) {
        best_k = kg;
        best_t2 = p.grid_t2[g];
      }
      best_sse = nmin(sse, best_sse);
    }
  }
  x[0] = best_k;
  x[1] = clip(best_t2, p.lo[1], p.hi[1]);
  x[2] = clip(sqrtf(best_sse + 1e-12f), p.lo[2], p.hi[2]);
}

// Start `start` of one voxel's multistart (0 log-linear, 1 grid, 2 the
// interpolant or the protocol guess), run to the end of its Newton loop:
// out = (k, t2, sigma, f, convf, nit).
template <class Model, int T>
__device__ __forceinline__ void run_start(const float (&s)[T], const float (&ls)[T],
                                          const Fit3Params& p, int max_iters, int start,
                                          float (&out)[6]) {
  constexpr bool kInterpStart = std::is_same<Model, GaussRician>::value && T == 3;
  Newton<T> st;
  float (&x)[3] = st.x;
  if (start == 0) {
    loglin_start3<T>(s, p, x);
  } else if (start == 1) {
    grid_start3<T>(s, p, x);
  } else {
    if constexpr (kInterpStart) {
      interp_start_gr(s, p.it_ts, p.it_d12, p.it_d01, p.m2te, p.lo, p.hi, p.fb,
                      16, x[0], x[1], x[2]);
    } else {
      x[0] = p.fb[0];
      x[1] = p.fb[1];
      x[2] = p.fb[2];
    }
  }
  st.convf = 0.0f;
  st.nit = 0.0f;
  newton3<Model, T>(s, ls, p, max_iters, st);
  out[0] = x[0];
  out[1] = x[1];
  out[2] = x[2];
  out[3] = st.f;
  out[4] = st.convf;
  out[5] = st.nit;
}

// The winning start of three final objectives, as jnp.argmin: the first
// minimum; a NaN wins and is never replaced.
__device__ __forceinline__ int argmin_start(float f0, float f1, float f2) {
  int best = 0;
  float best_f = f0;
  if (best_f == best_f && (f1 != f1 || f1 < best_f)) {
    best = 1;
    best_f = f1;
  }
  if (best_f == best_f && (f2 != f2 || f2 < best_f)) best = 2;
  return best;
}

// The continuation split after its entry. Every voxel enters the loop
// (newton3_begin at its x0, convf0, nit0); one that enters converged, or
// with no budget, is done (newton3 with no iteration), every other one is
// pushed to a worklist with its entered state and resumed: cont_step until
// it stops.
__device__ __forceinline__ bool cont_runs(float convf0, int max_iters) {
  return !(convf0 > 0.5f) && max_iters > 0;
}

// One resumed iteration with `left` (> 0) iterations of budget; true when
// the voxel stopped.
template <class Model, int T>
__device__ __forceinline__ bool cont_step(const float (&s)[T], const float (&ls)[T],
                                          const Fit3Params& p, Newton<T>& st, int& left) {
  newton3_step<Model, T>(s, ls, p, st);
  return st.convf > 0.5f || --left == 0;
}

// exp(-te/t2) per echo, by the ops value_e takes (so the same bits)
template <int T>
__device__ __forceinline__ void exps_at(float t2, const Fit3Params& p, float (&e)[T]) {
  const float u_inv = -1.0f / t2;
#pragma unroll
  for (int t = 0; t < T; ++t) e[t] = expf(p.te[t] * u_inv);
}

// A continuation worklist slot: the voxel's index, then its entered state
// (x, f, convf, nit), one row each. lam and the stall counter are the
// restart's, and e is recomputed from t2 on resuming rather than carried,
// which keeps the sweep in 32 registers without a spill at any T.
constexpr int kContRows = 7;

template <int T>
__device__ __forceinline__ void save_cont_slot(float* rows, long long cap, long long slot,
                                               int index, const Newton<T>& st) {
  float* r = rows + slot;
  r[0] = index_bits(index);
#pragma unroll
  for (int c = 0; c < 3; ++c) r[(1 + c) * cap] = st.x[c];
  r[4 * cap] = st.f;
  r[5 * cap] = st.convf;
  r[6 * cap] = st.nit;
}

template <int T>
__device__ __forceinline__ int load_cont_slot(const float* rows, long long cap, long long slot,
                                              const Fit3Params& p, Newton<T>& st) {
  const float* r = rows + slot;
#pragma unroll
  for (int c = 0; c < 3; ++c) st.x[c] = r[(1 + c) * cap];
  st.f = r[4 * cap];
  st.convf = r[5 * cap];
  st.nit = r[6 * cap];
  exps_at<T>(st.x[1], p, st.e);
  newton3_restart(st);
  return index_of(r[0]);
}

}  // namespace

// ---- kernel and C entry

namespace {

constexpr int kVoxPerBlock = 32;                  // one warp of voxels
constexpr int kStartThreads = 3 * kVoxPerBlock;   // warp w runs start w
// One thread per (voxel, start); the block's three warps share 32 voxels.
// Blocks per SM asked of ptxas, from its register counts (48-56 at T = 3,
// up to 72 at T = 8 rician, no spills): 12 blocks (at most 56 registers)
// at T <= 3, 9 blocks (at most 72) to T = 7 and 8 (at most 80) at T = 8,
// so no instance spills (rician at T = 4 spilled 4 bytes under 12, and at
// T = 8 12 bytes under 9 once the kernel took a row list). A uniform 9 let
// ptxas take more registers at T = 3 and ran slower on the H100.
template <class Model, int T>
__global__ void __launch_bounds__(kStartThreads, (T <= 3 ? 12 : T < 8 ? 9 : 8))
fit3_multistart_kernel(const float* __restrict__ signal, long long n,
                       const Fit3Params p, int max_iters, const RowList list,
                       float* __restrict__ x_out, float* __restrict__ st_out) {
  __shared__ float cand[3][6][kVoxPerBlock];  // [start][output][voxel]
  __shared__ long long row_of[kVoxPerBlock];  // the row voxel v writes, or -1
  const int start = threadIdx.x / kVoxPerBlock;
  const int v = threadIdx.x % kVoxPerBlock;
  const long long j = (long long)blockIdx.x * kVoxPerBlock + v;  // pass row
  const long long m = pass_rows(list, n);
  // past the list's count a block has nothing to write (the entry zeroed it)
  if ((long long)blockIdx.x * kVoxPerBlock >= m) return;
  // the buffer row goes through shared memory, so nothing of the list
  // lives across the fit, which runs at the register limit
  float out[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (j < m) {
    const long long i = pass_row(list, j);
    if (start == 0) row_of[v] = i;
    float s[T], ls[T];
    load_signal<T>(signal, i, s);
    Model::template prepare<T>(s, ls);
    run_start<Model, T>(s, ls, p, max_iters, start, out);
  } else if (start == 0) {
    row_of[v] = -1;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) cand[start][c][v] = out[c];
  __syncthreads();
  if (start == 0) {
    const long long i = row_of[v];
    if (i < 0) return;
    const int w = argmin_start(cand[0][3][v], cand[1][3][v], cand[2][3][v]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x_out[c * n + i] = cand[w][c][v];
      st_out[c * n + i] = cand[w][3 + c][v];
    }
  }
}

template <int T>
__device__ __forceinline__ void write_result(const Newton<T>& st, long long n, long long i,
                                             float* x_out, float* st_out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) x_out[c * n + i] = st.x[c];
  st_out[i] = st.f;
  st_out[n + i] = st.convf;
  st_out[2 * n + i] = st.nit;
}

// The continuation's sweep: one thread per voxel enters the loop (x0
// clipped, f and e evaluated there: the same work on every lane). A voxel
// that enters converged writes its results; every other one pushes its
// entered state to the worklist for the tail. With a list, thread j takes
// listed row j. x0 and st0 may be x_out and st_out (in place): a thread
// reads its row's x0 before it writes that row, and the tail reads none.
template <class Model, int T>
__global__ void __launch_bounds__(kThreads)
fit3_sweep_kernel(const float* __restrict__ signal, long long n, const Fit3Params p,
                  int max_iters, const RowList list, const float* x0, const float* st0,
                  float* x_out, float* st_out, float* __restrict__ rows, int* counters) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;  // pass row
  const long long m = pass_rows(list, n);
  if ((long long)blockIdx.x * kThreads >= m) return;  // the whole block
  Newton<T> st;
  bool runs = false;
  long long i = 0;
  if (j < m) {
    i = pass_row(list, j);
    float s[T], ls[T];
    load_signal<T>(signal, i, s);
    Model::template prepare<T>(s, ls);
#pragma unroll
    for (int c = 0; c < 3; ++c) st.x[c] = x0[c * n + i];
    st.convf = st0[n + i];
    st.nit = st0[2 * n + i];
    newton3_begin<Model, T>(s, ls, p, st);
    runs = cont_runs(st.convf, max_iters);
    if (!runs) write_result<T>(st, n, i, x_out, st_out);
  }
  const int slot = push_slot<kThreads>(runs, counters);  // every thread of the block
  if (runs) save_cont_slot<T>(rows, n, slot, (int)i, st);
}

// One lane's voxel in the continuation's tail (ft2::drain's job).
template <class Model, int T>
struct ContJob {
  const float* signal;
  const Fit3Params& p;
  const float* rows;
  long long n;
  int budget;
  float* x_out;
  float* st_out;
  float s[T], ls[T];
  Newton<T> st;
  int index, left;

  __device__ __forceinline__ void load(int slot) {
    index = load_cont_slot<T>(rows, n, slot, p, st);
    load_signal<T>(signal, index, s);
    Model::template prepare<T>(s, ls);
    left = budget;
  }
  __device__ __forceinline__ bool step() { return cont_step<Model, T>(s, ls, p, st, left); }
  __device__ __forceinline__ void store() { write_result<T>(st, n, index, x_out, st_out); }
};

// The continuation's tail: a persistent grid drains the worklist, each
// lane refilled as its voxel stops. The pushed count stays on the device.
template <class Model, int T>
__global__ void __launch_bounds__(kThreads)
fit3_tail_kernel(const float* __restrict__ signal, long long n, const Fit3Params p,
                 int max_iters, float* __restrict__ x_out, float* __restrict__ st_out,
                 const float* __restrict__ rows, int* counters) {
  ContJob<Model, T> job{signal, p, rows, n, max_iters, x_out, st_out};
  drain(job, counters);
}

template <class Model, int T>
int launch_t(const float* signal, long long n, const Fit3Params& p, int max_iters,
             const RowList& list, const float* x0, const float* st0,
             float* x, float* st, float* rows, int* counters, cudaStream_t stream) {
  if (x0 == nullptr) {
    const unsigned blocks = (unsigned)((n + kVoxPerBlock - 1) / kVoxPerBlock);
    fit3_multistart_kernel<Model, T><<<blocks, kStartThreads, 0, stream>>>(
        signal, n, p, max_iters, list, x, st);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fit3_sweep_kernel<Model, T><<<blocks, kThreads, 0, stream>>>(
      signal, n, p, max_iters, list, x0, st0, x, st, rows, counters);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fit3_tail_kernel<Model, T><<<persistent_blocks(fit3_tail_kernel<Model, T>, kThreads),
                               kThreads, 0, stream>>>(
      signal, n, p, max_iters, x, st, rows, counters);
  return (int)cudaGetLastError();
}

template <class Model>
int launch(const float* signal, long long n, int n_te, const Fit3Params& p,
           int max_iters, const RowList& l, const float* x0, const float* st0, float* x,
           float* st, float* rows, int* counters, cudaStream_t s) {
  switch (n_te) {
    case 2: return launch_t<Model, 2>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 3: return launch_t<Model, 3>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 4: return launch_t<Model, 4>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 5: return launch_t<Model, 5>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 6: return launch_t<Model, 6>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 7: return launch_t<Model, 7>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    case 8: return launch_t<Model, 8>(signal, n, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const float* signal, long long n, int n_te, int model, const float* params,
        int max_iters, const RowList& l, const float* x0, const float* st0, float* x,
        float* st, float* rows, int* counters, cudaStream_t s) {
  Fit3Params p;
  std::memcpy(&p, params, sizeof(p));
  if (n <= 0 || (l.rows != nullptr && l.count == nullptr) || model < 0 || model > 1)
    return (int)cudaErrorInvalidValue;
  // the rows not listed come back unfitted (all 0), or, in place, as the
  // caller's x0 and st0 have them
  if (l.rows != nullptr && x != x0) {
    cudaError_t err = cudaMemsetAsync(x, 0, 3 * n * sizeof(float), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(st, 0, 3 * n * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (model) {  // fused_fit._MODEL_ID
    case 0: return launch<GaussRician>(signal, n, n_te, p, max_iters, l, x0, st0, x, st, rows, counters, s);
    default: return launch<Rician>(signal, n, n_te, p, max_iters, l, x0, st0, x, st, rows, counters, s);
  }
}

}  // namespace

extern "C" int ft2_fit3_params_floats() { return kParamFloats; }

// Floats of the continuation's worklist per voxel (rows of n floats).
extern "C" int ft2_fit3_cont_slot_rows() { return kContRows; }

// signal: (n, n_te) row-major float32 on the device; model: 0
// gaussian_rician, 1 rician; params: kParamFloats host floats (Fit3Params).
// x_out, st_out: (3, n) device arrays, rows (k, t2, sigma) and
// (f, converged 0/1, n_iter). row_list: null for every row, or device
// ints of distinct rows below n, of which the first *row_count (a device
// int) are fitted and every other row is written unfitted (all 0).
// Returns cudaGetLastError() after the launch.
extern "C" int ft2_fit3_multistart(const float* signal, long long n, int n_te,
                                   int model, const float* params,
                                   int max_iters, float* x_out, float* st_out,
                                   const int* row_list, const int* row_count, void* stream) {
  return run(signal, n, n_te, model, params, max_iters, RowList{row_list, row_count},
             nullptr, nullptr, x_out, st_out, nullptr, nullptr,
             static_cast<cudaStream_t>(stream));
}

// As ft2_fit3_multistart, resuming one Newton run per voxel from x0 (3, n)
// with st0 (3, n) = (f, convf, nit) of the multistart prefix's winner; f0
// is re-evaluated at the clipped x0 (x0 and st0 are read at the rows fitted
// only). x_out and st_out may be x0 and st0, both or neither: in place,
// the rows not listed keep x0's and st0's values (the multistart's with
// the same list wrote them unfitted). rows: ft2_fit3_cont_slot_rows() x n
// device floats of worklist; counters: 2 device ints, zeroed here on
// `stream`. Two kernels run, the sweep and the tail; returns
// cudaGetLastError() after the first launch that failed or the last one
// (0 = launched).
extern "C" int ft2_fit3_cont(const float* signal, long long n, int n_te,
                             int model, const float* params, int max_iters,
                             const float* x0, const float* st0, float* x_out,
                             float* st_out, float* rows, int* counters,
                             const int* row_list, const int* row_count, void* stream) {
  if (x0 == nullptr || st0 == nullptr || rows == nullptr || counters == nullptr ||
      n > kMaxWorklist || (x0 == x_out) != (st0 == st_out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =  // the worklist's counters start at zero
      cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return run(signal, n, n_te, model, params, max_iters, RowList{row_list, row_count}, x0,
             st0, x_out, st_out, rows, counters, s);
}
