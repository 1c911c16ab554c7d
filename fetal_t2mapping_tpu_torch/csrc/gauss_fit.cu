// Gaussian voxel T2 fit, one thread per voxel, for Hopper (sm_90a).
//
// Replaces fetal_t2mapping_tpu/models/pallas_fit.py::_gauss_kernel_body
// (launcher _gauss_fit_tiles, init _loglin_tiles): fit S = k*exp(-TE/T2) per
// voxel by a weighted log-linear init, a 12-point static T2 grid scan, then
// the VARPRO loop — k at its clipped closed-form optimum, a 1-D
// Marquardt-damped Newton step in T2 on the Schur-reduced curvature, a KKT
// active set for the bounds — stopping on ftol (lambda <= 1), xtol, gtol,
// lambda >= 1e6, or `stall_iters` slow accepted steps in a row.
//
// What bounds it: arithmetic. A voxel reads T floats and writes 17 bytes,
// once; in between it runs up to max_iters iterations of T expf plus ~20*T
// flops, all on values that fit in registers. So one thread owns one
// voxel's whole state (s[T], e[T], k, T2, f, lambda, stall count, n_iter)
// in registers, T is a template parameter so the echo loops unroll, and
// nothing touches shared or device memory inside the loop. Each thread
// stops as soon as its own voxel converged, where the TPU kernel's
// while_loop ran until every voxel of a 32K-voxel block had; the outputs
// are the same either way, because a converged voxel is frozen.
//
// Numerics follow the reference op for op so that the port agrees with it
// to float32 rounding: sums over echoes run left to right from the first
// echo, the grid-scan constants arrive precomputed in float64 and rounded
// (GaussParams), expf/logf and IEEE division (no fast math), clips that
// propagate NaN as jnp.clip does, and the library is built with
// -fmad=false so no multiply-add is fused behind the reference's back.

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

// The whole fit of one voxel: s[T] in, (k, t2, f, conv, n_iter) out.
template <int T>
__device__ __forceinline__ void fit_voxel(const float (&s)[T],
                                          const GaussParams& p, int max_iters,
                                          int stall_iters, bool no_prior,
                                          bool full_budget, float& k_out,
                                          float& t2_out, float& f_out,
                                          bool& conv_out, float& nit_out) {
  constexpr float kC2 = (float)(2.0 * (1.0 / T));
  constexpr float kCm2 = (float)(-2.0 * (1.0 / T));
  constexpr float kXtol2 = (float)(1e-6 * 1e-6);

  float lo_k = p.lo_k, tol_k = p.tol_k;
  const float hi_k = p.hi_k, lo_t2 = p.lo_t2, hi_t2 = p.hi_t2;
  if (no_prior) {  // echoes are TE-sorted: s[0] is the shortest TE
    lo_k = nmax(s[0], lo_k);
    tol_k = 1e-8f * nmax(hi_k - lo_k, 1.0f);
  }
  const float k_lo_thr = lo_k + tol_k, k_hi_thr = hi_k - tol_k;

  // weighted log-linear init (pallas_fit._loglin_tiles)
  float k, t2;
  loglin<T>(s, p.te, k, t2);
  k = clip(k, lo_k, hi_k);
  t2 = clip(t2, lo_t2, hi_t2);
  float e[T];
  exps_at<T>(p, t2, e);
  float f = sse<T>(s, k, e);

  // T2 grid scan: basin selection on the static candidates
#pragma unroll
  for (int g = 0; g < kGrid; ++g) {
    float eg[T];
#pragma unroll
    for (int t = 0; t < T; ++t) eg[t] = p.grid_e[g][t];
    float num = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) num = (t == 0) ? s[t] * eg[t] : num + s[t] * eg[t];
    const float kg = clip(num / p.grid_ee[g], lo_k, hi_k);
    const float fg = sse<T>(s, kg, eg);
    if (fg < f) {
      k = kg;
      t2 = p.grid_t2[g];
      f = fg;
#pragma unroll
      for (int t = 0; t < T; ++t) e[t] = eg[t];
    }
  }

  float lam = 1e-3f, scnt = 0.0f, nit = 0.0f;
  bool conv = false;
  for (int it = 0; it < max_iters; ++it) {
    if (conv && !full_budget) break;
    // e = exp(-te/t2) at the current iterate (carried: T exps per iteration)
    float m[T], r[T], u[T], dm[T];
    const float inv_t2 = 1.0f / t2;
    const float inv_t2sq = inv_t2 * inv_t2;
    float srd = 0.f, sdd = 0.f, see = 0.f, seum = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      m[t] = k * e[t];
      r[t] = s[t] - m[t];
      u[t] = p.te[t] * inv_t2sq;  // d(-te/t2)/dt2
      dm[t] = m[t] * u[t];        // dm/dt2
      const float rd = r[t] * dm[t], dd = dm[t] * dm[t], ee = e[t] * e[t];
      const float eum = e[t] * u[t] * m[t];
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
    const bool free_k = (k > k_lo_thr) && (k < k_hi_thr);
    const float h_red = h_tt - (free_k ? h_kt * h_kt / nmax(h_kk, 1e-30f) : 0.0f);
    h_tt = nmax(h_red, 0.0f);

    // KKT active set: pinned at a bound with outward gradient
    const bool pinned = ((t2 <= p.t2_lo_thr) && (g_t > 0.0f)) ||
                        ((t2 >= p.t2_hi_thr) && (g_t < 0.0f));
    const float ft = pinned ? 0.0f : 1.0f;
    float a22 = h_tt * ft + (1.0f - ft);
    a22 = a22 + lam * nmax(fabsf(a22), 1e-12f);
    const float p_t = -(g_t * ft) / a22;

    const float t2_new = clip(t2 + p_t, lo_t2, hi_t2);
    float en[T];
    exps_at<T>(p, t2_new, en);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      num = (t == 0) ? s[t] * en[t] : num + s[t] * en[t];
      den = (t == 0) ? en[t] * en[t] : den + en[t] * en[t];
    }
    const float k_new = clip(num / nmax(den, 1e-30f), lo_k, hi_k);
    const float f_new = sse<T>(s, k_new, en);

    const bool accept = f_new <= f;  // false on NaN
    const float rel_red =
        (f - f_new) / nmax(nmax(fabsf(f), fabsf(f_new)), 1.0f);
    const bool conv_f = accept && (rel_red <= p.ftol) && (lam <= 1.0f);
    const float dk = k_new - k, dt = t2_new - t2;
    const bool conv_x = dk * dk + dt * dt <= kXtol2 * ((1.0f + k * k) + t2 * t2);
    bool conv_g = false;
    if (p.gtol > 0.0f) {
      float sre = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) sre = (t == 0) ? r[t] * e[t] : sre + r[t] * e[t];
      const float g_k = kCm2 * sre;
      const float pg_k = (k <= k_lo_thr) ? nmin(g_k, 0.0f)
                         : (k >= k_hi_thr) ? nmax(g_k, 0.0f) : g_k;
      const float pg_t = (t2 <= p.t2_lo_thr) ? nmin(g_t, 0.0f)
                         : (t2 >= p.t2_hi_thr) ? nmax(g_t, 0.0f) : g_t;
      conv_g = nmax(fabsf(pg_k), fabsf(pg_t)) <= p.gtol;
    }
    bool newly = (conv_f || conv_x || conv_g || (lam >= 1e6f)) && !conv;
    if (stall_iters > 0) {
      // scipy-ftol-style stop: stall_iters accepted-but-slow steps in a row
      const bool slow_acc = accept && (rel_red <= p.stall_tol) && !conv;
      const bool real_prog = accept && (rel_red > p.stall_tol);
      scnt = (conv || real_prog) ? 0.0f : (slow_acc ? scnt + 1.0f : scnt);
      newly = newly || ((scnt >= (float)stall_iters) && !conv);
    }

    const bool upd = accept && !conv;
    if (upd) {
      k = k_new;
      t2 = t2_new;
      f = f_new;
#pragma unroll
      for (int t = 0; t < T; ++t) e[t] = en[t];
      nit += 1.0f;
    }
    if (!conv) lam = clip(accept ? lam * 0.2f : lam * 5.0f, 1e-12f, 1e10f);
    conv = conv || newly;
  }

  k_out = k;
  t2_out = t2;
  f_out = f;
  conv_out = conv;
  nit_out = nit;
}

// ---- kernel and C entry

template <int T>
__global__ void __launch_bounds__(kThreads)
gauss_fit_kernel(const float* __restrict__ signal, long long n,
                 const GaussParams p, int max_iters, int stall_iters,
                 bool no_prior, bool full_budget, float* __restrict__ k_out,
                 float* __restrict__ t2_out, float* __restrict__ f_out,
                 uint8_t* __restrict__ conv_out, int32_t* __restrict__ nit_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s[T];
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = signal[i * T + t];
  float k, t2, f, nit;
  bool conv;
  fit_voxel<T>(s, p, max_iters, stall_iters, no_prior, full_budget, k, t2, f,
               conv, nit);
  k_out[i] = k;
  t2_out[i] = t2;
  f_out[i] = f;
  conv_out[i] = conv ? 1 : 0;
  nit_out[i] = (int32_t)nit;
}

template <int T>
void launch(const float* signal, long long n, const GaussParams& p,
            int max_iters, int stall_iters, bool no_prior, bool full_budget,
            float* k, float* t2, float* f, uint8_t* conv, int32_t* nit,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gauss_fit_kernel<T><<<blocks, kThreads, 0, stream>>>(
      signal, n, p, max_iters, stall_iters, no_prior, full_budget, k, t2, f,
      conv, nit);
}

}  // namespace

extern "C" int ft2_gauss_params_floats() { return kParamFloats; }

// signal: (n, n_te) row-major float32 on the device; params: kParamFloats
// host floats (GaussParams). Outputs are device arrays of length n. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ft2_gauss_fit(const float* signal, long long n, int n_te,
                             const float* params, int max_iters,
                             int stall_iters, int no_prior, int full_budget,
                             float* k, float* t2, float* f,
                             unsigned char* conv, int* nit, void* stream) {
  GaussParams p;
  std::memcpy(&p, params, sizeof(p));
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool np = no_prior != 0, fb = full_budget != 0;
  switch (n_te) {
    case 2: launch<2>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 3: launch<3>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 4: launch<4>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 5: launch<5>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 6: launch<6>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 7: launch<7>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    case 8: launch<8>(signal, n, p, max_iters, stall_iters, np, fb, k, t2, f, conv, nit, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
