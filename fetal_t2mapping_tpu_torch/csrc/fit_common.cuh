// Device helpers shared by the 3-parameter fit kernels (gr_varpro_fit.cu,
// fit3.cu): NaN-keeping clips, left-to-right echo sums, the weighted
// log-linear start and the exact T = 3 gaussian_rician interpolant.
//
// Numerics follow fetal_t2mapping_tpu_torch/models/fused_fit.py op for op
// (which follows the JAX package's kernels): each helper rounds where its
// plain version rounds, and the libraries are built with -fmad=false so no
// multiply-add is fused. Constants that the reference computes between
// Python floats arrive precomputed in float64 and rounded, in the
// parameter structs.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace ft2
