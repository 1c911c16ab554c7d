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
// What bounds it: arithmetic and the special-function unit. A voxel reads
// T floats and writes 24 bytes, once; in between, the prelude costs ~45
// expf plus ~10 inner steps of T reciprocal square roots each, and every
// outer iteration T expf (E at the candidate; E at the current iterate is
// carried) plus 3 inner steps. So one thread owns one voxel's whole state
// in registers, T is a template parameter so the echo loops unroll, and
// nothing touches shared or device memory between the signal read and
// the result write. Each thread stops when its own voxel converged; a
// converged voxel is frozen, so results equal the TPU kernel's block-wide
// loop.
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

// The whole fit of one voxel: s[T] in, (k, t2, sigma), (f, convf, n_iter) out.
template <int T>
__device__ __forceinline__ void fit_voxel(const float (&s)[T],
                                          const GrParams& p, int max_iters,
                                          int stall_iters, bool full_budget,
                                          float (&x_out)[3], float (&st_out)[3]) {
  constexpr float kXtol2 = (float)(1e-6 * 1e-6);
  const VarPro<T> vp{p, s};
  const float lo_t2 = p.lo[1], hi_t2 = p.hi[1];
  const float ftol = p.tols[0], gtol = p.tols[1], stall_tol = p.tols[2];

  // ---- basin selection: loglinear, exact interpolant, static t2 grid
  float k_ll, t2_ll;
  loglin<T>(s, p.te, k_ll, t2_ll);
  float t2 = clip(t2_ll, lo_t2, hi_t2);
  const float kc = clip(k_ll, p.lo[0], p.hi[0]);
  float a = clip(kc * kc, p.ab[0], p.ab[1]);
  float b = p.b_init;
  float E[T];
  vp.E_at(t2, E);
  vp.inner(E, a, b, 2);
  float f = vp.f_of(E, a, b);

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

  // ---- outer damped 1-D Newton on the envelope F(t2)
  float lam = 1e-3f, convf = 0.0f, scnt = 0.0f, nit = 0.0f;
  for (int it = 0; it < max_iters; ++it) {
    const bool conv = convf > 0.5f;
    if (conv && !full_budget) break;
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

  x_out[0] = clip(sqrtf(a), p.lo[0], p.hi[0]);
  x_out[1] = t2;
  x_out[2] = clip(sqrtf(b), p.lo[2], p.hi[2]);
  st_out[0] = f;
  st_out[1] = convf;
  st_out[2] = nit;
}

// ---- kernel and C entry

template <int T>
__global__ void __launch_bounds__(kThreads)
gr_varpro_kernel(const float* __restrict__ signal, long long n,
                 const GrParams p, int max_iters, int stall_iters,
                 bool full_budget, float* __restrict__ x_out,
                 float* __restrict__ st_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s[T];
#pragma unroll
  for (int t = 0; t < T; ++t) s[t] = signal[i * T + t];
  float x[3], st[3];
  fit_voxel<T>(s, p, max_iters, stall_iters, full_budget, x, st);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[c * n + i] = x[c];
    st_out[c * n + i] = st[c];
  }
}

template <int T>
void launch(const float* signal, long long n, const GrParams& p, int max_iters,
            int stall_iters, bool full_budget, float* x, float* st,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gr_varpro_kernel<T><<<blocks, kThreads, 0, stream>>>(
      signal, n, p, max_iters, stall_iters, full_budget, x, st);
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

// signal: (n, n_te) row-major float32 on the device; params: kParamFloats
// host floats (GrParams). x_out, st_out: (3, n) device arrays, rows
// (k, t2, sigma) and (f, converged 0/1, n_iter). Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int ft2_gr_varpro_fit(const float* signal, long long n, int n_te,
                                 const float* params, int max_iters,
                                 int stall_iters, int full_budget,
                                 float* x_out, float* st_out, void* stream) {
  GrParams p;
  std::memcpy(&p, params, sizeof(p));
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fb = full_budget != 0;
  switch (n_te) {
    case 2: launch<2>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 3: launch<3>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 4: launch<4>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 5: launch<5>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 6: launch<6>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 7: launch<7>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    case 8: launch<8>(signal, n, p, max_iters, stall_iters, fb, x_out, st_out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
