// Fused space-to-depth conv of the U-Net's level 0, for Hopper (sm_90a).
//
// Replaces fetal_t2mapping_tpu/labels/pallas_conv.py::conv_s2d (bodies
// _conv_kernel :70 and _res_kernel :178): the 2^3 VALID conv of an in-form
// tensor X (Qz+1, Qy+1, Qx+1, C) into the out-form (Qz, Qy, Qx, C'),
//
//   out[q, :] = act( sum_{u in {0,1}^3} X[q + u, :] . W[u] + b (+ R[q, :]) )
//
// as one implicit GEMM (M, 8C) @ (8C, C'), M = Qz*Qy*Qx, with W = w_packed
// (rows tap-major (uz, uy, ux), channel minor: pallas_conv.pack_taps), b and
// the accumulator in fp32, an optional residual R (the decoder's folded
// upsample branch) and act = ELU written as the reference writes it,
// where(acc > 0, acc, exp(acc) - 1), then one rounding to the operand type.
//
// What bounds it: at the slice's shape (Q = 80, C = C' = 192, K = 8C =
// 1536, M = 512,000) one launch is 2*M*K*C' = 3.02e11 FLOP, counting the S2D
// weight's structural zeros (27 of 64 tap-slot pairs are nonzero), against
// 0.40-0.60 GB of bf16 traffic: 0.31 ms of dense bf16 tensor-core time vs
// 0.12-0.18 ms of HBM time. So it is bound by the tensor cores, and the
// design keeps them fed without moving more bytes than the GEMM needs:
// - the patches are never built in device memory: each block copies its
//   window rows straight from X into shared memory, computing the in-form
//   offset of (output voxel, tap) itself (the TPU kernel's four-stream halo
//   assembly was a BlockSpec artefact and has no counterpart here);
// - a 3-stage cp.async ring of (128 x BK) A tiles and (BK x 64) B tiles
//   overlaps the copies of the next K chunks with the products of this one;
// - bf16 products run on the tensor cores (WMMA 16x16x16, fp32 accumulate;
//   a bf16 x bf16 product is exact in fp32); fp32 operands, used for
//   exactness checks, take plain fp32 FMAs on the same tiles;
// - the N tiles of one M tile are neighbours in launch order, so the A rows
//   they share are re-read from L2, not HBM;
// - bias, residual, ELU and the rounding run in the epilogue from a shared
//   fp32 tile, so the accumulator never reaches device memory.
// Rows past M and columns past C' are masked (zero-filled copies, guarded
// stores), so any (Qz, Qy, Qx) works; C and C' must be multiples of 8 (one
// 16-byte copy never straddles a tap or the row's end). wgmma, TMA and a
// persistent schedule are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // output rows (voxels) per block
constexpr int kBN = 64;       // output channels per block
constexpr int kThreads = 256; // 8 warps
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kCPad = 4;      // fp32 pad of the epilogue tile's rows

template <typename T>
struct Tile {
  // K chunk: 64 bytes of each A row per stage (32 bf16 or 16 fp32)
  static constexpr int BK = 64 / static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16-byte copy
  static constexpr int PAD = VEC;                  // 16 bytes against bank conflicts
  static constexpr int LDA = BK + PAD;             // A tile row stride (elements)
  static constexpr int LDB = kBN + PAD;            // B tile row stride (elements)
  static constexpr int A_ELEMS = kBM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * static_cast<int>(sizeof(T));
  static constexpr int LDC = kBN + kCPad;
  static constexpr int C_BYTES = kBM * LDC * static_cast<int>(sizeof(float));
  static constexpr int RING_BYTES = kStages * STAGE_BYTES;
  static constexpr int SMEM_BYTES = RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
  static_assert(STAGE_BYTES % 128 == 0, "stages must keep 128-byte alignment");
  static_assert((A_ELEMS * sizeof(T)) % 32 == 0, "B tile must be 32-byte aligned");
  static_assert(SMEM_BYTES + kBM * 4 <= 48 * 1024, "static shared memory limit");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// 16-byte global -> shared copy; src_bytes 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Shape {
  int qz, qy, qx;  // out-form grid; the in-form grid is one larger each way
  int c, cout;     // in-form and out-form channels
  long long m;     // qz * qy * qx
  int k;           // 8 * c
};

// Copy K chunk `kt` of the A window rows and the B rows into one stage.
// row_vox[r] is the in-form voxel of output row r's tap (0,0,0), -1 past M.
template <typename T>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* __restrict__ x,
                                           const T* __restrict__ w, const int* row_vox,
                                           const Shape& sh, int n0, int kt) {
  using Tl = Tile<T>;
  const int k0 = kt * Tl::BK;
  constexpr int AV = Tl::BK / Tl::VEC;  // copies per A row
  for (int i = threadIdx.x; i < kBM * AV; i += kThreads) {
    const int r = i / AV, v = i % AV;
    const int k = k0 + v * Tl::VEC;
    const T* src = x;
    int bytes = 0;
    const int vox = row_vox[r];
    if (vox >= 0 && k < sh.k) {
      const int tap = k / sh.c;
      const int ch = k - tap * sh.c;
      const int uz = tap >> 2, uy = (tap >> 1) & 1, ux = tap & 1;
      const long long v_in = vox + (uz * (sh.qy + 1) + uy) * (sh.qx + 1) + ux;
      src = x + v_in * sh.c + ch;
      bytes = 16;
    }
    cp_async16(As + r * Tl::LDA + v * Tl::VEC, src, bytes);
  }
  constexpr int BV = kBN / Tl::VEC;  // copies per B row
  for (int i = threadIdx.x; i < Tl::BK * BV; i += kThreads) {
    const int kr = i / BV, v = i % BV;
    const int k = k0 + kr, n = n0 + v * Tl::VEC;
    const bool ok = k < sh.k && n < sh.cout;
    cp_async16(Bs + kr * Tl::LDB + v * Tl::VEC, ok ? w + (long long)k * sh.cout + n : w,
               ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_s2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ res,
                    T* __restrict__ out, Shape sh, int n_tiles, int elu) {
  using Tl = Tile<T>;
  __shared__ __align__(128) unsigned char smem[Tl::SMEM_BYTES];
  __shared__ int row_vox[kBM];

  const int n_tile = static_cast<int>(blockIdx.x % n_tiles);
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = n_tile * kBN;

  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    int vox = -1;
    if (m < sh.m) {
      const int ix = static_cast<int>(m % sh.qx);
      const long long t = m / sh.qx;
      const int iy = static_cast<int>(t % sh.qy);
      const int iz = static_cast<int>(t / sh.qy);
      vox = (iz * (sh.qy + 1) + iy) * (sh.qx + 1) + ix;
    }
    row_vox[r] = vox;
  }
  __syncthreads();

  auto stage_a = [&](int s) {
    return reinterpret_cast<T*>(smem + s * Tl::STAGE_BYTES);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<T*>(smem + s * Tl::STAGE_BYTES) + Tl::A_ELEMS;
  };

  const int n_k = (sh.k + Tl::BK - 1) / Tl::BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_stage<T>(stage_a(s), stage_b(s), x, w, row_vox, sh, n0, s);
    cp_async_commit();
  }

  float* cs = reinterpret_cast<float*>(smem);  // epilogue tile, after the ring drains

  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    // 8 warps as 4 (rows) x 2 (columns), each a 32 x 32 output tile
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nk = kt + kStages - 1;
      if (nk < n_k)
        load_stage<T>(stage_a(nk % kStages), stage_b(nk % kStages), x, w, row_vox, sh, n0, nk);
      cp_async_commit();
      const bf16* As = stage_a(kt % kStages);
      const bf16* Bs = stage_b(kt % kStages);
#pragma unroll
      for (int kk = 0; kk < Tl::BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * Tl::LDA + kk, Tl::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * Tl::LDB + wn * 32 + j * 16, Tl::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * Tl::LDC + wn * 32 + j * 16,
                                acc[i][j], Tl::LDC, wmma::mem_row_major);
  } else {
    // 16 x 16 threads, each an 8 (rows) x 4 (columns) output tile
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][4] = {};
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nk = kt + kStages - 1;
      if (nk < n_k)
        load_stage<T>(stage_a(nk % kStages), stage_b(nk % kStages), x, w, row_vox, sh, n0, nk);
      cp_async_commit();
      const float* As = stage_a(kt % kStages);
      const float* Bs = stage_b(kt % kStages);
#pragma unroll
      for (int k = 0; k < Tl::BK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + k * Tl::LDB + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = As[(ty * 8 + i) * Tl::LDA + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty * 8 + i) * Tl::LDC + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: bias, residual, activation in fp32; one rounding to T
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int r = e / kBN, cidx = e % kBN;
    const long long m = m0 + r;
    const int n = n0 + cidx;
    if (m >= sh.m || n >= sh.cout) continue;
    float v = cs[r * Tl::LDC + cidx] + bias[n];
    const long long o = m * sh.cout + n;
    if (res != nullptr) v += to_float(res[o]);
    if (elu) v = v > 0.0f ? v : expf(v) - 1.0f;
    out[o] = from_float<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const void* res, void* out,
           const Shape& sh, int elu, cudaStream_t stream) {
  const long long m_tiles = (sh.m + kBM - 1) / kBM;
  const int n_tiles = (sh.cout + kBN - 1) / kBN;
  const long long blocks = m_tiles * n_tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv_s2d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<const T*>(res),
      static_cast<T*>(out), sh, n_tiles, elu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- C entry
// dtype 0: fp32 operands and output; 1: bf16. All pointers are device
// pointers, contiguous and 16-byte aligned; res may be null. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ft2_conv_s2d(int dtype, const void* x, const void* w, const void* bias,
                            const void* res, void* out, int qz, int qy, int qx, int c,
                            int cout, int elu, void* stream) {
  if (qz <= 0 || qy <= 0 || qx <= 0 || c <= 0 || cout <= 0 || c % 8 || cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long in_vox = static_cast<long long>(qz + 1) * (qy + 1) * (qx + 1);
  if (in_vox > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh{qz, qy, qx, c, cout, static_cast<long long>(qz) * qy * qx, 8 * c};
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(x, w, b, res, out, sh, elu, s);
  if (dtype == 0) return launch<float>(x, w, b, res, out, sh, elu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
