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
// 0.12-0.18 ms of HBM time. So it is bound by the tensor cores; the design
// keeps them fed and hides everything else behind them.
//
// bf16 (the U-Net's type): a warp-specialised wgmma implicit GEMM fed by TMA,
// one persistent block per SM.
// - Output tiles of 8 (y) x 16 (x) voxels of one z-plane by all 192 output
//   channels (kBN, one wgmma N), so each A row is read once per tile.
// - A by TMA straight from X: a 4-D tensor map over (C, Qx+1, Qy+1, Qz+1)
//   with a box of (64 channels, 16, 8, 1); the box at (c0, x0+ux, y0+uy,
//   z0+uz) IS the A tile of tap (uz, uy, ux), channel chunk c0: 128 rows of
//   128 bytes in the 128-byte swizzle wgmma reads K-major. TMA zero-fills
//   what lies past the tensor, so ragged tiles and C < 64 need no masking.
// - B by TMA from a K-major copy of the weight, (C', 8*Cp) with Cp = C
//   rounded up to 64 and zeros in the padding (made once per weight by the
//   wrapper), box (64, 192): rows past C' come back zero.
// - A ring of kStages (A, B) stages with full/empty mbarriers. One producer
//   thread issues the TMA loads of the block's tiles in order; two consumer
//   warpgroups take alternate tiles (ping-pong), each running wgmma
//   m64n192k16 over its tile's two m64 blocks (192 fp32 accumulators a
//   thread, registers moved from the producer by setmaxnreg), so one
//   warpgroup's epilogue runs under the other's products. A named-barrier
//   handshake makes a warpgroup wait on its first stage only after the other
//   has passed its last, which keeps each stage barrier's parity unambiguous.
// - The accumulators start at the bias. The epilogue adds the residual,
//   applies ELU and rounds once to bf16 in registers, one m64 block at a
//   time through a swizzled staging buffer per warpgroup, written out by TMA
//   stores that drop rows past (Qy, Qx) and channels past C'; the residual
//   arrives in the same buffer by TMA. ELU's exp is the SFU's (__expf): its
//   few-ulp fp32 error moves a bf16 rounding of a negative output by one ulp
//   on the order of 1e-4 of them, inside the one-ulp band.
// The K loop is 8 taps x ceil(C/64) chunks. The dense product is computed,
// structural zeros included, as the TPU kernel does.
//
// fp32 operands (exactness checks only) take plain fp32 FMAs on 128 x 64
// tiles fed by a 3-stage cp.async ring, each block computing the in-form
// offset of (output voxel, tap) itself. C and C' must be multiples of 8
// for both paths (16-byte rows and copies).

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Shape {
  int qz, qy, qx;  // out-form grid; the in-form grid is one larger each way
  int c, cout;     // in-form and out-form channels
  long long m;     // qz * qy * qx
  int k;           // 8 * c
};

// ======================================================== fp32: SIMT FMAs
constexpr int kFBM = 128;      // output rows (voxels) per block
constexpr int kFBN = 64;       // output channels per block
constexpr int kFThreads = 256; // 16 x 16 threads, 8 x 4 outputs each
constexpr int kFStages = 3;    // cp.async ring depth
constexpr int kFBK = 16;       // K per stage (64 bytes of each A row)
constexpr int kFLDA = kFBK + 4;                 // A tile row stride (floats)
constexpr int kFLDB = kFBN + 4;                 // B tile row stride (floats)
constexpr int kFAElems = kFBM * kFLDA;
constexpr int kFStageBytes = (kFAElems + kFBK * kFLDB) * 4;
constexpr int kFLDC = kFBN + 4;                 // epilogue tile row stride
constexpr int kFRingBytes = kFStages * kFStageBytes;
constexpr int kFCBytes = kFBM * kFLDC * 4;
constexpr int kFSmemBytes = kFRingBytes > kFCBytes ? kFRingBytes : kFCBytes;
static_assert(kFStageBytes % 128 == 0, "stages must keep 128-byte alignment");
static_assert(kFSmemBytes + kFBM * 4 <= 48 * 1024, "static shared memory limit");

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

// Copy K chunk `kt` of the A window rows and the B rows into one stage.
// row_vox[r] is the in-form voxel of output row r's tap (0,0,0), -1 past M.
__device__ __forceinline__ void load_stage_f32(float* As, float* Bs, const float* __restrict__ x,
                                               const float* __restrict__ w, const int* row_vox,
                                               const Shape& sh, int n0, int kt) {
  const int k0 = kt * kFBK;
  constexpr int AV = kFBK / 4;  // 16-byte copies per A row
  for (int i = threadIdx.x; i < kFBM * AV; i += kFThreads) {
    const int r = i / AV, v = i % AV;
    const int k = k0 + v * 4;
    const float* src = x;
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
    cp_async16(As + r * kFLDA + v * 4, src, bytes);
  }
  constexpr int BV = kFBN / 4;  // 16-byte copies per B row
  for (int i = threadIdx.x; i < kFBK * BV; i += kFThreads) {
    const int kr = i / BV, v = i % BV;
    const int k = k0 + kr, n = n0 + v * 4;
    const bool ok = k < sh.k && n < sh.cout;
    cp_async16(Bs + kr * kFLDB + v * 4, ok ? w + (long long)k * sh.cout + n : w, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kFThreads)
    conv_s2d_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ res,
                 float* __restrict__ out, Shape sh, int n_tiles, int elu) {
  __shared__ __align__(128) unsigned char smem[kFSmemBytes];
  __shared__ int row_vox[kFBM];

  const int n_tile = static_cast<int>(blockIdx.x % n_tiles);
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kFBM;
  const int n0 = n_tile * kFBN;

  for (int r = threadIdx.x; r < kFBM; r += kFThreads) {
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

  auto stage_a = [&](int s) { return reinterpret_cast<float*>(smem + s * kFStageBytes); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<float*>(smem + s * kFStageBytes) + kFAElems;
  };

  const int n_k = (sh.k + kFBK - 1) / kFBK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < n_k) load_stage_f32(stage_a(s), stage_b(s), x, w, row_vox, sh, n0, s);
    cp_async_commit();
  }

  float* cs = reinterpret_cast<float*>(smem);  // epilogue tile, after the ring drains
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    const int nk = kt + kFStages - 1;
    if (nk < n_k)
      load_stage_f32(stage_a(nk % kFStages), stage_b(nk % kFStages), x, w, row_vox, sh, n0, nk);
    cp_async_commit();
    const float* As = stage_a(kt % kFStages);
    const float* Bs = stage_b(kt % kFStages);
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * kFLDB + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(ty * 8 + i) * kFLDA + k];
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
    for (int j = 0; j < 4; ++j) cs[(ty * 8 + i) * kFLDC + tx * 4 + j] = acc[i][j];
  __syncthreads();

  // epilogue: bias, residual, activation in fp32
  for (int e = threadIdx.x; e < kFBM * kFBN; e += kFThreads) {
    const int r = e / kFBN, cidx = e % kFBN;
    const long long m = m0 + r;
    const int n = n0 + cidx;
    if (m >= sh.m || n >= sh.cout) continue;
    float v = cs[r * kFLDC + cidx] + bias[n];
    const long long o = m * sh.cout + n;
    if (res != nullptr) v += res[o];
    if (elu) v = v > 0.0f ? v : expf(v) - 1.0f;
    out[o] = v;
  }
}

// ======================================================== bf16: wgmma + TMA
// Mirrored by labels/conv_s2d.py (TILE_X, TILE_Y, TILE_N, TILE_K) and
// checked against it through ft2_conv_s2d_geometry.
constexpr int kTileX = 16;                    // tile extent along x (voxels)
constexpr int kTileY = 8;                     // tile extent along y
constexpr int kBM = kTileX * kTileY;          // 128 output rows per tile
constexpr int kBN = 192;                      // output channels per tile: one wgmma N
constexpr int kBK = 64;                       // K per stage: 128 bytes, one swizzle row
constexpr int kConsumers = 2;                 // consumer warpgroups, alternate tiles
constexpr int kMW = kBM / 64;                 // m64 blocks per tile, one warpgroup's
constexpr int kAcc = kBN / 2;                 // fp32 accumulators per thread per m64 block
constexpr int kStages = 4;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kChunks = kBN / kBK;                 // 64-channel chunks of an output row
constexpr int kChunkBytes = 64 * kBK * 2;          // one chunk of an m64 block: 64 rows x 128 B
constexpr int kStgBytes = kChunks * kChunkBytes;   // one m64 block of output, bf16
constexpr int kStgRowsY = 64 / kTileX;             // y rows of an m64 block
constexpr int kSmemBytes = kStages * kStageBytes + kConsumers * kStgBytes + 1024;  // + alignment
static_assert(kMW * 64 == kBM, "a tile is whole m64 blocks");
static_assert(kBN % kBK == 0 && 64 % kTileX == 0, "output chunks and m64 blocks tile evenly");
static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle atoms are 1024 bytes");
static_assert(kSmemBytes + (2 * kStages + kConsumers) * 8 <= 232448, "shared memory per block");

struct Plan {
  int tiles_x, tiles_y, tiles_n;  // tile grid; z is one tile per plane
  int total;                      // tiles_n * tiles_x * tiles_y * qz
};

// Tile t -> its output-channel offset and out-form origin. The channel
// tile is the fastest index, then x, y and z, so neighbouring tiles share
// window rows in L2.
__device__ __forceinline__ void tile_origin(const Plan& pl, int t, int& n0, int& x0, int& y0,
                                            int& z0) {
  n0 = (t % pl.tiles_n) * kBN;
  t /= pl.tiles_n;
  x0 = (t % pl.tiles_x) * kTileX;
  t /= pl.tiles_x;
  y0 = (t % pl.tiles_y) * kTileY;
  z0 = t / pl.tiles_y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Make this thread's shared-memory writes visible to the TMA unit.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma descriptor of a K-major operand tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 192, fp32) (+)= A (64 x 16, bf16, K-major) . B (16 x 192, bf16,
// K-major); scale_d 0 overwrites D. Register d[4j + 2h + e] holds row
// 16 warp + lane/4 + 8h, column 8j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[kAcc], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
    conv_s2d_bf16(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap r_map,
                  const __grid_constant__ CUtensorMap o_map, const float* __restrict__ bias,
                  Shape sh, Plan pl, int n_chunks, int has_res, int elu) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t res_bar[kConsumers];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x / 128;
  const int n_k = 8 * n_chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 128);  // one warpgroup consumes each stage
    }
#pragma unroll
    for (int g = 0; g < kConsumers; ++g) mbar_init(smem_u32(&res_bar[g]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < pl.total; t += gridDim.x) {
        int n0, x0, y0, z0;
        tile_origin(pl, t, n0, x0, y0, z0);
        for (int kt = 0; kt < n_k; ++kt) {
          const int tap = kt / n_chunks;
          const int c0 = (kt - tap * n_chunks) * kBK;
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1u);
          const uint32_t full = smem_u32(&full_bar[stage]);
          const uint32_t a = ring + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_4d(a, &x_map, full, c0, x0 + (tap & 1), y0 + ((tap >> 1) & 1), z0 + (tap >> 2));
          tma_load_2d(a + kABytes, &w_map, full, tap * n_chunks * kBK + c0, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: warpgroup wg takes the block's tiles l = wg,
    // wg + 2, ...; tile l's k-steps are the ring's steps l * n_k ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t stg = ring + kStages * kStageBytes + wg * kStgBytes;
    const uint32_t rbar = smem_u32(&res_bar[wg]);
    uint32_t res_phase = 0;
    float acc[kMW][kAcc];
    for (int l = wg;; l += kConsumers) {
      const long long tl = blockIdx.x + static_cast<long long>(l) * gridDim.x;
      if (tl >= pl.total) break;
      int n0, x0, y0, z0;
      tile_origin(pl, static_cast<int>(tl), n0, x0, y0, z0);
      // the accumulators start at the bias (zero past C')
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        const float b0 = n < sh.cout ? __ldg(bias + n) : 0.0f;
        const float b1 = n < sh.cout ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
        for (int mb = 0; mb < kMW; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[mb][4 * j + 2 * h] = b0;
            acc[mb][4 * j + 2 * h + 1] = b1;
          }
      }
      // the other warpgroup has passed its last wait of the previous tile:
      // from here on the parity of each stage's barrier names our phase
      if (l > 0) bar_sync(3 + wg, 2 * 128);
      int prev = -1;
      for (int kt = 0; kt < n_k; ++kt) {
        const int it = l * n_k + kt;
        const int stage = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t a = ring + stage * kStageBytes;
        const uint32_t b = ring + stage * kStageBytes + kABytes;
#pragma unroll
        for (int mb = 0; mb < kMW; ++mb) fence_acc(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < kMW; ++mb)
            wgmma_m64n192k16(acc[mb], sw128_desc(a + mb * 64 * kBK * 2 + kk * 32),
                             sw128_desc(b + kk * 32), 1);
        wgmma_commit();
#pragma unroll
        for (int mb = 0; mb < kMW; ++mb) fence_acc(acc[mb]);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        prev = stage;
      }
      if (blockIdx.x + static_cast<long long>(l + 1) * gridDim.x < pl.total)
        bar_arrive(3 + (1 - wg), 2 * 128);  // the other warpgroup's next tile may start
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMW; ++mb) fence_acc(acc[mb]);
      mbar_arrive(smem_u32(&empty_bar[prev]));

      // epilogue, one m64 block at a time through this warpgroup's staging
      // buffer: kChunks swizzled 64-row x 128-byte chunks, the layout the
      // output and residual tensor maps move; TMA drops what lies past the
      // grid or past C'.
#pragma unroll
      for (int mb = 0; mb < kMW; ++mb) {
        const int yb = y0 + mb * kStgRowsY;
        if (leader) bulk_wait_read();  // the previous stores have left the buffer
        bar_sync(1 + wg, 128);
        if (has_res) {
          if (leader) {
            int chunks = 0;
            for (int cc = 0; cc < kChunks; ++cc) chunks += n0 + cc * kBK < sh.cout;
            mbar_expect_tx(rbar, chunks * kChunkBytes);
            for (int cc = 0; cc < kChunks; ++cc)
              if (n0 + cc * kBK < sh.cout)
                tma_load_4d(stg + cc * kChunkBytes, &r_map, rbar, n0 + cc * kBK, x0, yb, z0);
          }
          mbar_wait(rbar, res_phase);
          res_phase ^= 1u;
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + lane / 4 + 8 * h;  // row of the m64 block; r % 8 == lane / 4
            const uint32_t addr = stg + (j / 8) * kChunkBytes + r * 128 +
                                  (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4;
            float v0 = acc[mb][4 * j + 2 * h], v1 = acc[mb][4 * j + 2 * h + 1];
            if (has_res) {
              const uint32_t rv = lds32(addr);
              const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
              v0 += rf.x;
              v1 += rf.y;
            }
            if (elu) {
              v0 = v0 > 0.0f ? v0 : __expf(v0) - 1.0f;
              v1 = v1 > 0.0f ? v1 : __expf(v1) - 1.0f;
            }
            const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            sts32(addr, *reinterpret_cast<const uint32_t*>(&o));
          }
        fence_async_smem();
        bar_sync(1 + wg, 128);
        if (leader) {
          for (int cc = 0; cc < kChunks; ++cc)
            if (n0 + cc * kBK < sh.cout)
              tma_store_4d(&o_map, stg + cc * kChunkBytes, n0 + cc * kBK, x0, yb, z0);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait();  // the last stores are done before the block exits
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime so the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A tiled bf16 tensor map with the 128-byte swizzle; false on failure.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool shape_ok(int qz, int qy, int qx, int c, int cout) {
  if (qz <= 0 || qy <= 0 || qx <= 0 || c <= 0 || cout <= 0 || c % 8 || cout % 8) return false;
  const long long in_vox = static_cast<long long>(qz + 1) * (qy + 1) * (qx + 1);
  return in_vox <= 0x7fffffffLL;
}

}  // namespace

// ---- C entries
// All pointers are device pointers, contiguous and 16-byte aligned; res may
// be null. Each returns cudaGetLastError() after its launch (0 = launched).

// The bf16 kernel's tile: {TILE_X, TILE_Y, TILE_N, TILE_K}. Returns 0.
extern "C" int ft2_conv_s2d_geometry(int* out) {
  out[0] = kTileX;
  out[1] = kTileY;
  out[2] = kBN;
  out[3] = kBK;
  return 0;
}

// fp32: x (qz+1, qy+1, qx+1, c), w = w_packed (8c, cout), out (qz, qy, qx, cout).
extern "C" int ft2_conv_s2d_f32(const void* x, const void* w, const void* bias, const void* res,
                                void* out, int qz, int qy, int qx, int c, int cout, int elu,
                                void* stream) {
  if (!shape_ok(qz, qy, qx, c, cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{qz, qy, qx, c, cout, static_cast<long long>(qz) * qy * qx, 8 * c};
  const long long m_tiles = (sh.m + kFBM - 1) / kFBM;
  const int n_tiles = (cout + kFBN - 1) / kFBN;
  const long long blocks = m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv_s2d_f32<<<static_cast<unsigned>(blocks), kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), sh, n_tiles, elu);
  return static_cast<int>(cudaGetLastError());
}

// bf16: x (qz+1, qy+1, qx+1, c); wk the K-major weight (cout, 8 cp), cp = c
// rounded up to TILE_K, zeros in the padding; out (qz, qy, qx, cout). The
// tile plan (tiles_x, tiles_y, tiles_n) comes from the wrapper and must
// cover the output exactly: ceil(qx / TILE_X), ceil(qy / TILE_Y),
// ceil(cout / TILE_N).
extern "C" int ft2_conv_s2d_bf16(const void* x, const void* wk, const void* bias,
                                 const void* res, void* out, int qz, int qy, int qx, int c,
                                 int cout, int elu, int tiles_x, int tiles_y, int tiles_n,
                                 void* stream) {
  if (!shape_ok(qz, qy, qx, c, cout)) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_x != (qx + kTileX - 1) / kTileX || tiles_y != (qy + kTileY - 1) / kTileY ||
      tiles_n != (cout + kBN - 1) / kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(tiles_n) * tiles_x * tiles_y * qz;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (c + kBK - 1) / kBK;
  const cuuint64_t kp = static_cast<cuuint64_t>(8) * n_chunks * kBK;

  CUtensorMap x_map, w_map, o_map, r_map;
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;  // bytes per in-form voxel
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(qx + 1),
                                static_cast<cuuint64_t>(qy + 1), static_cast<cuuint64_t>(qz + 1)};
  const cuuint64_t x_strides[3] = {row, row * (qx + 1), row * (qx + 1) * (qy + 1)};
  const cuuint32_t x_box[4] = {kBK, kTileX, kTileY, 1};
  const cuuint64_t w_dims[2] = {kp, static_cast<cuuint64_t>(cout)};
  const cuuint64_t w_strides[1] = {kp * 2};
  const cuuint32_t w_box[2] = {kBK, kBN};
  const cuuint64_t orow = static_cast<cuuint64_t>(cout) * 2;  // bytes per out-form voxel
  const cuuint64_t o_dims[4] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(qx),
                                static_cast<cuuint64_t>(qy), static_cast<cuuint64_t>(qz)};
  const cuuint64_t o_strides[3] = {orow, orow * qx, orow * qx * qy};
  const cuuint32_t o_box[4] = {kBK, kTileX, kStgRowsY, 1};
  if (!make_map(&x_map, x, 4, x_dims, x_strides, x_box) ||
      !make_map(&w_map, wk, 2, w_dims, w_strides, w_box) ||
      !make_map(&o_map, out, 4, o_dims, o_strides, o_box) ||
      (res != nullptr && !make_map(&r_map, res, 4, o_dims, o_strides, o_box)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (res == nullptr) r_map = o_map;  // never read

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_s2d_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape sh{qz, qy, qx, c, cout, static_cast<long long>(qz) * qy * qx, 8 * c};
  const Plan pl{tiles_x, tiles_y, tiles_n, static_cast<int>(total)};
  const int grid = static_cast<int>(total < sms ? total : sms);  // persistent: one block per SM
  conv_s2d_bf16<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, r_map, o_map, static_cast<const float*>(bias), sh, pl, n_chunks,
      res != nullptr, elu);
  return static_cast<int>(cudaGetLastError());
}
