// The block layout of fit_volume on Hopper (sm_90a): block compaction of a
// masked echo volume into the fit buffer, and the scatter of the fit back
// into six whole-grid maps, around one block -> slot map.
//
// Replaces no Pallas kernel. On the TPU the JAX package's volume_fit wrapper
// (fetal_t2mapping_tpu/models/volume_fit.py::_fit_volume_impl) builds this
// layout from jnp ops (a stable partition sort, gathers, a where, a
// whole-grid zero and scatter) that XLA fuses into a few passes;
// in PyTorch the same code ran as ~40 aten ops a request, each a pass over
// the 13.8M-voxel grid or a strided view of it (models/volume_fit.py keeps
// it as _compact_plain / _scatter_plain, what CPU tensors run).
//
// What bounds it: bytes. A 240^3 x 3-TE request must read the mask
// (13.8 MB), write and read the block -> slot map (1.7 MB), move the kept
// blocks' echoes into the buffer (<= 10 MB each way), read the fit's
// outputs and write six whole-grid maps (four float32, a bool, an int32:
// 290 MB): ~0.10 ms at 3.35 TB/s, nearly all of it the maps' writes. So
// every voxel of the grid is read once (the mask, 16 bytes a lane), the
// maps written once in 16-byte stores, and what depends on the data (the
// echoes, the fit's rows, the mask of kept blocks) is touched only where a
// block was kept. Measured on an H100 80GB HBM3 (700 W) at that shape,
// 829,440 buffer rows: the scatter 103 us (its bytes 0.09 ms), the
// compaction 27 + 9.5 us (0.01 ms), against ~1.1 ms for the aten ops.
//
// Three kernels, two C entries:
// - layout_compact_kernel: one CTA per tile of blocks counts each block's
//   masked voxels from the mask, then a single-pass scan with decoupled
//   look-back (tiles taken in ticket order, each publishing its own count,
//   then its inclusive prefix) gives each touched block its slot in
//   ascending block order, the order of a stable partition; it writes the
//   block -> slot map (-1: not in the buffer), the slot -> block list and
//   the counts (touched blocks, masked voxels, masked voxels kept).
// - layout_gather_kernel: one thread per buffer row writes the kept
//   blocks' echoes, the filler in their unmasked voxels, in voxels past n
//   on a ragged last block and in slots past the touched count. Asked for
//   a row list, it also lists each row that takes a kept masked voxel's
//   echoes (the rows the scatter reads; one atomic per CTA, fit_common.cuh's
//   push_slot), so a fit can skip the filler (fit3.cu's RowList).
// - layout_scatter_kernel: one thread per 4 voxels of the grid reads its
//   block's slot and writes the six maps; a kept masked voxel takes its
//   fit row, every other voxel 0 / False. It also writes n_overflow.
// No float arithmetic: every value is copied, so the buffer and the maps
// are bitwise those of the plain versions.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fit_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 8;               // fused_fit._MAX_TE
constexpr int kTileVoxels = 8192;      // a scan tile covers at least this many voxels
constexpr int kMaxBlocksPerThread = 32;
constexpr int kVec = 16;               // mask bytes a lane reads at once
// ints of `work` before the tile states: the counts, the ticket, then the
// row list's push counter
constexpr int kHeader = 8;
enum { kTouched = 0, kMasked = 1, kKept = 2, kOverflow = 3, kTicket = 4, kListed = 5 };
// a tile state: (flag << 32) | count, flag 1: the tile's own count,
// 2: the inclusive prefix of the tiles up to it
constexpr unsigned long long kOwn = 1ull << 32, kPrefix = 2ull << 32;

struct Filler {
  float v[kMaxT];
};

// blocks of `block` voxels each thread of a scan tile owns
int blocks_per_thread(int block) {
  const int per = kTileVoxels / (kThreads * block);
  return per < 1 ? 1 : per > kMaxBlocksPerThread ? kMaxBlocksPerThread : per;
}

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// bit i set where mask byte v + i (< v_end) is nonzero, i < 16
__device__ __forceinline__ unsigned mask_bits(const uint8_t* __restrict__ mask, long long v,
                                              long long v_end, bool vec) {
  unsigned bits = 0;
  if (vec && v + kVec <= v_end) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(mask + v));
    if ((q.x | q.y | q.z | q.w) == 0) return 0;
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((w[i] >> (8 * j)) & 0xffu) bits |= 1u << (4 * i + j);
    return bits;
  }
  for (int i = 0; i < kVec && v + i < v_end; ++i)
    if (mask[v + i]) bits |= 1u << i;
  return bits;
}

__global__ void __launch_bounds__(kThreads)
layout_compact_kernel(const uint8_t* __restrict__ mask, long long n, int block, int nb,
                      int bpt, int blk_cap, int* __restrict__ slot, int* __restrict__ list,
                      unsigned long long* __restrict__ states, int* __restrict__ work) {
  extern __shared__ int s_cnt[];        // kThreads * bpt: masked voxels per block, then slots
  __shared__ int s_tile, s_prefix;
  __shared__ int s_warp_t[kWarps], s_warp_m[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_blocks = kThreads * bpt;
  if (tid == 0) s_tile = atomicAdd(&work[kTicket], 1);
  for (int i = tid; i < tile_blocks; i += kThreads) s_cnt[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long b0 = (long long)tile * tile_blocks;
  const long long v0 = b0 * block;
  const long long v_end = min(n, (b0 + tile_blocks) * block);
  const bool vec = (reinterpret_cast<uintptr_t>(mask) % kVec) == 0;

  // masked voxels per block; v0 is a multiple of kThreads, so of kVec
  for (long long c = v0 + (long long)kVec * tid; c < v_end; c += (long long)kVec * kThreads) {
    unsigned bits = mask_bits(mask, c, v_end, vec);
    int cur = -1, cnt = 0;
    while (bits) {
      const int i = __ffs(bits) - 1;
      bits &= bits - 1;
      const int lb = (int)((unsigned)(c + i - v0) / (unsigned)block);
      if (lb != cur) {
        if (cnt) atomicAdd(&s_cnt[cur], cnt);
        cur = lb;
        cnt = 0;
      }
      ++cnt;
    }
    if (cnt) atomicAdd(&s_cnt[cur], cnt);
  }
  __syncthreads();

  // each thread owns bpt consecutive blocks: its touched count and masked voxels
  const int own = tid * bpt;
  const long long bt = b0 + own;
  int my_t = 0, my_m = 0;
  for (int i = 0; i < bpt; ++i) {
    if (bt + i < nb) {
      const int c = s_cnt[own + i];
      my_t += c > 0;
      my_m += c;
    }
  }
  int incl = my_t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  int m = my_m;
#pragma unroll
  for (int d = 16; d; d >>= 1) m += __shfl_xor_sync(0xffffffffu, m, d);
  if (lane == 31) s_warp_t[warp] = incl;
  if (lane == 0) s_warp_m[warp] = m;
  __syncthreads();
  int warp_off = 0, tile_t = 0, tile_m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    warp_off += w < warp ? s_warp_t[w] : 0;
    tile_t += s_warp_t[w];
    tile_m += s_warp_m[w];
  }

  // decoupled look-back: publish this tile's count, add the predecessors'
  if (tid == 0) {
    int prefix = 0;
    if (tile == 0) {
      store_state(&states[0], kPrefix | (unsigned)tile_t);
    } else {
      store_state(&states[tile], kOwn | (unsigned)tile_t);
      for (int t = tile - 1;; --t) {
        unsigned long long s;
        do {
          s = load_state(&states[t]);
        } while ((s >> 32) == 0);
        prefix += (int)(unsigned)(s & 0xffffffffu);
        if ((s >> 32) == 2) break;
      }
      store_state(&states[tile], kPrefix | (unsigned)(prefix + tile_t));
    }
    s_prefix = prefix;
    if (tile_t) atomicAdd(&work[kTouched], tile_t);
    if (tile_m) atomicAdd(&work[kMasked], tile_m);
  }
  __syncthreads();

  // slots in ascending block order; a thread reads and rewrites its own entries
  int s = s_prefix + warp_off + incl - my_t;
  int kept = 0;
  for (int i = 0; i < bpt; ++i) {
    int val = -1;
    if (bt + i < nb) {
      const int c = s_cnt[own + i];
      if (c > 0) {
        if (s < blk_cap) {
          val = s;
          list[s] = (int)(bt + i);
          kept += c;
        }
        ++s;
      }
    }
    s_cnt[own + i] = val;
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, d);
  if (lane == 0 && kept) atomicAdd(&work[kKept], kept);
  __syncthreads();
  for (int i = tid; i < tile_blocks && b0 + i < nb; i += kThreads) slot[b0 + i] = s_cnt[i];
}

__global__ void __launch_bounds__(kThreads)
layout_gather_kernel(const float* __restrict__ signal, const uint8_t* __restrict__ mask,
                     int n, int T, int block, int nb, int rows, Filler filler,
                     const int* __restrict__ list, int* __restrict__ work,
                     float* __restrict__ buf, int* __restrict__ row_list) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  bool listed = false;  // the row takes a kept masked voxel's echoes
  if (r < rows) {
    const int s = (int)((unsigned)r / (unsigned)block);
    const int j = r - s * block;
    // slots past the touched count hold untouched blocks (filler) or, past
    // the last block, block 0 (as the stable partition pads its order; the
    // scatter reads no such row, so none is listed)
    const int touched = work[kTouched];
    const int b = s < touched ? list[s] : s < nb ? -1 : 0;
    const long long v = (long long)b * block + j;
    float* out = buf + (long long)r * T;
    const float* in = signal + v * T;
    const bool take = b >= 0 && v < n && mask[v];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)  // static indices keep the filler in registers
      if (t < T) out[t] = take ? in[t] : filler.v[t];
    listed = take && s < touched;
  }
  if (row_list != nullptr) {  // every thread of the block pushes
    const int at = ft2::push_slot<kThreads>(listed, work + kListed);
    if (listed) row_list[at] = r;
  }
}

struct FitRows {
  const float* x;                    // (rows, P): k, t2 [, sigma]
  long long x_row, x_col;
  int p;
  const float* fun;
  long long fun_row;
  const uint8_t* conv;
  long long conv_row;
  const int* nit;
  long long nit_row;
};

struct Maps {
  float *t2, *k, *sigma, *fun;
  uint8_t* conv;
  int* nit;
};

__global__ void __launch_bounds__(kThreads)
layout_scatter_kernel(const uint8_t* __restrict__ mask, int n, int block,
                      const int* __restrict__ slot, FitRows fit, const int* inner,
                      int inner_value, Maps maps, int* __restrict__ work) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0)
    work[kOverflow] = work[kMasked] - work[kKept] + (inner ? *inner : inner_value);
  const unsigned v0 = 4u * i;
  if (v0 >= (unsigned)n) return;
  float t2[4], k[4], sg[4], f[4];
  uint8_t cv[4];
  int it[4];
  unsigned b = v0 / (unsigned)block, j = v0 - b * (unsigned)block;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    t2[q] = k[q] = sg[q] = f[q] = 0.0f;
    cv[q] = 0;
    it[q] = 0;
    const unsigned v = v0 + q;
    if (v < (unsigned)n) {
      const int s = slot[b];
      if (s >= 0 && mask[v]) {
        const long long r = (long long)s * block + j;
        const float* x = fit.x + r * fit.x_row;
        k[q] = x[0];
        t2[q] = x[fit.x_col];
        sg[q] = fit.p == 3 ? x[2 * fit.x_col] : 0.0f;
        f[q] = fit.fun[r * fit.fun_row];
        cv[q] = fit.conv[r * fit.conv_row] != 0;
        it[q] = fit.nit[r * fit.nit_row];
      }
    }
    if (++j == (unsigned)block) {
      j = 0;
      ++b;
    }
  }
  if (v0 + 4 <= (unsigned)n) {  // the maps are fresh allocations: 16-byte aligned
    *reinterpret_cast<float4*>(maps.t2 + v0) = make_float4(t2[0], t2[1], t2[2], t2[3]);
    *reinterpret_cast<float4*>(maps.k + v0) = make_float4(k[0], k[1], k[2], k[3]);
    *reinterpret_cast<float4*>(maps.sigma + v0) = make_float4(sg[0], sg[1], sg[2], sg[3]);
    *reinterpret_cast<float4*>(maps.fun + v0) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<uchar4*>(maps.conv + v0) = make_uchar4(cv[0], cv[1], cv[2], cv[3]);
    *reinterpret_cast<int4*>(maps.nit + v0) = make_int4(it[0], it[1], it[2], it[3]);
  } else {
    for (int q = 0; q < 4 && v0 + q < (unsigned)n; ++q) {
      maps.t2[v0 + q] = t2[q];
      maps.k[v0 + q] = k[q];
      maps.sigma[v0 + q] = sg[q];
      maps.fun[v0 + q] = f[q];
      maps.conv[v0 + q] = cv[q];
      maps.nit[v0 + q] = it[q];
    }
  }
}

int scan_tiles(long long n, int block) {
  const long long nb = (n + block - 1) / block;
  const long long tile_blocks = (long long)kThreads * blocks_per_thread(block);
  return (int)((nb + tile_blocks - 1) / tile_blocks);
}

bool valid_shape(long long n, int block, int blk_cap) {
  return n > 0 && n <= INT_MAX && block > 0 && blk_cap > 0 &&
         (long long)blk_cap * block <= INT_MAX;
}

}  // namespace

// Device ints of the compaction's `work`: the header (the counts), the
// scan's tile states and the slot -> block list; -1 for shapes the
// kernels do not take.
extern "C" int ft2_layout_work_ints(long long n, int block, int blk_cap) {
  if (!valid_shape(n, block, blk_cap)) return -1;
  return kHeader + 2 * scan_tiles(n, block) + blk_cap;
}

// Block compaction. signal: (n, T) row-major float32; mask: n bytes,
// nonzero = masked; filler: T host floats; buf: >= blk_cap * block rows of
// T floats, rows [0, blk_cap * block) written; slot: ceil(n / block)
// ints; work: ft2_layout_work_ints(n, block, blk_cap) ints, of which
// [0, 3) end as (touched blocks, masked voxels, masked voxels kept).
// row_list: null, or >= blk_cap * block device ints, of which the first
// work[2] end as the buffer rows that took a kept masked voxel's echoes,
// the rows the scatter reads, in no set order. A memset and two kernels on
// `stream`; returns the first CUDA error (0 = launched).
extern "C" int ft2_layout_compact(const float* signal, const unsigned char* mask, long long n,
                                  int T, int block, int blk_cap, const float* filler,
                                  float* buf, int* slot, int* work, long long work_ints,
                                  int* row_list, void* stream) {
  if (!valid_shape(n, block, blk_cap) || T < 1 || T > kMaxT || signal == nullptr ||
      mask == nullptr || filler == nullptr || buf == nullptr || slot == nullptr ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = scan_tiles(n, block);
  if (work_ints < kHeader + 2LL * tiles + blk_cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)((n + block - 1) / block), bpt = blocks_per_thread(block);
  const int rows = blk_cap * block;
  auto* states = reinterpret_cast<unsigned long long*>(work + kHeader);
  int* list = work + kHeader + 2 * tiles;
  Filler fill{};
  for (int t = 0; t < T; ++t) fill.v[t] = filler[t];
  cudaError_t err = cudaMemsetAsync(work, 0, (kHeader + 2LL * tiles) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  layout_compact_kernel<<<tiles, kThreads, kThreads * bpt * sizeof(int), s>>>(
      mask, n, block, nb, bpt, blk_cap, slot, list, states, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layout_gather_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      signal, mask, (int)n, T, block, nb, rows, fill, list, work, buf, row_list);
  return (int)cudaGetLastError();
}

// The scatter. mask, slot, work: as ft2_layout_compact left them; the
// fit's rows by element strides: x (P = 2 or 3 columns: k, t2 [, sigma])
// and fun float32, conv bytes (0/1), nit int32. inner: a device int added
// to n_overflow, or null to add inner_value. The maps: n elements each,
// 16-byte aligned. work[3] ends as n_overflow = masked - kept + inner. One
// kernel on `stream`; returns cudaGetLastError().
extern "C" int ft2_layout_scatter(const unsigned char* mask, long long n, int block,
                                  const int* slot, const float* x, long long x_row,
                                  long long x_col, int p, const float* fun, long long fun_row,
                                  const unsigned char* conv, long long conv_row, const int* nit,
                                  long long nit_row, const int* inner, int inner_value,
                                  float* t2_map, float* k_map, float* sigma_map, float* fun_map,
                                  unsigned char* conv_map, int* nit_map, int* work,
                                  void* stream) {
  if (n <= 0 || n > INT_MAX || block < 1 || (p != 2 && p != 3) || mask == nullptr ||
      slot == nullptr || x == nullptr || fun == nullptr || conv == nullptr ||
      nit == nullptr || t2_map == nullptr || k_map == nullptr || sigma_map == nullptr ||
      fun_map == nullptr || conv_map == nullptr || nit_map == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const FitRows fit{x, x_row, x_col, p, fun, fun_row, conv, conv_row, nit, nit_row};
  const Maps maps{t2_map, k_map, sigma_map, fun_map, conv_map, nit_map};
  const long long groups = (n + 3) / 4;
  layout_scatter_kernel<<<(unsigned)((groups + kThreads - 1) / kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      mask, (int)n, block, slot, fit, inner, inner_value, maps, work);
  return (int)cudaGetLastError();
}
