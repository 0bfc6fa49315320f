// Grouped bf16 GEMM over the experts of a dropless MoE layer, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs GShard's capacity-limited
// MoE as one-hot dispatch and combine einsums, which cost more than the
// experts at 64 experts and drop tokens. Here the routed rows are sorted by
// expert into one buffer x [R, K] (bf16, row-major), expert e owning rows
// offsets[e] .. offsets[e + 1] - 1, and each expert's rows are multiplied by
// its weight w[e] [N, K] (bf16, K contiguous, a Linear layer's [out, in]):
//
//   y[r, n] = sum_k x[r, k] * w[e(r), n, k]    (f32 sums, bf16 out)
//
// The offsets [E + 1] (int32) are read from device memory by each block, so
// the host never learns how many rows an expert has and the forward never
// waits on the card. Rows at or past offsets[E] are not written.
//
// With swiglu, w[e] holds an expert's gate and up rows interleaved by eights
// (rows 16j .. 16j + 7 are gate rows 8j .. 8j + 7, rows 16j + 8 .. 16j + 15
// the up rows of the same columns), and the epilogue writes
// h = bf16(bf16(silu(bf16(g))) * bf16(u)) into y [R, N / 2]: the rounding
// of the published model's bf16 act_fn(gate_proj(x)) * up_proj(x).
//
// Bound on this card: the tensor cores. At the Moonlight cell's size an
// expert sees about 1,000 rows a layer, 1,000 * 2 * 2048 * 2816 operations
// of the first product over 11.5 MB of its weights: about 500 operations a
// byte, above the card's 295.
//
// Design: one persistent block an SM (at most as many blocks as tiles), each
// walking output tiles of 128 rows x kBN columns (kBN = 256 where it divides
// N, else 128) by a linear tile index with a stride of the grid. A block
// first reads the E + 1 offsets into shared memory and builds there the
// prefix of each expert's tiles of 128 rows; tile t is the (t / (N / kBN))-th
// tile of rows, columns fastest, so that the blocks in flight share a few
// tiles of rows (x read from device memory about once) and one expert's
// weights, which stay in L2. tile_schedule in ops/moe_grouped_gemm_cuda.py
// writes the same mapping in Python for the CPU tests. Three warpgroups:
// - a producer (one thread, 40 registers by setmaxnreg) keeps a ring of 4
//   stages full by TMA in the 128-byte swizzle: a stage is x's 128 rows and
//   w's kBN rows of 64 values (one 128-byte line a row; 16 + 32 KB), with a
//   full and an empty mbarrier. Rows of a tile past its expert's last row
//   are loaded as they are (the next expert's rows, or zeros past R from the
//   TMA unit) and masked at the store;
// - two consumers (232 registers), rows 0-63 and 64-127 of the tile, each
//   summing its 64 x kBN f32 tile in registers with wgmma.mma_async
//   m64n256k16 (m64n128k16), both operands K-major from shared memory. A
//   consumer releases a stage once the products reading it are done; one
//   group of products stays in flight.
// - The epilogue writes straight from the accumulators, while the producer
//   runs ahead into the next tile's stages. wgmma's layout is mma.sync's C
//   fragment: a thread holds two neighbouring columns of every group of 8,
//   so gate group 2j and up group 2j + 1 of the interleaving lie in the same
//   thread and the SwiGLU is taken in registers. The four threads that share
//   a row then exchange their words (quad_transpose) so that each stores one
//   whole group of 8 columns, 16 bytes: a warp writes whole 32-byte sectors.
// Two launches a MoE layer (gate+up, down), each one kernel: the schedule
// is computed inside it.

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int kBM = 128;           // rows a tile: two consumers of 64
constexpr int kBK = 64;            // values a stage: one 128-byte line a row
constexpr int kStages = 4;
constexpr int kThreads = 384;      // producer, consumer (rows 0-63), consumer (64-127)
constexpr int kConsumers = 256;
constexpr int kTileX = kBM * kBK * 2;  // 16 KB
constexpr int kMaxSmem = 232448;       // a block's shared memory on sm_90

template <int kBN>
struct Ring {
  static constexpr int kStageBytes = kTileX + kBN * kBK * 2;
  static constexpr int kBytes = kStages * kStageBytes;
};

// Descriptor of a K-major operand in the 128-byte swizzle at shared address
// `at` (1024-byte aligned, or 32 * kk bytes past it for the kk-th 16 values):
// rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t k_desc(uint32_t at) {
  return static_cast<uint64_t>((at & 0x3ffffu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane q of a quad holds word i of column group j0 + i (its columns 2q, 2q +
// 1 of the group, i = 0..3); returns the four words of group j0 + q, its
// eight columns in order: a 4 x 4 transpose across the quad in two
// exchanges (lane bit 0 with word bit 0, then bit 1 with bit 1). Every lane
// of the warp takes part.
__device__ __forceinline__ uint4 quad_transpose(uint32_t a0, uint32_t a1, uint32_t a2,
                                                uint32_t a3, int q) {
  const bool odd = q & 1, hi = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a2 : a3, 1);
  const uint32_t c0 = odd ? r0 : a0, c1 = odd ? a1 : r0, c2 = odd ? r1 : a2, c3 = odd ? a3 : r1;
  r0 = __shfl_xor_sync(0xffffffffu, hi ? c0 : c2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, hi ? c1 : c3, 2);
  return make_uint4(hi ? r0 : c0, hi ? r1 : c1, hi ? c2 : r0, hi ? c3 : r1);
}

struct Tile {
  int expert, row0, row1, n0;
};

// Output tile t: the expert e with tiles[e] <= t / n_cols < tiles[e + 1]
// (tiles[e] counts the tiles of rows of the experts before e), its rows
// [row0, row1) and first column n0.
__device__ __forceinline__ Tile locate(int t, const int* off, const int* tiles, int E,
                                       int n_cols, int bn) {
  const int rt = t / n_cols;
  int lo = 0, hi = E;  // tiles[lo] <= rt < tiles[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tiles[mid] <= rt) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int row0 = off[lo] + (rt - tiles[lo]) * kBM;
  return Tile{lo, row0, min(off[lo + 1], row0 + kBM), (t - rt * n_cols) * bn};
}

template <bool kSwiGLU, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    moe_grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const int32_t* __restrict__ offsets, int E, int K, int N,
                            __nv_bfloat16* __restrict__ y) {
  using RingT = Ring<kBN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + RingT::kBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;
  int* s_off = reinterpret_cast<int*>(bars + 2 * kStages);
  int* s_tiles = s_off + E + 1;
  const int tid = threadIdx.x;

  for (int e = tid; e <= E; e += kThreads) s_off[e] = offsets[e];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {  // s_tiles: the prefix of the experts' tiles of rows, 32 experts a step
    int carry = 0;
    if (tid == 0) s_tiles[0] = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + tid;
      int v = e < E ? max(0, s_off[e + 1] - s_off[e] + kBM - 1) / kBM : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, v, d);
        if (tid >= d) v += o;
      }
      if (e < E) s_tiles[e + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const int n_cols = N / kBN;
  const int total = s_tiles[E] * n_cols;
  const int KT = K / kBK;

  if (tid < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = locate(t, s_off, s_tiles, E, n_cols, kBN);
        const int w_row = tl.expert * N + tl.n0;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect(full, RingT::kStageBytes);
          const uint32_t st = smem_u32(smem + s * RingT::kStageBytes);
          tma_load(st, &map_x, kt * kBK, tl.row0, full);
          tma_load(st + kTileX, &map_w, kt * kBK, w_row, full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128, wg = ct >> 7, lane = ct & 31;
  const int r_in = 64 * wg + 16 * ((ct >> 5) & 3) + (lane >> 2);  // rows r_in, r_in + 8
  const int q = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = locate(t, s_off, s_tiles, E, n_cols, kBN);
    float acc[kBN / 2];
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t st = smem_u32(smem + s * RingT::kStageBytes);
      const uint64_t a = k_desc(st + wg * (kTileX / 2)), b = k_desc(st + kTileX);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 values (32 bytes) further each
        if constexpr (kBN == 256) {
          wgmma_m64n256k16<false>(acc, a + 2 * kk, b + 2 * kk, kt > 0 || kk > 0);
        } else {
          wgmma_m64n128k16<false>(acc, a + 2 * kk, b + 2 * kk, kt > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // acc[4j + 2h + c] is row r_in + 8h, column 8j + 2q + c of the tile. The
    // four lanes of a quad share their rows: lane q stores the eight columns
    // of every fourth column group, 16 bytes at a time.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tl.row0 + r_in + 8 * h;
      const bool live = r < tl.row1;
      if constexpr (kSwiGLU) {
        // column groups 2j (gate) and 2j + 1 (up) give output columns 8j .. 8j + 7
        uint32_t hw[kBN / 16];
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          float hv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float gt = round_bf16(acc[8 * j + 2 * h + c]);
            const float up = round_bf16(acc[8 * j + 4 + 2 * h + c]);
            hv[c] = round_bf16(gt / (1.0f + expf(-gt))) * up;
          }
          hw[j] = pack_bf16(hv[0], hv[1]);
        }
        __nv_bfloat16* out = y + static_cast<int64_t>(r) * (N / 2) + tl.n0 / 2 + 8 * q;
#pragma unroll
        for (int j = 0; j < kBN / 16; j += 4) {
          const uint4 v = quad_transpose(hw[j], hw[j + 1], hw[j + 2], hw[j + 3], q);
          if (live) *reinterpret_cast<uint4*>(out + 8 * j) = v;
        }
      } else {
        __nv_bfloat16* out = y + static_cast<int64_t>(r) * N + tl.n0 + 8 * q;
#pragma unroll
        for (int j = 0; j < kBN / 8; j += 4) {
          const uint4 v = quad_transpose(pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]),
                                         pack_bf16(acc[4 * j + 4 + 2 * h], acc[4 * j + 5 + 2 * h]),
                                         pack_bf16(acc[4 * j + 8 + 2 * h], acc[4 * j + 9 + 2 * h]),
                                         pack_bf16(acc[4 * j + 12 + 2 * h], acc[4 * j + 13 + 2 * h]),
                                         q);
          if (live) *reinterpret_cast<uint4*>(out + 8 * j) = v;
        }
      }
    }
  }
}

// A [rows, cols] bf16 row-major matrix read in boxes of box_rows rows x 64
// values, zeros past its last row.
bool encode(CUtensorMap* map, const void* base, int64_t rows, int64_t cols, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kSwiGLU, int kBN>
cudaError_t launch(const void* x, const void* w, const void* offsets, int64_t E, int64_t R,
                   int64_t K, int64_t N, void* y, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!encode(&map_x, x, R, K, kBM) || !encode(&map_w, w, E * N, K, kBN)) {
    return cudaErrorInvalidValue;
  }
  // the ring, its barriers, the offsets and the tiles' prefix, 1024-aligned
  const int64_t smem = Ring<kBN>::kBytes + 1024 + 16 * kStages + 8 * (E + 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = moe_grouped_gemm_kernel<kSwiGLU, kBN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  // at most R / 128 + E tiles of rows, whatever the offsets
  const int64_t tiles = ((R + kBM - 1) / kBM + std::min(E, R)) * (N / kBN);
  const auto grid = static_cast<unsigned>(std::min<int64_t>(sms, tiles));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      map_x, map_w, static_cast<const int32_t*>(offsets), static_cast<int>(E),
      static_cast<int>(K), static_cast<int>(N), static_cast<__nv_bfloat16*>(y));
  return cudaGetLastError();
}

}  // namespace

// x [R, K], w [E, N, K], offsets [E + 1], y [R, N] (or [R, N / 2] with
// swiglu); K a multiple of 64, N of 128, pointers 16-byte aligned. Returns
// cudaErrorInvalidValue where a tensor map cannot be made or the offsets do
// not fit in shared memory beside the ring (E past ~8,000).
extern "C" int ircl_moe_grouped_gemm(const void* x, const void* w, const void* offsets,
                                     int64_t E, int64_t R, int64_t K, int64_t N,
                                     int64_t swiglu, void* y, void* stream) {
  if (R <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N % 256 == 0) {
    err = swiglu ? launch<true, 256>(x, w, offsets, E, R, K, N, y, st)
                 : launch<false, 256>(x, w, offsets, E, R, K, N, y, st);
  } else {
    err = swiglu ? launch<true, 128>(x, w, offsets, E, R, K, N, y, st)
                 : launch<false, 128>(x, w, offsets, E, R, K, N, y, st);
  }
  return static_cast<int>(err);
}
