// Heavy dot fused into the light add + tile top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `fused` of
// scripts/probe_fused_dot_light.py. The slab M [U, N] and the query slab
// W [U, B] arrive split outside the kernel into bf16 halves (hi = bf16(x),
// lo = bf16(x - hi)), and per (d-tile, column b):
//
//   h[d, b]  = sum_u mh[u,d]*wh[u,b] + sum_u ml[u,d]*wh[u,b] + sum_u mh[u,d]*wl[u,b]
//   H'[d, b] = h[d, b] + sum_p contribs[p, b] * (docs[p, b] == d)
//
// then the k largest H' of the tile with their rows, best first, ties to the
// largest row, entries k..k8-1 at -3.4e38 / -1: light_add_topk_t's outputs,
// without the scores [N, B] ever reaching device memory.
//
// Bound on this card: operations, 3 * 2 * U * N * B at the bf16 tensor rate
// (10.3 TFLOP at the probe's shape U=8192, N=51200, B=4096: 10.4 ms at 989
// TFLOP/s).
//
// Design. A block owns one d-tile and 256 columns and walks the tile in
// sub-tiles of 128 docs, from the last to the first. Three warpgroups:
// - a producer (one thread) fills a ring of 3 shared-memory stages with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion): a stage
//   is 32 union rows of mh, ml [32 x 128 docs] and wh, wl [32 x 256], as 12
//   boxes of 32 rows x 64 values. Both slabs are u-major, so the tiles land
//   MN-major (a union row of 64 values in each 128-byte line), the layout
//   wgmma reads with its transpose bits set. Union rows past U and columns
//   past B are filled with zeros by the TMA unit: neither needs padding;
// - two consumers, docs 0-63 and 64-127 of the sub-tile, each summing a
//   64 x 256 f32 tile with wgmma.mma_async.m64n256k16 (both operands from
//   shared memory): per 16 union rows, mh.wh, ml.wh and mh.wl into ONE
//   accumulator of 128 registers a thread. A product of two bf16 values is
//   exact in f32, so the kernel differs from its plain version only in the
//   order of the f32 sums: one sum over the 3U products instead of hi.hi +
//   (lo.hi + hi.lo) (chip_smoke.py phase 16 holds it to the probe's bound).
//   A consumer releases a stage once the products reading it are done, one
//   group of products stays in flight.
// - The epilogue: a consumer writes its accumulators into a 64 x 256 f32
//   tile of shared memory (XOR-swizzled, so the writes and the column reads
//   are free of bank conflicts), the upper half of the sub-tile first, and
//   all 256 consumer threads, one a column, walk its rows downward: the pool
//   run add (PoolCursor) and the best-8 list in registers (RegisterTopK,
//   topk_registers.cuh), kept across the tile's sub-tiles. For k > 8 the
//   list is ColumnTopK's (topk_columns.cuh), in the output rows. The
//   producer runs up to 3 stages ahead meanwhile.
// 208 KB of shared memory, one block an SM; the consumers take 232 registers
// a thread and the producer 40 (setmaxnreg).
//
// What bounds it: the tensor cores and L2. A stage feeds 2 x 3 products of
// 64 x 256 x 32 (3.1 MFLOP) from 48 KB, 64 FLOP a byte of L2 traffic; at the
// probe's shape M's halves are read once a 256-column block (16 times,
// 27 GB) and W's once a 128-doc sub-tile (400 times, 54 GB). Measured there
// on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 16): 12.9 ms, 800
// TFLOP/s, 0.81 of the bound, and those 81 GB at 6.3 TB/s from L2; the
// epilogue and the pools take 0.05 ms of it (tools/kernels_in_turns.py,
// empty pools).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "topk_columns.cuh"
#include "topk_registers.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int kBM = 128;       // docs per sub-tile; d_tile must be a multiple
constexpr int kBN = 256;       // columns per block
constexpr int kBK = 32;        // union rows per stage
constexpr int kStages = 3;
constexpr int kBox = 64;       // values in a TMA box's 128-byte line
constexpr int kThreads = 384;  // producer, consumer (docs 0-63), consumer (64-127)
constexpr int kConsumers = 256;
constexpr int kList = 8;       // the register list's length: k <= kList
constexpr int kHalf = kBox * kBK * 2;                // one box: 4 KB
constexpr int kStageM = 2 * kHalf;                   // a slab half's two boxes
constexpr int kStageW = 4 * kHalf;                   // a query half's four
constexpr int kStageBytes = 2 * kStageM + 2 * kStageW;  // 48 KB
constexpr int kScoreBytes = 64 * kBN * 4;            // 64 x 256 f32
constexpr int kSmemBytes = kStages * kStageBytes + kScoreBytes + 64 + 1024;

// Descriptor of an MN-major operand in the 128-byte swizzle: union rows of
// 128 bytes, groups of 8 rows 1024 bytes apart (SBO), groups of 64 values
// `lbo` bytes apart (LBO). Every operand starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t mn_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// Score tile [64][256] f32: element (r, c) at r * 256 + (c ^ (r % 8) * 8).
__device__ __forceinline__ int score_at(int r, int c) { return r * kBN + (c ^ ((r & 7) << 3)); }

template <bool kRegList>
__global__ void __launch_bounds__(kThreads, 1)
fused_dot_light_kernel(const __grid_constant__ CUtensorMap map_mh,
                       const __grid_constant__ CUtensorMap map_ml,
                       const __grid_constant__ CUtensorMap map_wh,
                       const __grid_constant__ CUtensorMap map_wl, int64_t U, int64_t B,
                       const int32_t* __restrict__ docs,
                       const float* __restrict__ contribs, int64_t P, int64_t d_tile,
                       int k, int k8, float* __restrict__ out_s,
                       int32_t* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  float* sc = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kScoreBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t tile = blockIdx.y;
  const int64_t d_base = tile * d_tile;
  const int n_sub = static_cast<int>(d_tile / kBM);
  const int n_k = static_cast<int>((U + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int sub = n_sub - 1; sub >= 0; --sub) {
        const int d0 = static_cast<int>(d_base + sub * kBM);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          mbar_wait(empty0 + 8 * s, phase ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect(full, kStageBytes);
          const uint32_t st = smem_u32(smem + s * kStageBytes);
          const int u0 = kt * kBK;
          for (int c = 0; c < 2; ++c) {
            tma_load(st + c * kHalf, &map_mh, d0 + c * kBox, u0, full);
            tma_load(st + kStageM + c * kHalf, &map_ml, d0 + c * kBox, u0, full);
          }
          for (int c = 0; c < 4; ++c) {
            const int x = static_cast<int>(b0) + c * kBox;
            tma_load(st + 2 * kStageM + c * kHalf, &map_wh, x, u0, full);
            tma_load(st + 2 * kStageM + kStageW + c * kHalf, &map_wl, x, u0, full);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = threadIdx.x - 128;  // consumer thread: its epilogue column
  const int wg = ct >> 7;            // docs 64 * wg .. of each sub-tile
  const int64_t b = b0 + ct;
  const bool live = b < B;

  ircl::RegisterTopK<kList> top;
  ircl::PoolCursor cur;
  const int32_t* win_d = docs;  // the column's pool window
  const float* win_c = contribs;
  ircl::ColumnTopK wide;
  if (live) {
    if constexpr (kRegList) {
      top.clear();
      const int64_t col[2] = {b, b}, lo[2] = {0, 0}, hi[2] = {P, P};
      const int64_t v[2] = {d_base, d_base + d_tile};
      int64_t pos[2];
      ircl::lower_bounds<2>(docs, B, col, lo, hi, v, pos);
      win_d += pos[0] * B + b;
      win_c += pos[0] * B + b;
      cur.begin(win_d, win_c, B, static_cast<int32_t>(pos[1] - pos[0]));
    } else {
      wide.begin(docs, contribs, P, B, b, d_base, d_base + d_tile,
                 out_s + tile * k8 * B + b, out_i + tile * k8 * B + b, k);
    }
  }

  const int w = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, q = lane & 3;
  int it = 0;
  for (int sub = n_sub - 1; sub >= 0; --sub) {
    const int64_t d0 = d_base + sub * kBM;
    float acc[128];
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const unsigned char* st = smem + s * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int row = kk * 16 * kBox * 2;  // 16 union rows further
        const uint64_t ah = mn_desc(st + wg * kHalf + row, kHalf);
        const uint64_t al = mn_desc(st + kStageM + wg * kHalf + row, kHalf);
        const uint64_t bh = mn_desc(st + 2 * kStageM + row, kHalf);
        const uint64_t bl = mn_desc(st + 2 * kStageM + kStageW + row, kHalf);
        wgmma_m64n256k16<true>(acc, ah, bh, kt > 0 || kk > 0);
        wgmma_m64n256k16<true>(acc, al, bh, 1);
        wgmma_m64n256k16<true>(acc, ah, bl, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // the epilogue: docs 64-127 of the sub-tile, then 0-63, rows downward
    for (int half = 1; half >= 0; --half) {
      if (wg == half) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            *reinterpret_cast<float2*>(sc + score_at(r, 8 * j + 2 * q)) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
      consumers_sync();
      if (live) {
        for (int r = 63; r >= 0; --r) {
          const int64_t d = d0 + 64 * half + r;
          const float x = sc[score_at(r, ct)];
          if constexpr (kRegList) {
            top.push_descending(cur.add(win_d, win_c, B, static_cast<int32_t>(d), x),
                                static_cast<int32_t>(d));
          } else {
            wide.add_row(d, x);
          }
        }
      }
      consumers_sync();
    }
  }
  if (live) {
    if constexpr (kRegList) {
      top.write(k, k8, out_s + tile * k8 * B + b, out_i + tile * k8 * B + b, B);
    } else {
      wide.finish(k8);
    }
  }
}

// A [rows, cols] bf16 row-major matrix read in boxes of kBK rows x 64 values.
bool encode(CUtensorMap* map, const void* base, int64_t rows, int64_t cols) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, kBK};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
             strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kRegList>
cudaError_t launch(const CUtensorMap (&maps)[4], int64_t U, int64_t B, const int32_t* docs,
                   const float* contribs, int64_t P, int64_t d_tile, int64_t n_dt, int k,
                   int k8, float* out_s, int32_t* out_i, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fused_dot_light_kernel<kRegList>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((B + kBN - 1) / kBN), static_cast<unsigned>(n_dt));
  fused_dot_light_kernel<kRegList><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], U, B, docs, contribs, P, d_tile, k, k8, out_s,
      out_i);
  return cudaGetLastError();
}

}  // namespace

// m_hi/m_lo [U, N] bf16, w_hi/w_lo [U, B] bf16, docs_t/contribs_t [P, B]
// i32/f32 doc-ascending along P, out_s/out_i [N / d_tile * k8, B]; all
// contiguous, the bf16 ones 16-byte aligned. Needs U >= 1, B % 8 == 0,
// N % d_tile == 0, d_tile % 128 == 0, 1 <= k <= d_tile and N / d_tile <=
// 65535 (the wrapper checks). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue where a tensor map cannot be made.
extern "C" int ircl_fused_dot_light(const void* m_hi, const void* m_lo, int64_t U,
                                    int64_t N, const void* w_hi, const void* w_lo,
                                    int64_t B, const void* docs_t,
                                    const void* contribs_t, int64_t P, int64_t d_tile,
                                    int64_t k, void* out_s, void* out_i,
                                    void* stream) {
  const int64_t n_dt = N / d_tile;
  const int64_t k8 = (k + 7) / 8 * 8;
  if (B <= 0 || n_dt <= 0 || U <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap maps[4];
  if (!encode(&maps[0], m_hi, U, N) || !encode(&maps[1], m_lo, U, N) ||
      !encode(&maps[2], w_hi, U, B) || !encode(&maps[3], w_lo, U, B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto docs = static_cast<const int32_t*>(docs_t);
  const auto contribs = static_cast<const float*>(contribs_t);
  const auto s = static_cast<float*>(out_s);
  const auto i = static_cast<int32_t*>(out_i);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      k <= kList ? launch<true>(maps, U, B, docs, contribs, P, d_tile, n_dt,
                                static_cast<int>(k), static_cast<int>(k8), s, i, st)
                 : launch<false>(maps, U, B, docs, contribs, P, d_tile, n_dt,
                                 static_cast<int>(k), static_cast<int>(k8), s, i, st);
  return static_cast<int>(e);
}
