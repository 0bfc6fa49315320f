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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One box of the map at (x = value, y = union row) into dst; completion is
// counted on bar in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x,
                                         int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d [64 x 256] (+)= A [64 x 16] . B [16 x 256], both bf16 and MN-major in
// shared memory (the two transpose bits set), f32 sums; add = 0 overwrites d.
// Thread t of warp w of the warpgroup, g = t / 4, q = t % 4, holds d[4j + 2h +
// c] = element (16w + g + 8h, 8j + 2q + c).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                 int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(add));
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
        wgmma_m64n256k16(acc, ah, bh, kt > 0 || kk > 0);
        wgmma_m64n256k16(acc, al, bh, 1);
        wgmma_m64n256k16(acc, ah, bl, 1);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up in libcuda through the runtime, so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess)
      p = nullptr;
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
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
