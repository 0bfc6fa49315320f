// Light-pool add + per-tile top-k of the hybrid engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel ircl_tpu/ops/light_add_pallas.py::
// _light_add_topk_kernel, with its XLA pre-pass _window_bounds:
//
//   H'[d, b] = H_T[d, b] + sum_p contribs[p, b] * (docs[p, b] == d)
//
// then, for every d-tile of d_tile rows and every column b, the k largest
// H' with their global rows, best first. Ties go to the LARGEST row, the
// Pallas rule. Rows k..k8-1 of each tile (k8 = k rounded up to 8) hold
// -3.4e38 / -1. Output: scores and rows, each [n_dt * k8, B].
//
// Bound on this card: memory, one read of H_T (N_pad*B*4 bytes: 0.84 GB at
// the 50K-doc bench shape with B = 4096, 0.25 ms at 3.35 TB/s). H_T is read
// once and H' never goes back to memory.
//
// Design for k <= 8 (the main path has k = 5), where B % 4 == 0 and H_T is
// 16-byte aligned. A block of 8 warps owns 64 columns of a share of the
// d-tiles (one wave of blocks; block (x, y) takes tiles y, y + gridDim.y,
// ...). Warp w owns the w-th eighth of each tile's rows (a row group) and
// streams it, from the last row to the first, through a ring of 3 stages in
// shared memory: a stage is 8 rows x 64 columns, a bulk async copy
// (cp.async.bulk, mbarrier completion) a 256-byte row piece, refilled as
// soon as the warp has used it, and the ring runs on from one tile into
// the next, so the next tile's rows arrive while a tile's lists merge.
// A lane keeps two columns: for each, the pool window of its rows and a
// list of the best k (score, row) pairs in registers (PoolCursor and
// RegisterTopK, topk_registers.cuh; the list's length is a template
// parameter, one kernel for each k). The warp's pool windows are copied to
// shared memory when they fit, and the cursor holds the next run in
// registers, so a row's run add waits for no memory. The run is added to
// the row's score in pool order, as the Pallas loop adds it, so the totals
// are bit-equal to the plain version's. After a tile the 8 groups' lists
// meet in shared memory and one thread a column merges them with the tie
// rule (score, then the larger row) and writes the first k and the pads.
//
// What holds it (tools/kernels_in_turns.py's ablations on the judged
// configuration's H_T, H100 80GB HBM3 at 700 W): the stream alone (scores of
// -inf, no pools) takes 0.32 ms against 0.29 for torch.amax over the same
// tiles, the pools add about 0.05 and the lists 0.11 (0.49 in all). A list
// insert is a compare-and-select network of about six instructions an
// entry, and with 64 columns a warp some lane inserts on nearly every row,
// so the warp runs the network on most rows.
//
// For k > 8, or B % 4 != 0, one thread owns a (d-tile, column) pair and
// hands its rows, last first, to ColumnTopK (topk_columns.cuh), whose list
// lives in the output rows: any k up to d_tile, at a lower rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_columns.cuh"
#include "topk_registers.cuh"

namespace {

constexpr int kGroups = 8;     // row groups of a d-tile: one a warp
constexpr int kCols = 64;      // columns a block: two a lane, 256 bytes of a row
constexpr int kRows = 8;       // rows a stage
constexpr int kStages = 3;     // stages a warp's ring
constexpr int kList = 8;       // the register list's longest: k <= kList
constexpr int kPoolCache = 64;  // pool entries a warp copies to shared memory
constexpr int kThreads = 32 * kGroups;
constexpr int kRingBytes = kGroups * kStages * kRows * kCols * 4;  // 48 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The rows last, last - 1, ... (those at or above lo, at most kRows) of the
// block's columns into one stage: a bulk copy a row, counted on bar.
__device__ __forceinline__ void fill_stage(float* stage, uint32_t bar, const float* h,
                                           int64_t B, int64_t col0, uint32_t bytes,
                                           int32_t last, int32_t lo) {
  const int n = min(kRows, last - lo + 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(n * bytes) : "memory");
  for (int r = 0; r < n; ++r) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stage + r * kCols)), "l"(h + (last - r) * B + col0), "r"(bytes),
           "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void wait_stage(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Needs B % 4 == 0 and a 16-byte aligned H_T (each row piece a bulk copy).
// Block (x, y) owns columns [64x, 64x + 64) of the d-tiles y, y + gridDim.y,
// ...; a warp's ring runs on across them.
template <int KR>
__global__ void __launch_bounds__(kThreads)
light_add_topk_rows_kernel(const float* __restrict__ h, const int32_t* __restrict__ docs,
                           const float* __restrict__ contribs, int64_t B, int64_t P,
                           int64_t d_tile, int64_t n_dt, int k8, float* __restrict__ out_s,
                           int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kGroups][kStages];
  __shared__ int32_t cache_d[kGroups][kPoolCache];
  __shared__ float cache_c[kGroups][kPoolCache];
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(smem) + group * kStages * kRows * kCols;
  float* list_s = reinterpret_cast<float*>(smem + kRingBytes);  // [kGroups][KR][kCols]
  int32_t* list_r = reinterpret_cast<int32_t*>(list_s + kGroups * KR * kCols);

  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int64_t c0 = col0 + 2 * lane;
  const bool live = c0 < B;  // B is even, so a lane's two columns are both in
  const uint32_t bytes = static_cast<uint32_t>((B - col0 < kCols ? B - col0 : kCols) * 4);
  const int32_t rows = static_cast<int32_t>(d_tile / kGroups);
  const int n_batch = (rows + kRows - 1) / kRows;  // a d-tile's stages a warp
  const int n_tiles = static_cast<int>((n_dt - blockIdx.y + gridDim.y - 1) / gridDim.y);
  const int n_all = n_tiles * n_batch;
  // stage i of the warp's stream: batch i % n_batch of its group in the
  // block's (i / n_batch)-th d-tile
  auto fill = [&](int i) {
    const int64_t tile = blockIdx.y + static_cast<int64_t>(i / n_batch) * gridDim.y;
    const int32_t lo = static_cast<int32_t>(tile * d_tile) + group * rows;
    fill_stage(ring + (i % kStages) * kRows * kCols, smem_u32(&full[group][i % kStages]), h,
               B, col0, bytes, lo + rows - 1 - (i % n_batch) * kRows, lo);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[group][s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < n_all; ++i) fill(i);
  }
  __syncwarp();

  int i = 0;  // the warp's stage count
  for (int64_t tile = blockIdx.y; tile < n_dt; tile += gridDim.y) {
    const int32_t g_lo = static_cast<int32_t>(tile * d_tile) + group * rows;
    const int32_t g_hi = g_lo + rows;
    ircl::RegisterTopK<KR> top[2];
    ircl::PoolCursor cur[2];
    top[0].clear();
    top[1].clear();
    // the group's pool windows, while the stages load; the warp's windows
    // are copied to shared memory when they fit, so that a row's run add
    // reads no device memory
    int64_t pos[4] = {0, 0, 0, 0};
    if (live) {
      const int64_t col[4] = {c0, c0, c0 + 1, c0 + 1}, lo[4] = {0, 0, 0, 0};
      const int64_t hi[4] = {P, P, P, P}, bound[4] = {g_lo, g_hi, g_lo, g_hi};
      ircl::lower_bounds<4>(docs, B, col, lo, hi, bound, pos);
    }
    const int32_t n0 = static_cast<int32_t>(pos[1] - pos[0]);
    const int32_t n1 = static_cast<int32_t>(pos[3] - pos[2]);
    int32_t end = n0 + n1;  // this lane's entries end at `end` of the warp's
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t up = __shfl_up_sync(0xffffffffu, end, o);
      if (lane >= o) end += up;
    }
    const bool cached = __shfl_sync(0xffffffffu, end, 31) <= kPoolCache;
    const int32_t* win_d[2] = {docs + pos[0] * B + c0, docs + pos[2] * B + c0 + 1};
    const float* win_c[2] = {contribs + pos[0] * B + c0, contribs + pos[2] * B + c0 + 1};
    int64_t stride = B;
    if (cached) {
      int32_t at = end - n0 - n1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int32_t n = j == 0 ? n0 : n1;
        for (int32_t p = 0; p < n; ++p) {
          cache_d[group][at + p] = win_d[j][p * B];
          cache_c[group][at + p] = win_c[j][p * B];
        }
        win_d[j] = &cache_d[group][at];
        win_c[j] = &cache_c[group][at];
        at += n;
      }
      stride = 1;
      __syncwarp();
    }
    cur[0].begin(win_d[0], win_c[0], stride, n0);
    cur[1].begin(win_d[1], win_c[1], stride, n1);

    for (int batch = 0; batch < n_batch; ++batch, ++i) {
      const int s = i % kStages;
      const float* stage = ring + s * kRows * kCols;
      wait_stage(smem_u32(&full[group][s]), (i / kStages) & 1);
      const int32_t last = g_hi - 1 - batch * kRows;
      if (live) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int32_t d = last - r;
          if (d >= g_lo) {
            const float2 x = *reinterpret_cast<const float2*>(stage + r * kCols + 2 * lane);
            top[0].push_descending(cur[0].add(win_d[0], win_c[0], stride, d, x.x), d);
            top[1].push_descending(cur[1].add(win_d[1], win_c[1], stride, d, x.y), d);
          }
        }
      }
      __syncwarp();  // every lane has used the stage: refill it
      if (lane == 0 && i + kStages < n_all) fill(i + kStages);
    }
    __syncwarp();  // the pool cache is free for the next tile

    // the groups' lists meet in shared memory; one thread a column merges
    // them while the other warps start the next tile
    __syncthreads();  // the previous tile's merge has read the lists
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < KR; ++e) {
        const int at = (group * KR + e) * kCols + 2 * lane + j;
        list_s[at] = top[j].s[e];
        list_r[at] = top[j].r[e];
      }
    }
    __syncthreads();
    const int64_t b = col0 + threadIdx.x;
    if (threadIdx.x < kCols && b < B) {
      ircl::RegisterTopK<KR> all;
      all.clear();
      for (int g = kGroups - 1; g >= 0; --g) {
#pragma unroll
        for (int e = 0; e < KR; ++e) {
          const int at = (g * KR + e) * kCols + threadIdx.x;
          all.push(list_s[at], list_r[at]);
        }
      }
      all.write(KR, k8, out_s + tile * k8 * B + b, out_i + tile * k8 * B + b, B);
    }
  }
}

constexpr int kColumnThreads = 128;

__global__ void light_add_topk_column_kernel(const float* __restrict__ h,
                                             const int32_t* __restrict__ docs,
                                             const float* __restrict__ contribs,
                                             int64_t B, int64_t P, int64_t d_tile,
                                             int k, int k8,
                                             float* __restrict__ out_s,
                                             int32_t* __restrict__ out_i) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int64_t tile = blockIdx.y;
  const int64_t d0 = tile * d_tile;
  ircl::ColumnTopK top;
  top.begin(docs, contribs, P, B, b, d0, d0 + d_tile, out_s + tile * k8 * B + b,
            out_i + tile * k8 * B + b, k);

  for (int64_t last = d0 + d_tile - 1; last >= d0; last -= kRows) {
    float v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = h[(last - i) * B + b];
#pragma unroll
    for (int i = 0; i < kRows; ++i) top.add_row(last - i, v[i]);
  }
  top.finish(k8);
}

template <int KR>
cudaError_t launch_rows(const float* h, const int32_t* docs, const float* contribs,
                        int64_t B, int64_t P, int64_t d_tile, int64_t n_dt, int k8,
                        float* out_s, int32_t* out_i, cudaStream_t stream) {
  constexpr int smem = kRingBytes + kGroups * KR * kCols * 8;
  cudaError_t e = cudaFuncSetAttribute(light_add_topk_rows_kernel<KR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, light_add_topk_rows_kernel<KR>, kThreads, smem);
  }
  if (e != cudaSuccess) return e;
  // one wave of blocks, each walking an equal share of the d-tiles
  const int64_t n_cb = (B + kCols - 1) / kCols;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t per_block = (n_dt * n_cb + resident - 1) / resident;
  const int64_t n_y = (n_dt + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(n_cb), static_cast<unsigned>(n_y));
  light_add_topk_rows_kernel<KR><<<grid, kThreads, smem, stream>>>(
      h, docs, contribs, B, P, d_tile, n_dt, k8, out_s, out_i);
  return cudaGetLastError();
}

cudaError_t launch_rows_k(const float* h, const int32_t* docs, const float* contribs,
                          int64_t B, int64_t P, int64_t d_tile, int64_t n_dt, int k,
                          int k8, float* out_s, int32_t* out_i, cudaStream_t stream) {
  switch (k) {
#define IRCL_LIST(KR)                                                                 \
  case KR:                                                                            \
    return launch_rows<KR>(h, docs, contribs, B, P, d_tile, n_dt, k8, out_s, out_i, \
                           stream);
    IRCL_LIST(1) IRCL_LIST(2) IRCL_LIST(3) IRCL_LIST(4)
    IRCL_LIST(5) IRCL_LIST(6) IRCL_LIST(7) IRCL_LIST(8)
#undef IRCL_LIST
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// h_t [n_pad, B] f32; docs_t/contribs_t [P, B] i32/f32, doc-ascending along
// P; out_s/out_i [n_pad / d_tile * k8, B]. Needs n_pad % d_tile == 0,
// d_tile % 8 == 0, 1 <= k <= d_tile and n_pad / d_tile <= 65535 (the
// wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int ircl_light_add_topk(const void* h_t, const void* docs_t,
                                   const void* contribs_t, int64_t n_pad,
                                   int64_t B, int64_t P, int64_t d_tile,
                                   int64_t k, void* out_s, void* out_i,
                                   void* stream) {
  const int64_t n_dt = n_pad / d_tile;
  const int64_t k8 = (k + 7) / 8 * 8;
  if (B <= 0 || n_dt <= 0) return static_cast<int>(cudaGetLastError());
  const auto h = static_cast<const float*>(h_t);
  const auto docs = static_cast<const int32_t*>(docs_t);
  const auto contribs = static_cast<const float*>(contribs_t);
  const auto s = static_cast<float*>(out_s);
  const auto i = static_cast<int32_t*>(out_i);
  const auto st = static_cast<cudaStream_t>(stream);
  if (k <= kList && B % 4 == 0 && reinterpret_cast<uintptr_t>(h_t) % 16 == 0) {
    return static_cast<int>(launch_rows_k(h, docs, contribs, B, P, d_tile, n_dt,
                                          static_cast<int>(k), static_cast<int>(k8), s, i,
                                          st));
  }
  const dim3 grid(static_cast<unsigned>((B + kColumnThreads - 1) / kColumnThreads),
                  static_cast<unsigned>(n_dt));
  light_add_topk_column_kernel<<<grid, kColumnThreads, 0, st>>>(
      h, docs, contribs, B, P, d_tile, static_cast<int>(k), static_cast<int>(k8), s, i);
  return static_cast<int>(cudaGetLastError());
}
