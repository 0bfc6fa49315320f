// One-pass fused hybrid scoring of one ELL bucket, for Hopper (sm_90a).
//
// Replaces the TPU kernel ircl_tpu/ops/fused_hybrid_pallas.py::_fused_kernel
// (fused_hybrid_tile_topk, with its XLA pre-passes _slab_windows and the pool
// window counts). For ELL rows terms/vals [K, N] (k-major, terms ascending
// per doc, pad -1), the sorted union u_sorted [U], the query slab wt [U, B]
// and doc-ascending pools docs/contribs [P, B]:
//
//   h[d, b] = sum_k vals[k, d] * sum_{u : u_sorted[u] == terms[k, d]} wt[u, b]
//   H'[d, b] = h[d, b] + sum_p contribs[p, b] * (docs[p, b] == base + d)
//
// then, for every d-tile of d_tile docs and every column b, the k largest H'
// with their global positions base + d, best first, ties to the largest
// position; entries k..k8-1 hold -3.4e38 / -1. Neither the slab M [U, N] nor
// the scores [N, B] ever reach device memory.
//
// Design. The TPU has no gather, so Pallas rebuilt the slab tile by
// comparing every union slot with every ELL row and multiplied it with wt on
// the matrix unit: 2*U*N*B operations, nearly all on zeros. Hopper gathers.
// A block owns one d-tile and 1024 columns (256 threads, 4 adjacent columns
// each, one 16-byte read of a wt row a thread), so at B <= 1024 each d-tile's
// ELL rows are read and searched once. It walks the tile in chunks of 32
// docs from the last to the first:
//   1. The block copies the chunk's ELL terms [K, 32] into shared memory
//      (coalesced 128-byte rows) beside the union, staged there once.
//   2. Each warp takes 4 of the docs, a doc at a time: its lanes search 32
//      terms at once in the union (the first equal slot and the length of
//      the run of equal slots: a union padded with copies of its last value
//      matches every copy, as the compare contract does, and a padded
//      copy's wt row is zero), and a ballot with a prefix count packs the
//      hits (slot, run length, value) in k order into the doc's column of
//      shared memory. Terms absent from the union and -1 pads leave no trace.
//   3. Every thread walks the 32 docs downward: for each of its 4 columns,
//      h = sum over the doc's hits of value * wt[slot, b], fp32 FMAs from 0 in
//      k order (ascending slots, the order of a slab product, and the order
//      of the kernel this one replaced: the bits are the same); then each
//      column's row goes to ColumnTopK (topk_columns.cuh), which adds the
//      doc's light pool run and keeps the tile's best k. A doc with no hit
//      and no pool entry in a thread's columns is skipped once every list of
//      its columns is full with a k-th of 0 or more: its score, 0, could
//      enter only past a negative k-th (the strict x > kth). A ballot marks
//      the chunk's docs with hits, so the walk jumps from hit to hit and to
//      the columns' next pool docs.
// The work is 2 * hits * B operations, hits * B * 4 bytes of wt from L2
// (where hits counts the ELL terms present in this batch's union), and the
// ELL rows once for every 1024 columns.
//
// Bound on this card: memory for the inputs read once (wt stays in the 50 MB
// L2); in practice the L2 reads of wt rows and the per-doc top-k bookkeeping
// of N * B (doc, column) pairs. See PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_columns.cuh"

namespace {

constexpr int kThreads = 256;           // threads a block
constexpr int kColsPerThread = 4;       // adjacent columns a thread (1 and 2: slower)
constexpr int kCols = kThreads * kColsPerThread;  // columns a block
constexpr int kDocs = 32;               // docs a chunk (a warp's lanes); d_tile a multiple
constexpr int kStride = kDocs + 1;      // staged term rows, padded off bank conflicts
constexpr int kWarps = kThreads / 32;
static_assert(kDocs == 32, "a chunk's hit marks are one ballot of a warp");
constexpr int64_t kMaxStagedU = 4096;   // union in shared memory up to 16 KB

// First slot in [0, U) whose id is not below t.
__device__ __forceinline__ int lower_bound(const int32_t* u, int U, int32_t t) {
  int lo = 0, hi = U;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
fused_hybrid_kernel(const int32_t* __restrict__ terms, const float* __restrict__ vals,
                    int64_t K, int64_t N, const int32_t* __restrict__ u_sorted,
                    int64_t U, const float* __restrict__ wt, int64_t B,
                    const int32_t* __restrict__ docs,
                    const float* __restrict__ contribs, int64_t P, int64_t d_tile,
                    int64_t base, int k, int k8, float* __restrict__ out_s,
                    int32_t* __restrict__ out_i) {
  extern __shared__ int32_t smem_i[];
  int32_t* hit_slot = smem_i;                // [K][kDocs]
  int32_t* hit_len = hit_slot + K * kDocs;   // [K][kDocs]
  float* hit_val = reinterpret_cast<float*>(hit_len + K * kDocs);
  int32_t* hit_count = reinterpret_cast<int32_t*>(hit_val + K * kDocs);  // [kDocs]
  int32_t* chunk_terms = hit_count + kDocs;  // [K][kStride]
  int32_t* staged_u = chunk_terms + K * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t b0 = blockIdx.x * static_cast<int64_t>(kCols) + kColsPerThread * tid;
  const bool active = b0 < B;  // B % 4 == 0: all the thread's columns or none
  const int64_t tile = blockIdx.y;
  const int64_t row0 = tile * d_tile;  // first doc of the tile, bucket-local
  const int n_u = static_cast<int>(U);

  const bool staged = U <= kMaxStagedU;
  if (staged) {
    for (int i = tid; i < n_u; i += kThreads) staged_u[i] = u_sorted[i];
  }
  const int32_t* u = staged ? staged_u : u_sorted;

  ircl::ColumnTopK top[kColsPerThread];
  if (active) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int64_t b = b0 + c;
      top[c].begin(docs, contribs, P, B, b, base + row0, base + row0 + d_tile,
                   out_s + tile * k8 * B + b, out_i + tile * k8 * B + b, k);
    }
  }

  for (int64_t c0 = row0 + d_tile - kDocs; c0 >= row0; c0 -= kDocs) {
    // 1. the chunk's terms, coalesced, into shared memory
    for (int64_t i = tid; i < K * kDocs; i += kThreads) {
      const int64_t kk = i / kDocs;
      const int dl = static_cast<int>(i % kDocs);
      chunk_terms[kk * kStride + dl] = terms[kk * N + c0 + dl];
    }
    __syncthreads();
    // 2. every lane searches; hits packed in k order by ballot
    for (int dl = warp; dl < kDocs; dl += kWarps) {
      int n = 0;
      for (int64_t kb = 0; kb < K; kb += 32) {
        const int64_t kk = kb + lane;
        const int32_t t = kk < K ? chunk_terms[kk * kStride + dl] : -1;
        int lo = 0, len = 0;
        if (t >= 0) {
          lo = lower_bound(u, n_u, t);
          while (lo + len < n_u && u[lo + len] == t) ++len;
        }
        const unsigned hits = __ballot_sync(0xffffffffu, len > 0);
        if (len > 0) {
          const int at = n + __popc(hits & ((1u << lane) - 1u));
          hit_slot[at * kDocs + dl] = lo;
          hit_len[at * kDocs + dl] = len;
          hit_val[at * kDocs + dl] = vals[kk * N + c0 + dl];
        }
        n += __popc(hits);
      }
      if (lane == 0) hit_count[dl] = n;
    }
    __syncthreads();
    // 3. the chunk's rows, downward, 4 columns a thread
    const unsigned hit_docs = __ballot_sync(0xffffffffu, hit_count[lane] > 0);
    if (active) {
      for (int dl = kDocs - 1; dl >= 0; --dl) {
        // A doc with no hit and no pool entry in these columns scores 0 and
        // changes no list that is full with a k-th of 0 or more (the strict
        // x > kth): go straight to the next doc that has a hit, or the
        // columns' next pool doc, while every list is so.
        bool every_doc = false;
        int64_t pool_doc = -1;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          every_doc |= top[c].filled < k || 0.f > top[c].kth;
          pool_doc = top[c].next_doc > pool_doc ? top[c].next_doc : pool_doc;
        }
        if (!every_doc) {
          const unsigned below = hit_docs & (0xffffffffu >> (31 - dl));
          const int hit_dl = below ? 31 - __clz(below) : -1;
          const int64_t pool_dl = pool_doc - (base + c0);  // <= dl; < 0: none here
          dl = pool_dl > hit_dl ? static_cast<int>(pool_dl) : hit_dl;
          if (dl < 0) break;
        }
        const int n = hit_count[dl];
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < n; ++j) {
          const float v = hit_val[j * kDocs + dl];
          const float* w = wt + static_cast<int64_t>(hit_slot[j * kDocs + dl]) * B + b0;
          const int len = hit_len[j * kDocs + dl];
          for (int r = 0; r < len; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(w + r * B);
            h.x = fmaf(v, x.x, h.x);
            h.y = fmaf(v, x.y, h.y);
            h.z = fmaf(v, x.z, h.z);
            h.w = fmaf(v, x.w, h.w);
          }
        }
        const int64_t d = base + c0 + dl;
        top[0].add_row(d, h.x);
        top[1].add_row(d, h.y);
        top[2].add_row(d, h.z);
        top[3].add_row(d, h.w);
      }
    }
    __syncthreads();  // the chunk's shared memory is read before it is refilled
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) top[c].finish(k8);
  }
}

}  // namespace

// terms/vals [K, N] i32/f32, u_sorted [U] i32 ascending, wt [U, B] f32 (16-byte
// aligned), docs_t/contribs_t [P, B] i32/f32 doc-ascending along P, out_s/out_i
// [N / d_tile * k8, B]. Needs N % d_tile == 0, d_tile % 32 == 0, B % 4 == 0,
// 1 <= k <= d_tile, U < 2^31, N / d_tile <= 65535 and
// 4 * (3 * K * 32 + 32 + K * 33 + (U <= 4096 ? U : 0)) bytes of shared memory
// within the card's 227 KB (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int ircl_fused_hybrid(const void* terms, const void* vals, int64_t K,
                                 int64_t N, const void* u_sorted, int64_t U,
                                 const void* wt, int64_t B, const void* docs_t,
                                 const void* contribs_t, int64_t P, int64_t d_tile,
                                 int64_t base, int64_t k, void* out_s, void* out_i,
                                 void* stream) {
  const int64_t n_dt = N / d_tile;
  const int64_t k8 = (k + 7) / 8 * 8;
  if (B <= 0 || n_dt <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(int32_t) * (3 * K * kDocs + kDocs + K * kStride +
                                         (U <= kMaxStagedU ? U : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_hybrid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((B + kCols - 1) / kCols),
                  static_cast<unsigned>(n_dt));
  fused_hybrid_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(terms), static_cast<const float*>(vals), K, N,
      static_cast<const int32_t*>(u_sorted), U, static_cast<const float*>(wt), B,
      static_cast<const int32_t*>(docs_t), static_cast<const float*>(contribs_t), P,
      d_tile, base, static_cast<int>(k), static_cast<int>(k8),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
