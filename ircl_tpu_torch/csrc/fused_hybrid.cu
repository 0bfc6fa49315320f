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
// A block owns one d-tile and 128 columns, one column a thread, and walks the
// tile in chunks of 64 docs from the last to the first:
//   1. 64 threads take one doc each and find every ELL term's slots in
//      u_sorted by binary search (the first equal slot and the length of the
//      run of equal slots: a union padded with copies of its last value
//      matches every copy, as the compare contract does, and a padded copy's
//      wt row is zero). Terms absent from the union and -1 pads leave no
//      trace. The hits (slot, run length, value) go to shared memory, a
//      column per doc, with the doc's hit count.
//   2. Every thread walks the 64 docs downward: h = sum over the doc's hits
//      of value * wt[slot, b], the 128 lanes reading 512 consecutive bytes of
//      one wt row, in ELL order (ascending slots, the order of a slab
//      product); then the row goes to ColumnTopK (topk_columns.cuh), which
//      adds the doc's light pool run and keeps the tile's best k.
// The work is 2 * hits * B operations and hits * B * 4 bytes of wt from L2,
// where hits counts the ELL terms present in this batch's union.
//
// Bound on this card: memory. wt (U*B*4 bytes) stays in the 50 MB L2; the
// ELL rows are read once per 128 columns. See PERF.md for the two bounds
// (the dense work the TPU kernel did, and the work the function needs).

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_columns.cuh"

namespace {

constexpr int kCols = 128;  // columns (threads) per block
constexpr int kDocs = 64;   // docs per chunk; d_tile must be a multiple

__global__ void __launch_bounds__(kCols)
fused_hybrid_kernel(const int32_t* __restrict__ terms, const float* __restrict__ vals,
                    int64_t K, int64_t N, const int32_t* __restrict__ u_sorted,
                    int64_t U, const float* __restrict__ wt, int64_t B,
                    const int32_t* __restrict__ docs,
                    const float* __restrict__ contribs, int64_t P, int64_t d_tile,
                    int64_t base, int k, int k8, float* __restrict__ out_s,
                    int32_t* __restrict__ out_i) {
  extern __shared__ int32_t smem_i[];
  int32_t* hit_slot = smem_i;               // [K][kDocs]
  int32_t* hit_len = hit_slot + K * kDocs;  // [K][kDocs]
  float* hit_val = reinterpret_cast<float*>(hit_len + K * kDocs);
  int32_t* hit_count = reinterpret_cast<int32_t*>(hit_val + K * kDocs);  // [kDocs]

  const int64_t b = blockIdx.x * static_cast<int64_t>(kCols) + threadIdx.x;
  const bool active = b < B;  // idle threads still search and synchronize
  const int64_t tile = blockIdx.y;
  const int64_t row0 = tile * d_tile;  // first doc of the tile, bucket-local
  ircl::ColumnTopK top;
  if (active) {
    top.begin(docs, contribs, P, B, b, base + row0, base + row0 + d_tile,
              out_s + tile * k8 * B + b, out_i + tile * k8 * B + b, k);
  }

  for (int64_t c0 = row0 + d_tile - kDocs; c0 >= row0; c0 -= kDocs) {
    if (threadIdx.x < kDocs) {
      const int dl = threadIdx.x;
      const int64_t d = c0 + dl;
      int n = 0;
      for (int64_t kk = 0; kk < K; ++kk) {
        const int32_t t = terms[kk * N + d];
        if (t < 0) continue;  // ELL pad
        int64_t lo = 0, hi = U;  // lower bound of t in u_sorted
        while (lo < hi) {
          const int64_t mid = (lo + hi) >> 1;
          if (__ldg(u_sorted + mid) < t) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        int32_t len = 0;  // every slot equal to t matches
        while (lo + len < U && __ldg(u_sorted + lo + len) == t) ++len;
        if (len > 0) {
          hit_slot[n * kDocs + dl] = static_cast<int32_t>(lo);
          hit_len[n * kDocs + dl] = len;
          hit_val[n * kDocs + dl] = vals[kk * N + d];
          ++n;
        }
      }
      hit_count[dl] = n;
    }
    __syncthreads();
    if (active) {
      for (int dl = kDocs - 1; dl >= 0; --dl) {
        const int n = hit_count[dl];
        float h = 0.0f;
        for (int j = 0; j < n; ++j) {
          const float v = hit_val[j * kDocs + dl];
          const float* w = wt + static_cast<int64_t>(hit_slot[j * kDocs + dl]) * B + b;
          const int len = hit_len[j * kDocs + dl];
          for (int r = 0; r < len; ++r) h = fmaf(v, w[r * B], h);
        }
        top.add_row(base + c0 + dl, h);
      }
    }
    __syncthreads();
  }
  if (active) top.finish(k8);
}

}  // namespace

// terms/vals [K, N] i32/f32, u_sorted [U] i32 ascending, wt [U, B] f32,
// docs_t/contribs_t [P, B] i32/f32 doc-ascending along P, out_s/out_i
// [N / d_tile * k8, B]. Needs N % d_tile == 0, d_tile % 64 == 0,
// 1 <= k <= d_tile, N / d_tile <= 65535 and K * 768 + 256 bytes of shared
// memory within the card's 227 KB (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int ircl_fused_hybrid(const void* terms, const void* vals, int64_t K,
                                 int64_t N, const void* u_sorted, int64_t U,
                                 const void* wt, int64_t B, const void* docs_t,
                                 const void* contribs_t, int64_t P, int64_t d_tile,
                                 int64_t base, int64_t k, void* out_s, void* out_i,
                                 void* stream) {
  const int64_t n_dt = N / d_tile;
  const int64_t k8 = (k + 7) / 8 * 8;
  if (B <= 0 || n_dt <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(int32_t) * (3 * K * kDocs + kDocs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_hybrid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((B + kCols - 1) / kCols),
                  static_cast<unsigned>(n_dt));
  fused_hybrid_kernel<<<grid, kCols, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(terms), static_cast<const float*>(vals), K, N,
      static_cast<const int32_t*>(u_sorted), U, static_cast<const float*>(wt), B,
      static_cast<const int32_t*>(docs_t), static_cast<const float*>(contribs_t), P,
      d_tile, base, static_cast<int>(k), static_cast<int>(k8),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
