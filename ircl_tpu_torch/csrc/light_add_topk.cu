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
// Design. One thread owns one (d-tile, column) pair; H_T is read once and
// H' never goes back to memory. The pools are doc-ascending along P, so the
// thread finds its tile's pool window [#(doc < d0), #(doc < d0 + d_tile))
// by two binary searches down its column, as the TPU's searchsorted pre-pass
// did for a whole b-tile. Pads (doc = n_pad, or anything outside the tile)
// fall outside every window and are never read. The thread walks its rows
// from the last to the first, eight loads ahead. Each row's total is H_T
// plus the run of pool entries for that doc, summed in pool order, which is
// the order of the Pallas loop: the totals are bit-identical. The row then
// enters a best-first list kept in the thread's own output rows. Because
// rows arrive in descending order, a strict compare keeps the larger row
// ahead on a tie, which is the Pallas rule, so rows match it too. After the
// first k rows a row enters the list only if it beats the k-th score, held
// in a register, so the list is rarely touched.
//
// Bound on this card: memory, one read of H_T (N_pad*B*4 bytes: 0.84 GB at
// the 50K-doc bench shape with B = 4096, 0.25 ms at 3.35 TB/s). The loads
// are coalesced across the 128 columns of a block; eight independent loads
// per thread keep enough bytes in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -3.4e38f;
constexpr int kRowsAhead = 8;  // d_tile must be a multiple of this
constexpr int kThreads = 128;

__device__ __forceinline__ int64_t column_lower_bound(
    const int32_t* __restrict__ docs, int64_t P, int64_t B, int64_t b,
    int64_t v) {
  int64_t lo = 0, hi = P;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(docs[mid * B + b]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void light_add_topk_kernel(const float* __restrict__ h,
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
  const int64_t p_lo = column_lower_bound(docs, P, B, b, d0);
  // Pool entries [p_lo, q) belong to rows not yet visited.
  int64_t q = column_lower_bound(docs, P, B, b, d0 + d_tile);
  int64_t next_doc = q > p_lo ? docs[(q - 1) * B + b] : -1;

  float* s = out_s + tile * k8 * B + b;  // list entry r at s[r * B]
  int32_t* rows = out_i + tile * k8 * B + b;
  int filled = 0;
  float kth = 0.0f;  // k-th best score, once the list is full

  for (int64_t top = d0 + d_tile - 1; top >= d0; top -= kRowsAhead) {
    float v[kRowsAhead];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) v[i] = h[(top - i) * B + b];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) {
      const int64_t d = top - i;
      float x = v[i];
      if (next_doc == d) {
        const int64_t run_end = q;
        while (q > p_lo && docs[(q - 1) * B + b] == d) --q;
        for (int64_t p = q; p < run_end; ++p) x += contribs[p * B + b];
        next_doc = q > p_lo ? docs[(q - 1) * B + b] : -1;
      }
      int j;
      if (filled < k) {
        j = filled++;
      } else if (x > kth) {
        j = k - 1;  // the old k-th drops out
      } else {
        continue;
      }
      while (j > 0 && x > s[(j - 1) * B]) {
        s[j * B] = s[(j - 1) * B];
        rows[j * B] = rows[(j - 1) * B];
        --j;
      }
      s[j * B] = x;
      rows[j * B] = static_cast<int32_t>(d);
      if (filled == k) kth = s[(k - 1) * B];
    }
  }
  for (int r = k; r < k8; ++r) {
    s[r * B] = kNeg;
    rows[r * B] = -1;
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
  if (B > 0 && n_dt > 0) {
    const dim3 grid(static_cast<unsigned>((B + kThreads - 1) / kThreads),
                    static_cast<unsigned>(n_dt));
    light_add_topk_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h_t), static_cast<const int32_t*>(docs_t),
        static_cast<const float*>(contribs_t), B, P, d_tile,
        static_cast<int>(k), static_cast<int>(k8),
        static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
