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
// H' never goes back to memory. The thread walks its rows from the last to
// the first, eight loads ahead, and hands each to ColumnTopK (the pool
// window, the run add and the best-first list of topk_columns.cuh, shared
// with the two fused kernels). Each row's total is H_T plus the run of pool
// entries for that doc, summed in pool order, which is the order of the
// Pallas loop: the totals are bit-identical, and so are the rows on ties.
//
// Bound on this card: memory, one read of H_T (N_pad*B*4 bytes: 0.84 GB at
// the 50K-doc bench shape with B = 4096, 0.25 ms at 3.35 TB/s). The loads
// are coalesced across the 128 columns of a block; eight independent loads
// per thread keep enough bytes in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_columns.cuh"

namespace {

constexpr int kRowsAhead = 8;  // d_tile must be a multiple of this
constexpr int kThreads = 128;

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
  ircl::ColumnTopK top;
  top.begin(docs, contribs, P, B, b, d0, d0 + d_tile, out_s + tile * k8 * B + b,
            out_i + tile * k8 * B + b, k);

  for (int64_t last = d0 + d_tile - 1; last >= d0; last -= kRowsAhead) {
    float v[kRowsAhead];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) v[i] = h[(last - i) * B + b];
#pragma unroll
    for (int i = 0; i < kRowsAhead; ++i) top.add_row(last - i, v[i]);
  }
  top.finish(k8);
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
