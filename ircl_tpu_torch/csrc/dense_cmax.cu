// Dense scores fused with a chunk-max epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel _cmax_kernel of ircl_tpu/ops/dense_topk_pallas.py
// (phase 1 of cosine_topk_fused). For queries Q [B, D] f32 and the
// transposed corpus C [D, M_pad] (f32 or bf16, zero-padded columns):
//
//   out[b, g] = max over the columns c of chunk g of  (c < m_real ? Q[b].C[:, c] : -inf)
//
// with chunk g of corpus tile t = g / npt (npt = m_tile / chunk) covering
//   "loop": columns g*chunk + i                    (contiguous)
//   "fold": columns t*m_tile + (g % npt) + npt*i   (strided by npt)
// for i in [0, chunk). The [B, M] score matrix is never written.
//
// Dot products, by mode (the Pallas kernel's precisions):
//   0  "highest": fp32 FMA over D.
//   1  "high3": bf16_3x by hand. hi = bf16(x), lo = bf16(x - hi), both
//      round-to-nearest-even like astype(bfloat16); the score is
//      hi.hi + (lo.hi + hi.lo), three dots each accumulated in fp32.
//   2  None / "default" on an f32 corpus: the bf16 1-pass dot, both sides
//      rounded to bf16.
//   3  bf16 corpus: queries rounded to bf16, the same 1-pass dot.
// A product of two bf16 values is exact in fp32, so every mode agrees with
// the plain version (chunk_max_ref) up to the fp32 summation order. No
// tensor cores: wgmma and TMA are later work.
//
// Design. One thread owns one output chunk g for a tile of QT queries. The
// block's QT queries (or their hi/lo splits) sit in shared memory; each
// thread walks its chunk's columns, loads the column's D values once
// (neighbouring threads hold neighbouring g, so under "fold" a warp reads 32
// consecutive columns: coalesced; "loop" reads chunk-strided and stays
// correct), and FMAs each value into QT running dots, reading the queries
// from shared memory as float4 broadcasts. The column max is kept in
// registers and written once per (query, chunk).
//
// Bound on this card: fp32 FMA throughput. At the bench shape (B=1024, D=128,
// M_pad=1,007,616) "highest" is 1.3e11 FMAs and "high3" three times that;
// the corpus (516 MB f32) is read once per query tile, but the query tiles
// of one column span run side by side (grid.x is the query tile), so most
// re-reads hit the 50 MB L2. On an H100 80GB HBM3 at 700 W, "high3"/fold
// took 25.0 ms there, about twice the 11.7 ms that 3.9e11 FMAs need at the
// published fp32 rate: 124 registers a thread leave 4 blocks (16 warps) on
// an SM, and each float4 of queries from shared memory feeds 12 FMAs.
// bf16 tensor cores (the hi/lo splits are bf16) are the next step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQT = 16;        // queries per block
constexpr int kThreads = 128;  // chunks per block

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Shared memory: kQT rows of d4 floats (D rounded up to 4, zero tail), one
// such array for modes 0/2/3 and two (hi, lo) for mode 1.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
dense_cmax_kernel(const float* __restrict__ queries, int64_t B, int64_t D,
                  const T* __restrict__ corpus_t, int64_t m_pad,
                  int64_t chunk, int64_t m_tile, int64_t m_real, int fold,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* q_hi = reinterpret_cast<float*>(smem4);
  const int64_t d4 = (D + 3) & ~int64_t(3);
  float* q_lo = q_hi + kQT * d4;  // used by mode 1 only

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kQT;
  for (int64_t idx = threadIdx.x; idx < kQT * d4; idx += blockDim.x) {
    const int64_t q = idx / d4, d = idx % d4;
    const float x = (b0 + q < B && d < D) ? queries[(b0 + q) * D + d] : 0.0f;
    if (MODE == 1) {
      const float hi = bf16_round(x);
      q_hi[idx] = hi;
      q_lo[idx] = bf16_round(x - hi);
    } else if (MODE == 0) {
      q_hi[idx] = x;
    } else {
      q_hi[idx] = bf16_round(x);
    }
  }
  __syncthreads();

  const int64_t nc = m_pad / chunk;
  const int64_t g = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (g >= nc) return;
  const int64_t npt = m_tile / chunk;
  const int64_t col0 = fold ? (g / npt) * m_tile + g % npt : g * chunk;
  const int64_t step = fold ? npt : 1;

  float best[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) best[q] = -CUDART_INF_F;

  for (int64_t i = 0; i < chunk; ++i) {
    const int64_t col = col0 + step * i;
    if (col >= m_real) continue;  // pad column: -inf, never the max
    const T* cp = corpus_t + col;
    float a1[kQT], a2[kQT], a3[kQT];
#pragma unroll
    for (int q = 0; q < kQT; ++q) a1[q] = a2[q] = a3[q] = 0.0f;
    for (int64_t d = 0; d < d4; d += 4) {
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = d + j < D ? load_as_float(cp + (d + j) * m_pad) : 0.0f;
      }
      if (MODE == 1) {
        float ch[4], cl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ch[j] = bf16_round(c[j]);
          cl[j] = bf16_round(c[j] - ch[j]);
        }
#pragma unroll
        for (int q = 0; q < kQT; ++q) {
          const float4 h = *reinterpret_cast<const float4*>(q_hi + q * d4 + d);
          const float4 l = *reinterpret_cast<const float4*>(q_lo + q * d4 + d);
          a1[q] = fmaf(h.x, ch[0], a1[q]);
          a1[q] = fmaf(h.y, ch[1], a1[q]);
          a1[q] = fmaf(h.z, ch[2], a1[q]);
          a1[q] = fmaf(h.w, ch[3], a1[q]);
          a2[q] = fmaf(l.x, ch[0], a2[q]);
          a2[q] = fmaf(l.y, ch[1], a2[q]);
          a2[q] = fmaf(l.z, ch[2], a2[q]);
          a2[q] = fmaf(l.w, ch[3], a2[q]);
          a3[q] = fmaf(h.x, cl[0], a3[q]);
          a3[q] = fmaf(h.y, cl[1], a3[q]);
          a3[q] = fmaf(h.z, cl[2], a3[q]);
          a3[q] = fmaf(h.w, cl[3], a3[q]);
        }
      } else {
        if (MODE == 2) {
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = bf16_round(c[j]);
        }
#pragma unroll
        for (int q = 0; q < kQT; ++q) {
          const float4 h = *reinterpret_cast<const float4*>(q_hi + q * d4 + d);
          a1[q] = fmaf(h.x, c[0], a1[q]);
          a1[q] = fmaf(h.y, c[1], a1[q]);
          a1[q] = fmaf(h.z, c[2], a1[q]);
          a1[q] = fmaf(h.w, c[3], a1[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      const float s = MODE == 1 ? a1[q] + (a2[q] + a3[q]) : a1[q];
      best[q] = fmaxf(best[q], s);
    }
  }
#pragma unroll
  for (int q = 0; q < kQT; ++q) {
    if (b0 + q < B) out[(b0 + q) * nc + g] = best[q];
  }
}

template <typename T, int MODE>
cudaError_t launch(const float* queries, int64_t B, int64_t D, const void* corpus_t,
                   int64_t m_pad, int64_t chunk, int64_t m_tile, int64_t m_real,
                   int fold, float* out, cudaStream_t stream) {
  const int64_t d4 = (D + 3) & ~int64_t(3);
  const size_t smem = sizeof(float) * kQT * d4 * (MODE == 1 ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_cmax_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t nc = m_pad / chunk;
  const dim3 grid(static_cast<unsigned>((B + kQT - 1) / kQT),
                  static_cast<unsigned>((nc + kThreads - 1) / kThreads));
  dense_cmax_kernel<T, MODE><<<grid, kThreads, smem, stream>>>(
      queries, B, D, static_cast<const T*>(corpus_t), m_pad, chunk, m_tile, m_real,
      fold, out);
  return cudaGetLastError();
}

}  // namespace

// queries [B, D] f32, corpus_t [D, M_pad] (f32 for modes 0-2, bf16 for mode
// 3), out [B, M_pad / chunk] f32; all contiguous. The wrapper checks that
// chunk divides m_tile, m_tile divides M_pad, and the grid's limits.
// Returns cudaGetLastError() after the launch.
extern "C" int ircl_dense_cmax(const void* queries, int64_t B, int64_t D,
                               const void* corpus_t, int64_t m_pad, int64_t chunk,
                               int64_t m_tile, int64_t m_real, int64_t mode,
                               int64_t fold, void* out, void* stream) {
  if (B <= 0 || m_pad <= 0) return static_cast<int>(cudaGetLastError());
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = fold ? 1 : 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case 0:
      err = launch<float, 0>(q, B, D, corpus_t, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    case 1:
      err = launch<float, 1>(q, B, D, corpus_t, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    case 2:
      err = launch<float, 2>(q, B, D, corpus_t, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    case 3:
      err = launch<__nv_bfloat16, 3>(q, B, D, corpus_t, m_pad, chunk, m_tile, m_real,
                                     f, o, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
