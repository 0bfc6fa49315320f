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
// Design. The operands are bf16 already, so the products run on the tensor
// cores: mma.sync.aligned.m16n8k16 with fp32 accumulators (a product of two
// bf16 values is exact in fp32, so the kernel differs from its plain version
// only in the order of the fp32 sums). A block of 8 warps owns one d-tile
// and 64 columns. It walks the tile in sub-tiles of 128 docs from the last
// to the first; for each it sweeps the union in stages of 32 rows: the
// stage's mh, ml [32, 128] and wh, wl [32, 64] go from device memory through
// registers into shared memory (the next stage's loads are started before the
// current stage's products, so they overlap), and every warp multiplies its
// 32 x 32 corner. Both slabs are u-major, the transpose of what the
// instruction wants for A and for a "col" B, so the fragments come from
// ldmatrix.trans; the shared rows are padded by 16 bytes, which keeps the
// eight rows of an 8 x 8 matrix in eight different banks. hi*hi accumulates
// in one set of registers and lo*hi + hi*lo in a second, added once at the
// end: the grouping hi.hi + (lo.hi + hi.lo) of the dense "high3" path. The
// 128 x 64 scores then pass through shared memory (over the dead operand
// stages) to 64 threads, one a column, which hand the rows downward to
// ColumnTopK (topk_columns.cuh): the pool run add and the best-first list,
// whose state lives in those threads across the tile's sub-tiles.
//
// Bound on this card: operations, 3 * 2 * U * N * B at the bf16 tensor rate
// (10.3 TFLOP at the probe's shape U=8192, N=51200, B=4096: 10.4 ms at 989
// TFLOP/s). mma.sync reaches about two thirds of what wgmma does, and the
// loads here are not pipelined through TMA: a first version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "topk_columns.cuh"

namespace {

constexpr int kBM = 128;       // docs per sub-tile; d_tile must be a multiple
constexpr int kBN = 64;        // columns per block; B must be a multiple
constexpr int kBK = 32;        // union rows per stage; U must be a multiple
constexpr int kThreads = 256;  // 8 warps: 4 along docs x 2 along columns
constexpr int kMS = kBM + 8;   // shared row strides in elements (16 B of pad)
constexpr int kWS = kBN + 8;
constexpr int kSS = kBN + 8;   // the fp32 score tile's stride

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
fused_dot_light_kernel(const __nv_bfloat16* __restrict__ m_hi,
                       const __nv_bfloat16* __restrict__ m_lo, int64_t U, int64_t N,
                       const __nv_bfloat16* __restrict__ w_hi,
                       const __nv_bfloat16* __restrict__ w_lo, int64_t B,
                       const int32_t* __restrict__ docs,
                       const float* __restrict__ contribs, int64_t P, int64_t d_tile,
                       int k, int k8, float* __restrict__ out_s,
                       int32_t* __restrict__ out_i) {
  // operand stages (26,624 bytes), later the fp32 score tile (36,864 bytes)
  __shared__ __align__(16) unsigned char smem[kBM * kSS * sizeof(float)];
  __nv_bfloat16* mh_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBK][kMS]
  __nv_bfloat16* ml_s = mh_s + kBK * kMS;
  __nv_bfloat16* wh_s = ml_s + kBK * kMS;  // [kBK][kWS]
  __nv_bfloat16* wl_s = wh_s + kBK * kWS;
  float* sc = reinterpret_cast<float*>(smem);  // [kBM][kSS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // the warp's first doc within the sub-tile
  const int wn = (warp & 1) * 32;   // and its first column within the block
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t tile = blockIdx.y;
  const int64_t d_base = tile * d_tile;

  const bool owner = tid < kBN;  // one thread a column for the epilogue
  ircl::ColumnTopK top;
  if (owner) {
    top.begin(docs, contribs, P, B, b0 + tid, d_base, d_base + d_tile,
              out_s + tile * k8 * B + b0 + tid, out_i + tile * k8 * B + b0 + tid, k);
  }

  // this thread's part of a stage: two 16-byte pieces of each m half (row
  // idx / 16, 8 docs from (idx % 16) * 8) and one of each w half
  const int m_row[2] = {tid >> 4, (tid + kThreads) >> 4};
  const int m_col = (tid & 15) * 8;
  const int w_row = tid >> 3;
  const int w_col = (tid & 7) * 8;
  // ldmatrix: lanes 8i..8i+7 hold the row addresses of matrix i
  const int lm = lane >> 3, lr = lane & 7;

  for (int64_t d0 = d_base + d_tile - kBM; d0 >= d_base; d0 -= kBM) {
    float acc[2][4][4], cor[2][4][4];  // hi.hi, and lo.hi + hi.lo
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = cor[i][j][e] = 0.0f;

    uint4 g_mh[2], g_ml[2], g_wh, g_wl;
    auto load_stage = [&](int64_t u0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t off = (u0 + m_row[i]) * N + d0 + m_col;
        g_mh[i] = *reinterpret_cast<const uint4*>(m_hi + off);
        g_ml[i] = *reinterpret_cast<const uint4*>(m_lo + off);
      }
      const int64_t off = (u0 + w_row) * B + b0 + w_col;
      g_wh = *reinterpret_cast<const uint4*>(w_hi + off);
      g_wl = *reinterpret_cast<const uint4*>(w_lo + off);
    };

    load_stage(0);
    for (int64_t u0 = 0; u0 < U; u0 += kBK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<uint4*>(mh_s + m_row[i] * kMS + m_col) = g_mh[i];
        *reinterpret_cast<uint4*>(ml_s + m_row[i] * kMS + m_col) = g_ml[i];
      }
      *reinterpret_cast<uint4*>(wh_s + w_row * kWS + w_col) = g_wh;
      *reinterpret_cast<uint4*>(wl_s + w_row * kWS + w_col) = g_wl;
      __syncthreads();
      if (u0 + kBK < U) load_stage(u0 + kBK);  // in flight during the products

#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
        // A = M^T: matrices (docs 0-7, u 0-7), (docs 8-15, u 0-7),
        // (docs 0-7, u 8-15), (docs 8-15, u 8-15) of each 16 x 16 corner
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int off = (kk + (lm >> 1) * 8 + lr) * kMS + wm + mt * 16 + (lm & 1) * 8;
          ldmatrix_x4_trans(ah[mt], mh_s + off);
          ldmatrix_x4_trans(al[mt], ml_s + off);
        }
        // B = W: matrices (u 0-7, cols 0-7), (u 8-15, cols 0-7), (u 0-7,
        // cols 8-15), (u 8-15, cols 8-15): two 8-column tiles a load
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int off = (kk + (lm & 1) * 8 + lr) * kWS + wn + np * 16 + (lm >> 1) * 8;
          uint32_t t[4];
          ldmatrix_x4_trans(t, wh_s + off);
          bh[2 * np][0] = t[0];
          bh[2 * np][1] = t[1];
          bh[2 * np + 1][0] = t[2];
          bh[2 * np + 1][1] = t[3];
          ldmatrix_x4_trans(t, wl_s + off);
          bl[2 * np][0] = t[0];
          bl[2 * np][1] = t[1];
          bl[2 * np + 1][0] = t[2];
          bl[2 * np + 1][1] = t[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc[mt][nt], ah[mt], bh[nt]);
            mma_bf16(cor[mt][nt], al[mt], bh[nt]);
            mma_bf16(cor[mt][nt], ah[mt], bl[nt]);
          }
        }
      }
      __syncthreads();
    }

    // scores to shared memory (the operand stages are dead past the last
    // barrier): c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8
    const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* p = sc + (wm + mt * 16 + g) * kSS + wn + nt * 8 + t2;
        p[0] = acc[mt][nt][0] + cor[mt][nt][0];
        p[1] = acc[mt][nt][1] + cor[mt][nt][1];
        p[8 * kSS] = acc[mt][nt][2] + cor[mt][nt][2];
        p[8 * kSS + 1] = acc[mt][nt][3] + cor[mt][nt][3];
      }
    }
    __syncthreads();
    if (owner) {
      for (int r = kBM - 1; r >= 0; --r) top.add_row(d0 + r, sc[r * kSS + tid]);
    }
    __syncthreads();
  }
  if (owner) top.finish(k8);
}

}  // namespace

// m_hi/m_lo [U, N] bf16, w_hi/w_lo [U, B] bf16, docs_t/contribs_t [P, B]
// i32/f32 doc-ascending along P, out_s/out_i [N / d_tile * k8, B]; all
// contiguous and 16-byte aligned. Needs U % 32 == 0, B % 64 == 0,
// N % d_tile == 0, d_tile % 128 == 0, 1 <= k <= d_tile and N / d_tile <=
// 65535 (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int ircl_fused_dot_light(const void* m_hi, const void* m_lo, int64_t U,
                                    int64_t N, const void* w_hi, const void* w_lo,
                                    int64_t B, const void* docs_t,
                                    const void* contribs_t, int64_t P, int64_t d_tile,
                                    int64_t k, void* out_s, void* out_i,
                                    void* stream) {
  const int64_t n_dt = N / d_tile;
  const int64_t k8 = (k + 7) / 8 * 8;
  if (B > 0 && n_dt > 0 && U > 0) {
    const dim3 grid(static_cast<unsigned>(B / kBN), static_cast<unsigned>(n_dt));
    fused_dot_light_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(m_hi),
        static_cast<const __nv_bfloat16*>(m_lo), U, N,
        static_cast<const __nv_bfloat16*>(w_hi),
        static_cast<const __nv_bfloat16*>(w_lo), B,
        static_cast<const int32_t*>(docs_t), static_cast<const float*>(contribs_t), P,
        d_tile, static_cast<int>(k), static_cast<int>(k8),
        static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
