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
//   4  pre-split corpus (replaces the TPU kernel `_kernel` / `topk` of
//      scripts/probe_dense_presplit.py): the corpus arrives as two bf16
//      arrays hi and lo, split once when it was built, and only the queries
//      are split here; the three dots and their grouping are mode 1's, so on
//      the halves of the same f32 corpus the result is mode 1's bit for bit.
// A product of two bf16 values is exact in fp32, so every mode agrees with
// the plain version (chunk_max_ref) up to the fp32 summation order.
//
// Two kernels; the wrapper (ops/dense_topk_cuda.py::chunk_max_route) states
// which takes a call.
//
// - dense_cmax_mma_kernel, modes 1-4: the products on the bf16 tensor cores,
//   mma.sync.m16n8k16 with f32 accumulators. A block of 8 warps keeps 128
//   queries in shared memory as bf16 (hi, and lo for modes 1 and 4, rounded
//   as the plain version rounds them) and streams [D x 64] corpus tiles
//   from corpus_t through registers into shared memory (mode 1 splits the f32
//   tile into hi and lo there, once a tile; mode 2 rounds it; modes 3 and 4
//   copy bf16), the next tile's loads in flight under this tile's products.
//   Each warp multiplies a 32 x 32 corner: the queries' fragments by
//   ldmatrix, the corpus's (column-contiguous) by ldmatrix.trans. hi.hi
//   accumulates in one set of f32 registers and lo.hi + hi.lo in another,
//   added once a tile: the grouping a1 + (a2 + a3), with the tensor cores
//   summing each accumulator over D in their own order. Mode 4 is mode 1 on
//   the same halves, so its bits are mode 1's. Fold: chunk g % npt of tile t
//   takes the columns npt apart, so a block walks `chunk` tiles of 64
//   columns npt apart and keeps an element-wise running maximum in
//   registers, written once, 64 chunks a query; it takes npt a multiple of
//   64. Loop: a chunk of 8, 16 or 32 adjacent columns lies in one warp's 32;
//   its maximum is taken in the lane's fragment, then by quad shuffles. The
//   grid's fastest index is the query tile, so the 8 query tiles of B=1024
//   read each corpus tile from device memory once and from the 50 MB L2
//   otherwise. D is a multiple of 16 up to 128.
// - dense_cmax_kernel, every mode, SIMT: one thread owns one output chunk
//   for a tile of 16 queries (in shared memory, read as float4 broadcasts),
//   walks its chunk's columns and FMAs each loaded value into 16 running
//   dots (three for the split modes). It takes mode 0 ("highest": fp32
//   products have no bf16 tensor-core form) and every shape the tensor-core
//   kernel does not: 124 registers, 4 blocks an SM.
//
// Bound on this card, at the bench shape (B=1024, D=128, M_pad=1,007,616):
// high3 is 3 x 1.3e11 multiply-adds of bf16 values, 0.795 ms at the
// published 989 TFLOP/s, and the f32 corpus read once (516 MB) 0.154 ms; the
// SIMT kernel needs 11.7 ms at the f32 rate and took 25 there. The
// tensor-core kernel runs on mma.sync, which reaches about two thirds of
// wgmma's rate; two ldmatrix.x4 a warp for every six products, and the
// split of each f32 tile (8 times, once a query tile), hold it above that.

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
// such array for modes 0/2/3 and two (hi, lo) for modes 1 and 4. corpus_lo
// is read by mode 4 only.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
dense_cmax_kernel(const float* __restrict__ queries, int64_t B, int64_t D,
                  const T* __restrict__ corpus_t, const T* __restrict__ corpus_lo,
                  int64_t m_pad,
                  int64_t chunk, int64_t m_tile, int64_t m_real, int fold,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* q_hi = reinterpret_cast<float*>(smem4);
  const int64_t d4 = (D + 3) & ~int64_t(3);
  float* q_lo = q_hi + kQT * d4;  // used by modes 1 and 4 only
  constexpr bool kSplit = MODE == 1 || MODE == 4;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kQT;
  for (int64_t idx = threadIdx.x; idx < kQT * d4; idx += blockDim.x) {
    const int64_t q = idx / d4, d = idx % d4;
    const float x = (b0 + q < B && d < D) ? queries[(b0 + q) * D + d] : 0.0f;
    if (kSplit) {
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
      if (kSplit) {
        float ch[4], cl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (MODE == 4) {
            ch[j] = c[j];
            cl[j] = d + j < D ? load_as_float(corpus_lo + col + (d + j) * m_pad) : 0.0f;
          } else {
            ch[j] = bf16_round(c[j]);
            cl[j] = bf16_round(c[j] - ch[j]);
          }
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
      const float s = kSplit ? a1[q] + (a2[q] + a3[q]) : a1[q];
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
                   const void* corpus_lo, int64_t m_pad, int64_t chunk, int64_t m_tile,
                   int64_t m_real, int fold, float* out, cudaStream_t stream) {
  const int64_t d4 = (D + 3) & ~int64_t(3);
  const size_t smem = sizeof(float) * kQT * d4 * (MODE == 1 || MODE == 4 ? 2 : 1);
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
      queries, B, D, static_cast<const T*>(corpus_t), static_cast<const T*>(corpus_lo),
      m_pad, chunk, m_tile, m_real, fold, out);
  return cudaGetLastError();
}

// ---- modes 1-4 on the bf16 tensor cores ---------------------------------

constexpr int kTcThreads = 256;  // 8 warps: 4 along queries x 2 along columns
constexpr int kTcQ = 128;        // queries a block, 32 a warp
constexpr int kTcN = 64;         // corpus columns a sub-tile, 32 a warp
constexpr int kTcMaxD = 128;     // D the route takes: a multiple of 16 up to this
constexpr int kTcNS = kTcN + 8;  // shared row stride of a corpus tile (bf16)
constexpr int kLoopSpan = 32;    // sub-tiles a block walks under "loop"

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

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

// Four f32 values as bf16 (nearest even) at `hi` and, for the split modes,
// the remainders x - hi as bf16 at `lo`: 8 bytes each.
template <bool kSplit>
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                             const float4& x) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(hi) = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                                             *reinterpret_cast<const uint32_t*>(&h23));
  if constexpr (kSplit) {
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
    *reinterpret_cast<uint2*>(lo) = make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                                               *reinterpret_cast<const uint32_t*>(&l23));
  }
}

// A block holds kTcQ queries (as bf16 hi and, for modes 1 and 4, lo) in
// shared memory and walks n_sub sub-tiles of kTcN corpus columns each:
//   fold: block y covers corpus tile y / (npt / 64), columns j0 .. j0 + 63 of
//         its npt chunks (j0 = 64 * (y % (npt / 64))); sub-tile s is columns
//         tile * m_tile + j0 + s * npt + [0, 64), s < chunk, so column j of
//         every sub-tile belongs to chunk tile * npt + j0 + j and the chunk
//         maxima are an element-wise running maximum in registers;
//   loop: block y covers sub-tiles 32y .. 32y + 31 of contiguous columns, and
//         each chunk (8, 16 or 32 columns) lies within one warp's 32: its
//         maximum is taken within the lane's fragment, then by quad shuffles.
// corpus_t (and corpus_lo, mode 4) are [D, m_pad]: f32 for modes 1 and 2,
// bf16 for 3 and 4.
template <int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
dense_cmax_mma_kernel(const float* __restrict__ queries, int64_t B, int D,
                      const void* __restrict__ corpus_t,
                      const void* __restrict__ corpus_lo, int64_t m_pad, int64_t chunk,
                      int64_t m_tile, int64_t m_real, int fold,
                      float* __restrict__ out) {
  constexpr bool kSplit = MODE == 1 || MODE == 4;
  constexpr bool kF32 = MODE == 1 || MODE == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qs = D + 8;  // shared row stride of the queries (bf16): 16 bytes of pad
  __nv_bfloat16* q_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* q_lo = q_hi + kTcQ * qs;  // split modes only
  __nv_bfloat16* c_hi = q_hi + (kSplit ? 2 : 1) * kTcQ * qs;
  __nv_bfloat16* c_lo = c_hi + D * kTcNS;  // split modes only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: lanes 8i..8i+7 address matrix i
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTcQ;
  const int64_t nc = m_pad / chunk;
  const int64_t npt = m_tile / chunk;

  // the block's sub-tiles
  int n_sub;
  int64_t first_col, col_step, fold_g0 = 0;
  if (fold) {
    const int64_t groups = npt / kTcN, y = blockIdx.y;
    const int64_t tile = y / groups, j0 = (y % groups) * kTcN;
    first_col = tile * m_tile + j0;
    col_step = npt;
    n_sub = static_cast<int>(chunk);
    fold_g0 = tile * npt + j0;
  } else {
    const int64_t total = m_pad / kTcN, s0 = static_cast<int64_t>(blockIdx.y) * kLoopSpan;
    first_col = s0 * kTcN;
    col_step = kTcN;
    n_sub = static_cast<int>(total - s0 < kLoopSpan ? total - s0 : kLoopSpan);
  }

  // queries, rounded (and split) as the plain version rounds them
  const int d4 = D / 4;
  for (int idx = tid; idx < kTcQ * d4; idx += kTcThreads) {
    const int r = idx / d4, c = 4 * (idx % d4);
    const float4 x = b0 + r < B
                         ? *reinterpret_cast<const float4*>(queries + (b0 + r) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    store_bf16x4<kSplit>(q_hi + r * qs + c, q_lo + r * qs + c, x);
  }

  // a sub-tile on its way from device memory: f32 pieces of 4 columns (16
  // lanes a row) or bf16 pieces of 8 (8 lanes a row), D / 16 or D / 32 a thread
  constexpr int kF32Pieces = kTcMaxD * (kTcN / 4) / kTcThreads;
  constexpr int kBf16Pieces = kTcMaxD * (kTcN / 8) / kTcThreads;
  float4 f_stage[kF32 ? kF32Pieces : 1];
  uint4 h_stage[kF32 ? 1 : kBf16Pieces], l_stage[MODE == 4 ? kBf16Pieces : 1];
  auto load = [&](int64_t col0) {
    if constexpr (kF32) {
      const float* src = static_cast<const float*>(corpus_t) + col0 + 4 * (tid % 16);
#pragma unroll
      for (int i = 0; i < kF32Pieces; ++i) {
        const int r = tid / 16 + 16 * i;
        if (r < D) f_stage[i] = __ldg(reinterpret_cast<const float4*>(src + r * m_pad));
      }
    } else {
      const int64_t at = col0 + 8 * (tid % 8);
#pragma unroll
      for (int i = 0; i < kBf16Pieces; ++i) {
        const int r = tid / 8 + 32 * i;
        if (r < D) {
          h_stage[i] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(corpus_t) + at + r * m_pad));
          if constexpr (MODE == 4) {
            l_stage[i] = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(corpus_lo) + at + r * m_pad));
          }
        }
      }
    }
  };
  auto store = [&]() {
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < kF32Pieces; ++i) {
        const int r = tid / 16 + 16 * i, at = r * kTcNS + 4 * (tid % 16);
        if (r < D) store_bf16x4<kSplit>(c_hi + at, c_lo + at, f_stage[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBf16Pieces; ++i) {
        const int r = tid / 8 + 32 * i, at = r * kTcNS + 8 * (tid % 8);
        if (r < D) {
          *reinterpret_cast<uint4*>(c_hi + at) = h_stage[i];
          if constexpr (MODE == 4) *reinterpret_cast<uint4*>(c_lo + at) = l_stage[i];
        }
      }
    }
  };

  // fragments: [mt][nt][e] is query wm + 16 mt + g + 8 (e / 2), column
  // wn + 8 nt + 2t + e % 2 of the sub-tile
  float best[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mt][nt][e] = -CUDART_INF_F;

  load(first_col);
  for (int s = 0; s < n_sub; ++s) {
    const int64_t col0 = first_col + s * col_step;
    store();
    __syncthreads();  // the queries and this sub-tile are in shared memory
    if (s + 1 < n_sub) load(col0 + col_step);  // in flight during the products

    // hi.hi in one accumulator, lo.hi + hi.lo in another
    float big[2][4][4], small[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mt][nt][e] = small[mt][nt][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
      // A = Q: matrices (queries 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int off = (wm + mt * 16 + (lm & 1) * 8 + lr) * qs + kk + (lm >> 1) * 8;
        ldmatrix_x4(ah[mt], q_hi + off);
        if constexpr (kSplit) ldmatrix_x4(al[mt], q_lo + off);
      }
      // B = C, d-major: matrices (d 0-7, columns 0-7), (d 8-15, 0-7), (d 0-7,
      // 8-15), (d 8-15, 8-15), transposed: two 8-column tiles a load
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (kk + (lm & 1) * 8 + lr) * kTcNS + wn + np * 16 + (lm >> 1) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, c_hi + off);
        bh[2 * np][0] = r[0];
        bh[2 * np][1] = r[1];
        bh[2 * np + 1][0] = r[2];
        bh[2 * np + 1][1] = r[3];
        if constexpr (kSplit) {
          ldmatrix_x4_trans(r, c_lo + off);
          bl[2 * np][0] = r[0];
          bl[2 * np][1] = r[1];
          bl[2 * np + 1][0] = r[2];
          bl[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(big[mt][nt], ah[mt], bh[nt]);
          if constexpr (kSplit) {
            mma_bf16(small[mt][nt], al[mt], bh[nt]);
            mma_bf16(small[mt][nt], ah[mt], bl[nt]);
          }
        }
      }
    }

    // the scores, pad columns at -inf
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t col = col0 + wn + 8 * nt + 2 * t + (e & 1);
          const float x = kSplit ? big[mt][nt][e] + small[mt][nt][e] : big[mt][nt][e];
          big[mt][nt][e] = col < m_real ? x : -CUDART_INF_F;
        }
    if (fold) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) best[mt][nt][e] = fmaxf(best[mt][nt][e], big[mt][nt][e]);
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            v[nt] = fmaxf(big[mt][nt][2 * hh], big[mt][nt][2 * hh + 1]);
          }
          if (chunk >= 16) {
            v[0] = fmaxf(v[0], v[1]);
            v[2] = fmaxf(v[2], v[3]);
          }
          if (chunk >= 32) v[0] = fmaxf(v[0], v[2]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            v[nt] = fmaxf(v[nt], __shfl_xor_sync(0xffffffffu, v[nt], 1));
            v[nt] = fmaxf(v[nt], __shfl_xor_sync(0xffffffffu, v[nt], 2));
          }
          const int64_t q = b0 + wm + 16 * mt + g + 8 * hh;
          if (t == 0 && q < B) {
            for (int nt = 0; nt < 4; nt += static_cast<int>(chunk / 8)) {
              out[q * nc + (col0 + wn + 8 * nt) / chunk] = v[nt];
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this sub-tile
  }

  if (fold) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t q = b0 + wm + 16 * mt + g + 8 * (e >> 1);
        if (q >= B) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          out[q * nc + fold_g0 + wn + 8 * nt + 2 * t + (e & 1)] = best[mt][nt][e];
        }
      }
  }
}

// Whether the tensor-core kernel takes a call (ops/dense_topk_cuda.py
// states the same rule, chunk_max_route).
bool mma_takes(int64_t mode, int64_t D, int64_t m_pad, int64_t chunk, int64_t m_tile,
               bool fold) {
  if (mode < 1 || mode > 4 || D % 16 != 0 || D < 16 || D > kTcMaxD) return false;
  if (chunk <= 0 || m_tile <= 0 || m_tile % chunk != 0 || m_pad % m_tile != 0) return false;
  if (fold) return (m_tile / chunk) % kTcN == 0;
  return (chunk == 8 || chunk == 16 || chunk == 32) && m_tile % kTcN == 0;
}

template <int MODE>
cudaError_t launch_mma(const float* queries, int64_t B, int64_t D, const void* corpus_t,
                       const void* corpus_lo, int64_t m_pad, int64_t chunk,
                       int64_t m_tile, int64_t m_real, bool fold, float* out,
                       cudaStream_t stream) {
  constexpr bool kSplit = MODE == 1 || MODE == 4;
  const size_t smem = sizeof(__nv_bfloat16) * (kSplit ? 2 : 1) *
                      (kTcQ * (D + 8) + D * kTcNS);
  const cudaError_t err = cudaFuncSetAttribute(
      dense_cmax_mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks_y = fold ? (m_pad / m_tile) * (m_tile / chunk / kTcN)
                                : (m_pad / kTcN + kLoopSpan - 1) / kLoopSpan;
  const int64_t blocks_x = (B + kTcQ - 1) / kTcQ;
  if (blocks_y > 65535 || blocks_x > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  dense_cmax_mma_kernel<MODE><<<grid, kTcThreads, smem, stream>>>(
      queries, B, static_cast<int>(D), corpus_t, corpus_lo, m_pad, chunk, m_tile,
      m_real, fold ? 1 : 0, out);
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
      err = launch<float, 0>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f,
                             o, s);
      break;
    case 1:
      err = launch<float, 1>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f,
                             o, s);
      break;
    case 2:
      err = launch<float, 2>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f,
                             o, s);
      break;
    case 3:
      err = launch<__nv_bfloat16, 3>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile,
                                     m_real, f, o, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

// Mode 4: the corpus pre-split into ct_hi and ct_lo, both [D, M_pad] bf16 and
// contiguous; everything else as ircl_dense_cmax.
extern "C" int ircl_dense_cmax_presplit(const void* queries, int64_t B, int64_t D,
                                        const void* ct_hi, const void* ct_lo,
                                        int64_t m_pad, int64_t chunk, int64_t m_tile,
                                        int64_t m_real, int64_t fold, void* out,
                                        void* stream) {
  if (B <= 0 || m_pad <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch<__nv_bfloat16, 4>(
      static_cast<const float*>(queries), B, D, ct_hi, ct_lo, m_pad, chunk, m_tile,
      m_real, fold ? 1 : 0, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}

// Modes 1-4 on the bf16 tensor cores: the same arguments as ircl_dense_cmax
// (and, for mode 4, ct_lo as corpus_lo; null otherwise), for the shapes
// mma_takes accepts; queries, corpus_t and corpus_lo 16-byte aligned.
// Returns cudaErrorInvalidValue for any other call.
extern "C" int ircl_dense_cmax_mma(const void* queries, int64_t B, int64_t D,
                                   const void* corpus_t, const void* corpus_lo,
                                   int64_t m_pad, int64_t chunk, int64_t m_tile,
                                   int64_t m_real, int64_t mode, int64_t fold, void* out,
                                   void* stream) {
  if (B <= 0 || m_pad <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t any = reinterpret_cast<uintptr_t>(queries) |
                        reinterpret_cast<uintptr_t>(corpus_t) |
                        reinterpret_cast<uintptr_t>(corpus_lo);
  if (!mma_takes(mode, D, m_pad, chunk, m_tile, fold != 0) || any % 16 != 0 ||
      (mode == 4) != (corpus_lo != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = fold != 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case 1:
      err = launch_mma<1>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    case 2:
      err = launch_mma<2>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    case 3:
      err = launch_mma<3>(q, B, D, corpus_t, nullptr, m_pad, chunk, m_tile, m_real, f, o, s);
      break;
    default:
      err = launch_mma<4>(q, B, D, corpus_t, corpus_lo, m_pad, chunk, m_tile, m_real, f, o,
                          s);
      break;
  }
  return static_cast<int>(err);
}
