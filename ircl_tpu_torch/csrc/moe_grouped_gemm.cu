// Grouped bf16 GEMM over the experts of a dropless MoE layer, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs GShard's capacity-limited
// MoE as one-hot dispatch and combine einsums, which cost more than the
// experts at 64 experts and drop tokens. Here the routed rows are sorted by
// expert into one buffer x [R, K] (bf16, row-major), expert e owning rows
// offsets[e] .. offsets[e + 1] - 1, and each expert's rows are multiplied by
// its weight w[e] [N, K] (bf16, K contiguous, a Linear layer's [out, in]):
//
//   y[r, n] = sum_k x[r, k] * w[e(r), n, k]    (f32 sums, bf16 out)
//
// The offsets [E + 1] (int32) are read from device memory by each block, so
// the host never learns how many rows an expert has and the forward never
// waits on the card: the grid covers every tile that R rows could need
// (R / 128 + E tiles of rows), and a block past the last expert's rows
// exits at once. Rows at or past offsets[E] are not written.
//
// With swiglu, w[e] holds an expert's gate and up rows interleaved by eights
// (rows 16j .. 16j + 7 are gate rows 8j .. 8j + 7, rows 16j + 8 .. 16j + 15
// the up rows of the same columns), and the epilogue writes
// h = bf16(bf16(silu(bf16(g))) * bf16(u)) into y [R, N / 2]: the rounding
// of the published model's bf16 act_fn(gate_proj(x)) * up_proj(x).
//
// Bound on this card: the tensor cores. At the Moonlight cell's size an
// expert sees about 1,000 rows a layer, 1,000 * 2 * 2048 * 2816 operations
// of the first product over 11.5 MB of its weights: about 500 operations a
// byte, above the card's 295. Design: warp-level mma.sync m16n8k16 (bf16 in,
// f32 accumulate) on a 128 x 128 tile of a block of 8 warps (2 x 4, a warp
// 64 x 32), fed by a 3-stage cp.async ring of 128 x 64 tiles of x and w in
// the 128-byte swizzle (the 16-byte piece c of row r at c ^ (r % 8)), read by
// ldmatrix without bank conflicts. Blocks that share a tile of rows are
// neighbours in the grid (blockIdx.x walks the columns), so a tile of x is
// read from device memory about once and the expert's weights stay in L2
// across its tiles of rows.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kThreads = 256;
constexpr int kWM = 64, kWN = 32;           // a warp's tile: 2 x 4 warps
constexpr int kMT = kWM / 16, kNT = kWN / 8;  // mma tiles a warp
constexpr int kTileElems = kBM * kBK;         // one operand's stage (kBM == kBN)
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;  // 96 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of the 16-byte piece c of row r of a [rows, 64] tile.
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <bool kSwiGLU>
__global__ void __launch_bounds__(kThreads)
    moe_grouped_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            const int32_t* __restrict__ offsets, int E, int64_t K, int64_t N,
                            __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __shared__ int s_group, s_row0, s_row1;
  const int tid = threadIdx.x;
  if (tid == 0) {  // this block's expert and rows: the blockIdx.y-th tile of rows
    int t = blockIdx.y, g = -1, r0 = 0, r1 = 0;
    for (int e = 0; e < E; ++e) {
      const int lo = offsets[e], hi = offsets[e + 1];
      const int tiles = (hi - lo + kBM - 1) / kBM;
      if (t < tiles) {
        g = e;
        r0 = lo + t * kBM;
        r1 = min(hi, r0 + kBM);
        break;
      }
      t -= tiles;
    }
    s_group = g;
    s_row0 = r0;
    s_row1 = r1;
  }
  __syncthreads();
  const int g = s_group;
  if (g < 0) return;
  const int row0 = s_row0, row1 = s_row1;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const __nv_bfloat16* wg = w + static_cast<int64_t>(g) * N * K;
  __nv_bfloat16* sA = smem;
  __nv_bfloat16* sB = smem + kStages * kTileElems;

  auto load_stage = [&](int stage, int64_t k0) {
    const uint32_t a = smem_u32(sA + stage * kTileElems);
    const uint32_t b = smem_u32(sB + stage * kTileElems);
#pragma unroll
    for (int i = 0; i < kTileElems / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads, r = c >> 3, piece = c & 7;
      const bool ok = row0 + r < row1;
      const __nv_bfloat16* src = ok ? x + static_cast<int64_t>(row0 + r) * K + k0 + piece * 8 : x;
      cp_async16(a + swz(r, piece) * 2, src, ok);
      cp_async16(b + swz(r, piece) * 2, wg + (n0 + r) * K + k0 + piece * 8, true);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * kWM, wn = (warp & 3) * kWN;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int KT = static_cast<int>(K / kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, static_cast<int64_t>(s) * kBK);
    cp_async_commit();
  }
  // ldmatrix lanes: A's four 8x8 matrices are (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  // in the order a0..a3; B's are (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ...)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_piece = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_piece = (lane >> 3) & 1;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, static_cast<int64_t>(next) * kBK);
    cp_async_commit();
    const __nv_bfloat16* a_tile = sA + (kt % kStages) * kTileElems;
    const __nv_bfloat16* b_tile = sB + (kt % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[kMT][4], bf[kNT / 2][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], smem_u32(a_tile + swz(wm + i * 16 + a_row, kk * 2 + a_piece)));
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        ldmatrix_x4(bf[j], smem_u32(b_tile + swz(wn + j * 16 + b_row, kk * 2 + b_piece)));
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j & 1) * 2], bf[j / 2][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // C fragments: c0, c1 at (row lane / 4, columns 2 (lane % 4) + 0, 1), c2, c3 eight rows down
  const int fr = lane >> 2, fc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm + i * 16 + fr + half * 8;
      if (r >= row1) continue;
      if constexpr (kSwiGLU) {
        // n tiles 2j (gate) and 2j + 1 (up) hold the same eight output columns
        const int64_t width = N / 2;
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          const int64_t col = (n0 + wn) / 2 + j * 8 + fc;
          float h[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gt = round_bf16(acc[i][2 * j][half * 2 + q]);
            const float up = round_bf16(acc[i][2 * j + 1][half * 2 + q]);
            h[q] = round_bf16(gt / (1.0f + expf(-gt))) * up;
          }
          store2(y + static_cast<int64_t>(r) * width + col, h[0], h[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          store2(y + static_cast<int64_t>(r) * N + n0 + wn + j * 8 + fc, acc[i][j][half * 2],
                 acc[i][j][half * 2 + 1]);
      }
    }
  }
}

template <bool kSwiGLU>
cudaError_t launch(const void* x, const void* w, const void* offsets, int64_t E, int64_t R,
                   int64_t K, int64_t N, void* y, cudaStream_t stream) {
  auto kernel = moe_grouped_gemm_kernel<kSwiGLU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(N / kBN), static_cast<unsigned>((R + kBM - 1) / kBM + E));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(offsets), static_cast<int>(E), K, N,
      static_cast<__nv_bfloat16*>(y));
  return cudaGetLastError();
}

}  // namespace

// x [R, K], w [E, N, K], offsets [E + 1], y [R, N] (or [R, N / 2] with
// swiglu); K a multiple of 64, N of 128, pointers 16-byte aligned.
extern "C" int ircl_moe_grouped_gemm(const void* x, const void* w, const void* offsets,
                                     int64_t E, int64_t R, int64_t K, int64_t N,
                                     int64_t swiglu, void* y, void* stream) {
  if (R <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(swiglu ? launch<true>(x, w, offsets, E, R, K, N, y, st)
                                 : launch<false>(x, w, offsets, E, R, K, N, y, st));
}
