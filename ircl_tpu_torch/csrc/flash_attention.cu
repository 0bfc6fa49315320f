// Flash-attention forward with segment-id masking, for Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_attention_kernel of JAX's library
// jax/experimental/pallas/ops/tpu/flash_attention.py (:331, body :386-473),
// which ircl_tpu/models/transformer.py:194 calls for attention="flash" (the
// verdict model). For q [B, H, Lq, 64], k and v [B, H, Lk, 64] f32 and the
// segment ids seg_q [B, Lq], seg_kv [B, Lk] int32, per (b, h) and query i:
//
//   s_ij = (q_i . k_j) * sm_scale + (seg_q[b,i] == seg_kv[b,j] ? 0 : MASK)
//   o_i  = sum_j softmax_j(s_i) v_j
//
// MASK = -0.7 * FLT_MAX is added after the scale, as the library adds it
// (:408-437); null segment pointers mean no mask. Pad query rows (segment
// 0) attend to the pad keys only, as in the library.
//
// Heads are 64 wide, as in every BERT and RoBERTa size; the wrapper refuses
// other widths.
//
// Design: the math of the library's kernel, not its TPU blocks. One block
// owns 64 query rows of one (b, h) and walks the keys in tiles of 64: the
// whole K and V of one (b, h) at L=512, hd=64 is 256 KB in f32, more than a
// block's 227 KB of shared memory. Per tile the block stages K and V in
// shared memory, computes the 64 x 64 scores, and folds them into an online
// softmax (running row max and row sum in f32, the output rescaled by
// exp(m_old - m_new)); the output is divided by the row sum once, at the
// end. The [B, H, Lq, Lk] scores never reach device memory. 128 threads: a
// group of 8 lanes shares 4 query rows, each lane holds 8 of the tile's key
// columns of those rows (reduced across the 8 lanes by shuffles) and 1/8 of
// the head dimension of their output. Shared rows are padded by 4 floats so
// that the float4 reads of 8 neighbouring keys fall in distinct banks.
// Tiles are copied with cp.async, 16 bytes a thread, every copy of a tile in
// flight at once: staged with one plain load after another, the block waited
// out each load's latency and the kernel ran 2.5x slower. One buffer per
// tile keeps a block at 70 KB of shared memory, so three blocks share an SM
// and two compute while the third waits for its tile; a second buffer, at
// two blocks an SM, measured slower on the H100. The copies need 16-byte
// aligned rows: the wrapper passes aligned, contiguous tensors. expf (not
// __expf) and f32 FMAs, no tensor cores: the plain version
// (flash_attention_ref, the whole softmax in fp32) then differs only by the
// f32 summation order.
//
// Bound on this card: f32 FMA throughput. At the served shape (B=32, H=12,
// L=512, hd=64) one layer is two products of 32*12*512*512*64 = 6.4e9 FMAs
// each (2.6e10 FLOP), about 0.39 ms at the published 67 TFLOP/s f32 rate,
// while it moves about 50 MB of q, k, v and o (15 us at 3.35 TB/s). Each
// lane reads 12 float4 from shared memory for every 128 FMAs, and the
// softmax between the two products (expf, shuffles, the P tile) keeps the
// FMA pipes from their peak: on an H100 at 700 W the kernel runs at about
// half the f32 rate. TF32 or split-bf16 tensor cores (wgmma) are the next
// step and need a parity bound first.

#include "flash_attention_common.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kRows = kBQ / (kThreads / kLanesPerRow);  // 4 rows per lane
constexpr int kCols = kBK / kLanesPerRow;               // 8 keys per lane
constexpr int kPS = kBK + kPad;   // shared row stride of the probabilities
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kQS + 2 * kBK * kQS + kBQ * kPS) + sizeof(int32_t) * kBK;

// kStats also writes each query row's softmax statistics, the row maximum m
// and the row sum l = sum_j exp(s_ij - m_i), f32 [B, H, Lq] each: what the
// backward kernels (flash_attention_bwd.cu) recompute the probabilities
// from, as the library's forward does under differentiation (:246-251).
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int32_t* __restrict__ seg_q,
                       const int32_t* __restrict__ seg_kv, int64_t H, int64_t Lq,
                       int64_t Lk, float sm_scale, float* __restrict__ out,
                       float* __restrict__ l_out, float* __restrict__ m_out) {
  static_assert(kBQ == 64 && kBK == 64, "stage_rows stages 64 rows");
  constexpr int kOut = kHD / 32;   // float4 output columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * kQS;
  float* sV = sK + kBK * kQS;
  float* sP = sV + kBK * kQS;
  int32_t* sSeg = reinterpret_cast<int32_t*>(sP + kBQ * kPS);

  const int64_t b = blockIdx.z, h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const float* qb = q + (b * H + h) * Lq * kHD;
  const float* kb = k + (b * H + h) * Lk * kHD;
  const float* vb = v + (b * H + h) * Lk * kHD;
  const int tid = threadIdx.x;
  const int rg = tid / kLanesPerRow;  // row group: rows rg*kRows + i
  const int cg = tid % kLanesPerRow;  // keys cg + 8*j, outputs cg*4 + 32*jj + t
  const bool masked = seg_q != nullptr;
  const int n_tiles = static_cast<int>(Lk / kBK);

  stage_rows(sQ, qb, q0, Lq, tid);  // lands with tile 0
  int32_t my_seg[kRows];
  float m[kRows], l[kRows], acc[kRows][4 * kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + rg * kRows + i;
    my_seg[i] = (masked && row < Lq) ? seg_q[b * Lq + row] : 0;
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * kOut; ++e) acc[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // K, V and segment ids of tile t; the previous tile's readers passed
    // the barrier at the end of the loop
    const int64_t k0 = static_cast<int64_t>(t) * kBK;
    stage_rows(sK, kb, k0, Lk, tid);
    stage_rows(sV, vb, k0, Lk, tid);
    if (masked && tid < kBK) cp_async4(sSeg + tid, seg_kv + b * Lk + k0 + tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // tile t (and q) are in shared memory for every thread

    // scores of this lane's rows and keys
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kHD; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg * kRows + i) * kQS + d);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sK + (cg + kLanesPerRow * j) * kQS + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // scale, mask, online softmax; the 8 lanes of a row group hold its keys
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * sm_scale;
        if (masked) {
          x = x + (my_seg[i] == sSeg[cg + kLanesPerRow * j] ? 0.0f : kMaskValue);
        }
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1) {
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      }
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(rg * kRows + i) * kPS + cg + kLanesPerRow * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * kOut; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // a row group's probabilities are written and read in one warp

    // acc += P V over this tile's keys
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg * kRows + i) * kPS + j);
      }
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const int d = cg * 4 + 32 * jj;
        const float4 v0 = *reinterpret_cast<const float4*>(sV + (j + 0) * kQS + d);
        const float4 v1 = *reinterpret_cast<const float4*>(sV + (j + 1) * kQS + d);
        const float4 v2 = *reinterpret_cast<const float4*>(sV + (j + 2) * kQS + d);
        const float4 v3 = *reinterpret_cast<const float4*>(sV + (j + 3) * kQS + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float* a = acc[i] + 4 * jj;
          a[0] = fmaf(pv[i].x, v0.x, a[0]);
          a[1] = fmaf(pv[i].x, v0.y, a[1]);
          a[2] = fmaf(pv[i].x, v0.z, a[2]);
          a[3] = fmaf(pv[i].x, v0.w, a[3]);
          a[0] = fmaf(pv[i].y, v1.x, a[0]);
          a[1] = fmaf(pv[i].y, v1.y, a[1]);
          a[2] = fmaf(pv[i].y, v1.z, a[2]);
          a[3] = fmaf(pv[i].y, v1.w, a[3]);
          a[0] = fmaf(pv[i].z, v2.x, a[0]);
          a[1] = fmaf(pv[i].z, v2.y, a[1]);
          a[2] = fmaf(pv[i].z, v2.z, a[2]);
          a[3] = fmaf(pv[i].z, v2.w, a[3]);
          a[0] = fmaf(pv[i].w, v3.x, a[0]);
          a[1] = fmaf(pv[i].w, v3.y, a[1]);
          a[2] = fmaf(pv[i].w, v3.z, a[2]);
          a[3] = fmaf(pv[i].w, v3.w, a[3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this tile
  }

  // o = acc / l; l >= 1, since each tile's largest score contributes exp(0)
  float* ob = out + (b * H + h) * Lq * kHD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + rg * kRows + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      const int64_t d = cg * 4 + 32 * jj;
      const float* a = acc[i] + 4 * jj;
      *reinterpret_cast<float4*>(ob + row * kHD + d) =
          make_float4(a[0] / l[i], a[1] / l[i], a[2] / l[i], a[3] / l[i]);
    }
    if constexpr (kStats) {
      if (cg == 0) {
        l_out[(b * H + h) * Lq + row] = l[i];
        m_out[(b * H + h) * Lq + row] = m[i];
      }
    }
  }
}

template <bool kStats>
int launch_forward(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, int64_t B, int64_t H, int64_t Lq, int64_t Lk,
                   int64_t hd, float sm_scale, void* out, void* l_out, void* m_out,
                   void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (Lk <= 0 || Lk % kBK != 0 || hd != kHD || any % 16 != 0 || B > 65535 ||
      H > 65535 || (seg_q == nullptr) != (seg_kv == nullptr) ||
      (kStats && (l_out == nullptr || m_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Lq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<kStats><<<grid, kThreads, kSmemBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(seg_q),
      static_cast<const int32_t*>(seg_kv), H, Lq, Lk, sm_scale,
      static_cast<float*>(out), static_cast<float*>(l_out),
      static_cast<float*>(m_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Lq, hd], k and v [B, H, Lk, hd], out [B, H, Lq, hd]: f32,
// contiguous, 16-byte aligned; seg_q [B, Lq] and seg_kv [B, Lk] int32,
// contiguous, both null for no mask. hd must be 64 and Lk a multiple of 64
// (the wrapper asks for 128, as the library does); B and H at most 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int ircl_flash_attention(const void* q, const void* k, const void* v,
                                    const void* seg_q, const void* seg_kv,
                                    int64_t B, int64_t H, int64_t Lq, int64_t Lk,
                                    int64_t hd, float sm_scale, void* out,
                                    void* stream) {
  return launch_forward<false>(q, k, v, seg_q, seg_kv, B, H, Lq, Lk, hd, sm_scale,
                               out, nullptr, nullptr, stream);
}

// The same, and the softmax statistics l and m, f32 [B, H, Lq] each: the
// forward of a differentiated call.
extern "C" int ircl_flash_attention_stats(const void* q, const void* k, const void* v,
                                          const void* seg_q, const void* seg_kv,
                                          int64_t B, int64_t H, int64_t Lq,
                                          int64_t Lk, int64_t hd, float sm_scale,
                                          void* out, void* l_out, void* m_out,
                                          void* stream) {
  return launch_forward<true>(q, k, v, seg_q, seg_kv, B, H, Lq, Lk, hd, sm_scale,
                              out, l_out, m_out, stream);
}
