// Flash-attention backward with segment-id masking, for Hopper (sm_90a):
// the dK/dV kernel and the dQ kernel.
//
// Replaces the TPU kernels _flash_attention_dkv_kernel (:796, called from
// _flash_attention_bwd_dkv :941) and _flash_attention_dq_kernel (:1146,
// called from _flash_attention_bwd_dq :1287) of JAX's library
// jax/experimental/pallas/ops/tpu/flash_attention.py, which jax.grad reaches
// through the library's custom_vjp (:254-315) when the verdict model trains
// with attention="flash" (ircl_tpu/models/transformer.py:194). For q, do
// [B, H, Lq, 64], k, v [B, H, Lk, 64] f32, the forward's statistics l, m and
// di = sum_d o * do, f32 [B, H, Lq] each, per (b, h):
//
//   s_ij  = (q_i . k_j) * sm_scale + (seg_q[b,i] == seg_kv[b,j] ? 0 : MASK)
//   p_ij  = exp(s_ij - m_i) * (1 / l_i)
//   dv_j  = sum_i p_ij do_i
//   dp_ij = do_i . v_j
//   ds_ij = (dp_ij - di_i) * p_ij * sm_scale
//   dk_j  = sum_i ds_ij q_i
//   dq_i  = sum_j ds_ij k_j
//
// the library's arithmetic (:844-921, :1199-1262), the mask added after the
// scale as in the forward. The library's second output of the dQ kernel, ds,
// serves only an attention bias, which the port refuses: it is not written.
//
// Design: the math of the library's kernels, not their TPU blocks or their
// sequential grid. Both kernels recompute the 64 x 64 tiles of p and ds from
// q, k, v, do and the statistics, so no [B, H, Lq, Lk] matrix reaches device
// memory, and both use the forward kernel's block: 128 threads, a group of 8
// lanes sharing 4 query rows, each lane holding 8 of a tile's keys.
//
// - dK/dV: one block owns 64 keys of one (b, h), keeps their K and V tiles
//   in shared memory, and walks the queries in tiles of 64. Per tile it
//   stages Q and dO, computes p and ds, writes both tiles to shared memory,
//   and after a barrier adds p^T dO to dv and ds^T Q to dk, each lane holding
//   4 keys x 8 head columns of both. A block is the only writer of its keys'
//   dk and dv: no atomics, and a fixed order of summation.
// - dQ: one block owns 64 queries, keeps Q and dO in shared memory, and walks
//   the keys in tiles of 64: ds as above, then dq += ds K with the lane
//   layout of the forward's P V product.
//
// Each query row's m, 1/l, di and segment id are read from device memory
// into registers (8 lanes read one address, a broadcast). Tiles are copied
// with cp.async, one buffer per operand; expf and f32 FMAs, no tensor
// cores, so the plain version (flash_attention_bwd_ref) differs only by the
// f32 summation order.
//
// Bound on this card: f32 FMA throughput. The dK/dV kernel does four
// products of B*H*Lq*Lk*64 FMAs (s, dp, dv, dk), the dQ kernel three (s, dp,
// dq): at the training shape B=8, H=12, L=512 that is 4 and 3 times 1.6e9
// FMAs, 0.19 ms and 0.14 ms at the published 67 TFLOP/s, while each moves
// about 60 MB (18 us at 3.35 TB/s). Recomputing s and dp in both kernels
// costs two of the seven products; one fused kernel would need atomics for dq
// or a second pass. Tensor cores (TF32 or split bf16 through wgmma) are the
// next step and need a parity bound first.

#include "flash_attention_common.cuh"

namespace {

constexpr int kTile = 64;         // query rows and keys per tile
constexpr int kRows = kTile / (kThreads / kLanesPerRow);  // 4 rows per lane
constexpr int kCols = kTile / kLanesPerRow;               // 8 keys per lane
constexpr int kPS = kTile + kPad; // shared row stride of the p and ds tiles
constexpr int kOut = kHD / 32;    // float4 head columns per lane
constexpr size_t kDkvSmemBytes = sizeof(float) * (4 * kTile * kQS + 2 * kTile * kPS);
constexpr size_t kDqSmemBytes = sizeof(float) * (4 * kTile * kQS + kTile * kPS);

// out[i][j] = a[rg*4 + i] . b[cg + 8*j] over the head dimension, for two
// shared tiles of row stride kQS: the forward kernel's score product.
__device__ __forceinline__ void tile_dot(const float* sA, const float* sB, int rg,
                                         int cg, float (&out)[kRows][kCols]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < kHD; d += 4) {
    float4 av[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      av[i] = *reinterpret_cast<const float4*>(sA + (rg * kRows + i) * kQS + d);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(sB + (cg + kLanesPerRow * j) * kQS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        out[i][j] = fmaf(av[i].x, bv.x, out[i][j]);
        out[i][j] = fmaf(av[i].y, bv.y, out[i][j]);
        out[i][j] = fmaf(av[i].z, bv.z, out[i][j]);
        out[i][j] = fmaf(av[i].w, bv.w, out[i][j]);
      }
    }
  }
}

// The statistics of this lane's 4 query rows, from device memory.
struct RowStats {
  float m[kRows], inv_l[kRows], di[kRows];
  int32_t seg[kRows];
};

__device__ __forceinline__ RowStats load_row_stats(const float* l, const float* m,
                                                   const float* di,
                                                   const int32_t* seg_q,
                                                   int64_t stat0, int64_t seg0,
                                                   int rg) {
  RowStats r;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = rg * kRows + i;
    r.m[i] = m[stat0 + row];
    r.inv_l[i] = 1.0f / l[stat0 + row];
    r.di[i] = di[stat0 + row];
    r.seg[i] = seg_q != nullptr ? seg_q[seg0 + row] : 0;
  }
  return r;
}

// p and ds of this lane's 4 rows x 8 keys of one tile. sQ, sdO hold the
// tile's query rows, sK, sV its keys. p is left in `p`, ds in `ds`.
__device__ __forceinline__ void tile_p_ds(const float* sQ, const float* sK,
                                          const float* sdO, const float* sV, int rg,
                                          int cg, float sm_scale, bool masked,
                                          const RowStats& r,
                                          const int32_t (&kseg)[kCols],
                                          float (&p)[kRows][kCols],
                                          float (&ds)[kRows][kCols]) {
  tile_dot(sQ, sK, rg, cg, p);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float x = p[i][j] * sm_scale;
      if (masked) x = x + (r.seg[i] == kseg[j] ? 0.0f : kMaskValue);
      p[i][j] = expf(x - r.m[i]) * r.inv_l[i];
    }
  }
  tile_dot(sdO, sV, rg, cg, ds);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      ds[i][j] = (ds[i][j] - r.di[i]) * p[i][j] * sm_scale;
    }
  }
}

// acc[i][e] += sum_j w[j] * row_j[e]: four rows' worth of one float4 of
// weights against four shared rows.
__device__ __forceinline__ void fma4x4(float* a, const float4& w, const float4& r0,
                                       const float4& r1, const float4& r2,
                                       const float4& r3) {
  a[0] = fmaf(w.x, r0.x, a[0]);
  a[1] = fmaf(w.x, r0.y, a[1]);
  a[2] = fmaf(w.x, r0.z, a[2]);
  a[3] = fmaf(w.x, r0.w, a[3]);
  a[0] = fmaf(w.y, r1.x, a[0]);
  a[1] = fmaf(w.y, r1.y, a[1]);
  a[2] = fmaf(w.y, r1.z, a[2]);
  a[3] = fmaf(w.y, r1.w, a[3]);
  a[0] = fmaf(w.z, r2.x, a[0]);
  a[1] = fmaf(w.z, r2.y, a[1]);
  a[2] = fmaf(w.z, r2.z, a[2]);
  a[3] = fmaf(w.z, r2.w, a[3]);
  a[0] = fmaf(w.w, r3.x, a[0]);
  a[1] = fmaf(w.w, r3.y, a[1]);
  a[2] = fmaf(w.w, r3.z, a[2]);
  a[3] = fmaf(w.w, r3.w, a[3]);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ seg_q,
                           const int32_t* __restrict__ seg_kv,
                           const float* __restrict__ l, const float* __restrict__ m,
                           const float* __restrict__ d_out,
                           const float* __restrict__ di, int64_t H, int64_t Lq,
                           int64_t Lk, float sm_scale, float* __restrict__ dk,
                           float* __restrict__ dv) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * kQS;
  float* sQ = sV + kTile * kQS;
  float* sdO = sQ + kTile * kQS;
  float* sP = sdO + kTile * kQS;
  float* sdS = sP + kTile * kPS;

  const int64_t b = blockIdx.z, h = blockIdx.y, bh = b * H + h;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const float* qb = q + bh * Lq * kHD;
  const float* dob = d_out + bh * Lq * kHD;
  const int tid = threadIdx.x;
  const int rg = tid / kLanesPerRow;  // query rows rg*4 + i, then keys rg*4 + i
  const int cg = tid % kLanesPerRow;  // keys cg + 8*j, then columns cg*4 + 32*jj
  const bool masked = seg_q != nullptr;
  const int n_tiles = static_cast<int>(Lq / kTile);

  stage_rows(sK, k + bh * Lk * kHD, k0, Lk, tid);  // land with query tile 0
  stage_rows(sV, v + bh * Lk * kHD, k0, Lk, tid);
  int32_t kseg[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    kseg[j] = masked ? seg_kv[b * Lk + k0 + cg + kLanesPerRow * j] : 0;
  }
  float acc_dk[kRows][4 * kOut], acc_dv[kRows][4 * kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * kOut; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // Q and dO of query tile t; the previous tile's readers passed the
    // barrier at the end of the loop
    const int64_t q0 = static_cast<int64_t>(t) * kTile;
    stage_rows(sQ, qb, q0, Lq, tid);
    stage_rows(sdO, dob, q0, Lq, tid);
    cp_async_commit();
    const RowStats r = load_row_stats(l, m, di, seg_q, bh * Lq + q0, b * Lq + q0, rg);
    cp_async_wait<0>();
    __syncthreads();  // the tile (and K, V) are in shared memory for every thread

    {
      float p[kRows][kCols], ds[kRows][kCols];
      tile_p_ds(sQ, sK, sdO, sV, rg, cg, sm_scale, masked, r, kseg, p, ds);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int at = (rg * kRows + i) * kPS + cg + kLanesPerRow * j;
          sP[at] = p[i][j];
          sdS[at] = ds[i][j];
        }
      }
    }
    __syncthreads();  // every query row's p and ds are written

    // dv += p^T dO and dk += ds^T Q over this tile's query rows; this lane
    // holds keys rg*4 + i and head columns cg*4 + 32*jj + e
#pragma unroll 2
    for (int row = 0; row < kTile; ++row) {
      const float4 pv = *reinterpret_cast<const float4*>(sP + row * kPS + rg * kRows);
      const float4 dsv = *reinterpret_cast<const float4*>(sdS + row * kPS + rg * kRows);
      const float pw[kRows] = {pv.x, pv.y, pv.z, pv.w};
      const float dw[kRows] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const int d = cg * 4 + 32 * jj;
        const float4 dov = *reinterpret_cast<const float4*>(sdO + row * kQS + d);
        const float4 qv = *reinterpret_cast<const float4*>(sQ + row * kQS + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float* av = acc_dv[i] + 4 * jj;
          av[0] = fmaf(pw[i], dov.x, av[0]);
          av[1] = fmaf(pw[i], dov.y, av[1]);
          av[2] = fmaf(pw[i], dov.z, av[2]);
          av[3] = fmaf(pw[i], dov.w, av[3]);
          float* ak = acc_dk[i] + 4 * jj;
          ak[0] = fmaf(dw[i], qv.x, ak[0]);
          ak[1] = fmaf(dw[i], qv.y, ak[1]);
          ak[2] = fmaf(dw[i], qv.z, ak[2]);
          ak[3] = fmaf(dw[i], qv.w, ak[3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this tile
  }

  float* dkb = dk + bh * Lk * kHD;
  float* dvb = dv + bh * Lk * kHD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t key = k0 + rg * kRows + i;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      const int64_t d = cg * 4 + 32 * jj;
      const float* ak = acc_dk[i] + 4 * jj;
      const float* av = acc_dv[i] + 4 * jj;
      *reinterpret_cast<float4*>(dkb + key * kHD + d) =
          make_float4(ak[0], ak[1], ak[2], ak[3]);
      *reinterpret_cast<float4*>(dvb + key * kHD + d) =
          make_float4(av[0], av[1], av[2], av[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int32_t* __restrict__ seg_q,
                          const int32_t* __restrict__ seg_kv,
                          const float* __restrict__ l, const float* __restrict__ m,
                          const float* __restrict__ d_out,
                          const float* __restrict__ di, int64_t H, int64_t Lq,
                          int64_t Lk, float sm_scale, float* __restrict__ dq) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kTile * kQS;
  float* sK = sdO + kTile * kQS;
  float* sV = sK + kTile * kQS;
  float* sdS = sV + kTile * kQS;

  const int64_t b = blockIdx.z, h = blockIdx.y, bh = b * H + h;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const float* kb = k + bh * Lk * kHD;
  const float* vb = v + bh * Lk * kHD;
  const int tid = threadIdx.x;
  const int rg = tid / kLanesPerRow;  // query rows rg*4 + i
  const int cg = tid % kLanesPerRow;  // keys cg + 8*j, then columns cg*4 + 32*jj
  const bool masked = seg_q != nullptr;
  const int n_tiles = static_cast<int>(Lk / kTile);

  stage_rows(sQ, q + bh * Lq * kHD, q0, Lq, tid);  // land with key tile 0
  stage_rows(sdO, d_out + bh * Lq * kHD, q0, Lq, tid);
  const RowStats r = load_row_stats(l, m, di, seg_q, bh * Lq + q0, b * Lq + q0, rg);
  float acc[kRows][4 * kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * kOut; ++e) acc[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // K and V of key tile t; the previous tile's readers passed the barrier
    // at the end of the loop
    const int64_t k0 = static_cast<int64_t>(t) * kTile;
    stage_rows(sK, kb, k0, Lk, tid);
    stage_rows(sV, vb, k0, Lk, tid);
    cp_async_commit();
    int32_t kseg[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      kseg[j] = masked ? seg_kv[b * Lk + k0 + cg + kLanesPerRow * j] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile (and Q, dO) are in shared memory for every thread

    {
      float p[kRows][kCols], ds[kRows][kCols];
      tile_p_ds(sQ, sK, sdO, sV, rg, cg, sm_scale, masked, r, kseg, p, ds);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sdS[(rg * kRows + i) * kPS + cg + kLanesPerRow * j] = ds[i][j];
        }
      }
    }
    __syncwarp();  // a row group's ds is written and read in one warp

    // acc += ds K over this tile's keys
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 w[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        w[i] = *reinterpret_cast<const float4*>(sdS + (rg * kRows + i) * kPS + j);
      }
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const int d = cg * 4 + 32 * jj;
        const float4 r0 = *reinterpret_cast<const float4*>(sK + (j + 0) * kQS + d);
        const float4 r1 = *reinterpret_cast<const float4*>(sK + (j + 1) * kQS + d);
        const float4 r2 = *reinterpret_cast<const float4*>(sK + (j + 2) * kQS + d);
        const float4 r3 = *reinterpret_cast<const float4*>(sK + (j + 3) * kQS + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) fma4x4(acc[i] + 4 * jj, w[i], r0, r1, r2, r3);
      }
    }
    __syncthreads();  // every thread is done with this tile
  }

  float* dqb = dq + bh * Lq * kHD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t row = q0 + rg * kRows + i;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      const int64_t d = cg * 4 + 32 * jj;
      const float* a = acc[i] + 4 * jj;
      *reinterpret_cast<float4*>(dqb + row * kHD + d) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// What both entry points refuse: widths and lengths the kernels do not take,
// unaligned tensors, and one segment pointer without the other.
bool bad_bwd_args(const void* const* tensors, int n_tensors, const void* seg_q,
                  const void* seg_kv, int64_t B, int64_t H, int64_t Lq, int64_t Lk,
                  int64_t hd) {
  uintptr_t any = 0;
  for (int i = 0; i < n_tensors; ++i) {
    if (tensors[i] == nullptr) return true;
    any |= reinterpret_cast<uintptr_t>(tensors[i]);
  }
  return Lq <= 0 || Lk <= 0 || Lq % kTile != 0 || Lk % kTile != 0 || hd != kHD ||
         any % 16 != 0 || B > 65535 || H > 65535 ||
         (seg_q == nullptr) != (seg_kv == nullptr);
}

}  // namespace

// q, do [B, H, Lq, hd] and k, v, dk, dv [B, H, Lk, hd]: f32, contiguous,
// 16-byte aligned; l, m, di [B, H, Lq] f32; seg_q [B, Lq] and seg_kv
// [B, Lk] int32, contiguous, both null for no mask. hd must be 64, Lq and Lk
// multiples of 64 (the wrapper asks for 128); B and H at most 65535. Returns
// cudaGetLastError() after the launch.
extern "C" int ircl_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* l, const void* m, const void* d_out,
    const void* di, int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t hd,
    float sm_scale, void* dk, void* dv, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const void* tensors[] = {q, k, v, l, m, d_out, di, dk, dv};
  if (bad_bwd_args(tensors, 9, seg_q, seg_kv, B, H, Lq, Lk, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(Lk / kTile), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_dkv_kernel<<<grid, kThreads, kDkvSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(seg_q),
      static_cast<const int32_t*>(seg_kv), static_cast<const float*>(l),
      static_cast<const float*>(m), static_cast<const float*>(d_out),
      static_cast<const float*>(di), H, Lq, Lk, sm_scale, static_cast<float*>(dk),
      static_cast<float*>(dv));
  return static_cast<int>(cudaGetLastError());
}

// The same inputs; dq [B, H, Lq, hd] f32, contiguous, 16-byte aligned.
extern "C" int ircl_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, const void* l, const void* m, const void* d_out,
    const void* di, int64_t B, int64_t H, int64_t Lq, int64_t Lk, int64_t hd,
    float sm_scale, void* dq, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const void* tensors[] = {q, k, v, l, m, d_out, di, dq};
  if (bad_bwd_args(tensors, 8, seg_q, seg_kv, B, H, Lq, Lk, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(Lq / kTile), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_dq_kernel<<<grid, kThreads, kDqSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(seg_q),
      static_cast<const int32_t*>(seg_kv), static_cast<const float*>(l),
      static_cast<const float*>(m), static_cast<const float*>(d_out),
      static_cast<const float*>(di), H, Lq, Lk, sm_scale, static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}
