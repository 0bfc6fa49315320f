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
// sequential grid. Both kernels recompute p and ds tile by tile from q, k, v,
// do and the statistics, so no [B, H, Lq, Lk] matrix reaches device memory.
//
// - Products on the tensor cores at f32 accuracy (mma_tf32.cuh): every f32
//   operand is split into two TF32 values and each product is hi.hi + (lo.hi
//   + hi.lo) with f32 accumulators, the small terms summed apart. A block is
//   one warpgroup (4 warps) and owns 64 rows (keys for dK/dV, queries for
//   dQ), 16 a warp; it walks the other sequence in steps of 32 rows. A tile is
//   split once, by the block, as it goes from device memory through registers
//   into shared memory: a hi plane and a lo plane in the layout wgmma reads.
// - The products that sum over the head width (s = Q K^T, dp = dO V^T; in
//   dK/dV their transposes K Q^T, V dO^T, so that the block's keys are the
//   rows) take both operands from those planes through wgmma.mma_async,
//   m64n32k8, 48 instructions a step.
// - The products that sum over the step's rows (dv += p^T dO, dk += ds^T Q,
//   dq += ds K) would need the step's tiles transposed for wgmma. They run on
//   mma.sync.m16n8k8 instead: the accumulators wgmma leaves in a warp are the
//   C fragments of that instruction, p and ds are computed in them and become
//   its A fragments without leaving their registers, and its B fragments are
//   32-bit loads from the same planes, free of bank conflicts under the
//   swizzle. p and ds never pass through shared memory and no tile is
//   transposed.
// - dk, dv and dq are summed over steps with ordinary f32 adds: each step's
//   product is accumulated by the tensor cores in fresh fragments (4 chained
//   instructions) and then added to the running sum, so the sum over the
//   whole sequence does not depend on how the tensor cores round their
//   accumulator. A block is the only writer of its rows: no atomics, a fixed
//   order of summation, the same bits every run.
// - Loads overlap arithmetic: the next live step's tiles (and the rows' m, l,
//   di and segment ids) are loaded into registers before this step's products
//   and split into the planes after them, between two barriers. One buffer a
//   step: the planes take 96 KB a block, two blocks an SM.
// - No work on steps the masks empty. A step in which no query shares a
//   segment with any key adds exactly 0 to dq, dk and dv as long as each of
//   its query rows has a key somewhere (exp(MASK - m) is exactly 0). A row
//   with no key at all has m near MASK and p = 1 / Lk on every key, so a step
//   holding such a row is never skipped: the test reads the rows' m beside
//   the segment ids. Each block marks its live steps before the loop, and
//   the loop neither loads nor computes the others.
//
// Bound on this card: tensor-core operations. The dK/dV kernel does four
// products of B*H*Lq*Lk*64 multiply-adds (s, dp, dv, dk), the dQ kernel three
// (s, dp, dq), three TF32 passes each: at the training shape B=8, H=12,
// L=512, all pairs live, 38.7 and 29.0 GFLOP, 0.078 and 0.059 ms at the
// published 495 TFLOP/s, while each moves about 60 MB (18 us at 3.35 TB/s).
// What holds the kernels above that is shared memory, not the tensor cores:
// a split operand is 8 bytes a word, wgmma reads the block's own planes
// again for every step (144 KB a step of 32 rows against 128 bytes a clock),
// and the 96 KB of planes leave two warpgroups an SM to hide each other's
// loads, barriers and softmax arithmetic. Recomputing s and dp in both
// kernels costs two of the seven products; one fused kernel would need
// atomics for dq or for dk, dv, which the fixed order of summation rules out.

#include "flash_attention_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMinBlocks = 2;          // blocks an SM: bounds the registers
// two own tiles and two tiles of a step as hi and lo planes, then a word a
// step row for each of m, 1 / l, di and the segment id (dK/dV) or the segment
// id (dQ), then the own rows' segment ids
constexpr int kPlaneWords = 4 * kOwnPlane + 4 * kStepPlane;
constexpr int kDkvWords = kPlaneWords + 4 * kStep + kOwn;
constexpr int kDqWords = kPlaneWords + kStep + kOwn;

// Dynamic shared memory of a block: its words and one byte a step.
constexpr size_t smem_bytes(int words, int64_t n_steps) {
  return sizeof(float) * words + static_cast<size_t>((n_steps + 15) / 16 * 16);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ seg_q,
                           const int32_t* __restrict__ seg_kv,
                           const float* __restrict__ l, const float* __restrict__ m,
                           const float* __restrict__ d_out,
                           const float* __restrict__ di, int64_t H, int64_t Lq,
                           int64_t Lk, float sm_scale, float* __restrict__ dk,
                           float* __restrict__ dv) {
  extern __shared__ __align__(1024) float4 smem4[];
  if (__cvta_generic_to_shared(smem4) % 1024 != 0) __trap();  // the planes' swizzle
  uint32_t* sK = reinterpret_cast<uint32_t*>(smem4);  // K hi, K lo, V hi, V lo
  uint32_t* sV = sK + 2 * kOwnPlane;
  uint32_t* sQ = sV + 2 * kOwnPlane;  // the step: Q hi, Q lo, dO hi, dO lo
  uint32_t* sdO = sQ + 2 * kStepPlane;
  float* stats = reinterpret_cast<float*>(sdO + 2 * kStepPlane);  // m, 1 / l, di
  int32_t* sseg = reinterpret_cast<int32_t*>(stats + 3 * kStep);
  int32_t* sOwnSeg = sseg + kStep;
  unsigned char* sLive = reinterpret_cast<unsigned char*>(sOwnSeg + kOwn);

  const int64_t b = blockIdx.z, h = blockIdx.y, bh = b * H + h;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kOwn;
  const int tid = threadIdx.x;
  const float* qb = q + bh * Lq * kHD + Tiles<kStep>::first_word(tid);  // the thread's
  const float* dob = d_out + bh * Lq * kHD + Tiles<kStep>::first_word(tid);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = warp * 16 + g;  // this lane's keys: row and row + 8
  const DownLane down(g, t);
  const bool masked = seg_q != nullptr;
  const int n_steps = static_cast<int>(Lq / kStep);

  int32_t kseg[2] = {0, 0};
  if (masked) {
    kseg[0] = seg_kv[b * Lk + k0 + row];
    kseg[1] = seg_kv[b * Lk + k0 + row + 8];
    if (tid < kOwn) sOwnSeg[tid] = seg_kv[b * Lk + k0 + tid];
    __syncthreads();
    mark_live_steps(sLive, n_steps, seg_q + b * Lq, m + bh * Lq, sOwnSeg, false, warp,
                    lane);
    __syncthreads();
  }

  // a step on its way: Q and dO pieces, and one query row's m, 1 / l, di and
  // segment id in each of the first kStep threads
  Tiles<kStep> tiles;
  float row_stats[3];
  int32_t row_seg = 0;
  auto fetch = [&](int s) {
    const int64_t i0 = static_cast<int64_t>(s) * kStep;
    tiles.fetch(qb + i0 * kHD, dob + i0 * kHD);
    if (tid < kStep) {
      row_stats[0] = m[bh * Lq + i0 + tid];
      row_stats[1] = 1.0f / l[bh * Lq + i0 + tid];
      row_stats[2] = di[bh * Lq + i0 + tid];
      if (masked) row_seg = seg_q[b * Lq + i0 + tid];
    }
  };
  auto store = [&]() {
    tiles.store(sQ + Tiles<kStep>::first_piece(tid));
    if (tid < kStep) {
      stats[tid] = row_stats[0];
      stats[kStep + tid] = row_stats[1];
      stats[2 * kStep + tid] = row_stats[2];
      sseg[tid] = row_seg;
    }
  };

  int cur = next_live(sLive, masked, 0, n_steps);
  if (cur < n_steps) fetch(cur);
  {
    Tiles<kOwn> own;
    const int64_t first = (bh * Lk + k0) * kHD + Tiles<kOwn>::first_word(tid);
    own.fetch(k + first, v + first);
    own.store(sK + Tiles<kOwn>::first_piece(tid));
  }
  if (cur < n_steps) store();
  fence_stores_for_wgmma();
  __syncthreads();  // K, V and the first step are in shared memory

  const uint64_t k_desc = wgmma_desc(sK), v_desc = wgmma_desc(sV);
  const uint64_t q_desc = wgmma_desc(sQ), do_desc = wgmma_desc(sdO);

  float acc_dk[kHD / 2], acc_dv[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  while (cur < n_steps) {
    // the next live step's loads run under this step's products
    const int nxt = next_live(sLive, masked, cur + 1, n_steps);
    if (nxt < n_steps) fetch(nxt);

    // s^T = K Q^T and dp^T = V dO^T of the block's 64 keys against the step's
    // queries: element 4j + 2h + c is (key row + 8h, query 8j + 2t + c)
    float p[4 * kNT], p_small[4 * kNT], ds[4 * kNT], ds_small[4 * kNT];
    wgmma_fence();
    wgmma_rows_dot_rows(p, p_small, k_desc, kOwnLo, kOwn, q_desc, kStepLo, kStep);
    wgmma_rows_dot_rows(ds, ds_small, v_desc, kOwnLo, kOwn, do_desc, kStepLo, kStep);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 8 * j + 2 * t + c;
        const float m_i = stats[i], inv_l = stats[kStep + i], di_i = stats[2 * kStep + i];
        const int32_t id = masked ? sseg[i] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * j + 2 * hh + c;
          float x = (p[e] + p_small[e]) * sm_scale;
          if (masked) x = x + (id == kseg[hh] ? 0.0f : kMaskValue);
          p[e] = expf(x - m_i) * inv_l;
          ds[e] = ((ds[e] + ds_small[e]) - di_i) * p[e] * sm_scale;
        }
      }
    }
    add_regs_dot_plane<kNT, kHD, kStep, kStepPlane, 2>(p, sdO, down, acc_dv);  // p^T dO
    add_regs_dot_plane<kNT, kHD, kStep, kStepPlane, 2>(ds, sQ, down, acc_dk);  // ds^T Q

    __syncthreads();  // every warp has read this step
    if (nxt < n_steps) store();
    fence_stores_for_wgmma();
    __syncthreads();
    cur = nxt;
  }

  // elements 4n + 2h + c at (row + 8h, head column 8n + 2t + c)
  float* dkb = dk + (bh * Lk + k0 + row) * kHD + 2 * t;
  float* dvb = dv + (bh * Lk + k0 + row) * kHD + 2 * t;
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) {
    *reinterpret_cast<float2*>(dkb + 8 * n) = make_float2(acc_dk[4 * n], acc_dk[4 * n + 1]);
    *reinterpret_cast<float2*>(dkb + 8 * kHD + 8 * n) =
        make_float2(acc_dk[4 * n + 2], acc_dk[4 * n + 3]);
    *reinterpret_cast<float2*>(dvb + 8 * n) = make_float2(acc_dv[4 * n], acc_dv[4 * n + 1]);
    *reinterpret_cast<float2*>(dvb + 8 * kHD + 8 * n) =
        make_float2(acc_dv[4 * n + 2], acc_dv[4 * n + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int32_t* __restrict__ seg_q,
                          const int32_t* __restrict__ seg_kv,
                          const float* __restrict__ l, const float* __restrict__ m,
                          const float* __restrict__ d_out,
                          const float* __restrict__ di, int64_t H, int64_t Lq,
                          int64_t Lk, float sm_scale, float* __restrict__ dq) {
  extern __shared__ __align__(1024) float4 smem4[];
  if (__cvta_generic_to_shared(smem4) % 1024 != 0) __trap();  // the planes' swizzle
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem4);  // Q hi, Q lo, dO hi, dO lo
  uint32_t* sdO = sQ + 2 * kOwnPlane;
  uint32_t* sK = sdO + 2 * kOwnPlane;  // the step: K hi, K lo, V hi, V lo
  uint32_t* sV = sK + 2 * kStepPlane;
  int32_t* sseg = reinterpret_cast<int32_t*>(sV + 2 * kStepPlane);
  int32_t* sOwnSeg = sseg + kStep;
  unsigned char* sLive = reinterpret_cast<unsigned char*>(sOwnSeg + kOwn);

  const int64_t b = blockIdx.z, h = blockIdx.y, bh = b * H + h;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kOwn;
  const int tid = threadIdx.x;
  const float* kb = k + bh * Lk * kHD + Tiles<kStep>::first_word(tid);  // the thread's
  const float* vb = v + bh * Lk * kHD + Tiles<kStep>::first_word(tid);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = warp * 16 + g;  // this lane's queries: row and row + 8
  const DownLane down(g, t);
  const bool masked = seg_q != nullptr;
  const int n_steps = static_cast<int>(Lk / kStep);

  float m_r[2], inv_l[2], di_r[2];
  int32_t qseg[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t at = bh * Lq + q0 + row + 8 * hh;
    m_r[hh] = m[at];
    inv_l[hh] = 1.0f / l[at];
    di_r[hh] = di[at];
    if (masked) qseg[hh] = seg_q[b * Lq + q0 + row + 8 * hh];
  }
  if (masked) {
    bool lonely = false;  // an own query with no key keeps every step alive
    if (tid < kOwn) {
      sOwnSeg[tid] = seg_q[b * Lq + q0 + tid];
      lonely = m[bh * Lq + q0 + tid] < kNoKeyBelow;
    }
    const bool always = __syncthreads_or(lonely) != 0;
    mark_live_steps(sLive, n_steps, seg_kv + b * Lk, nullptr, sOwnSeg, always, warp,
                    lane);
    __syncthreads();
  }

  // a step on its way: K and V pieces, and one key's segment id in each of
  // the first kStep threads
  Tiles<kStep> tiles;
  int32_t key_seg = 0;
  auto fetch = [&](int s) {
    const int64_t j0 = static_cast<int64_t>(s) * kStep;
    tiles.fetch(kb + j0 * kHD, vb + j0 * kHD);
    if (masked && tid < kStep) key_seg = seg_kv[b * Lk + j0 + tid];
  };
  auto store = [&]() {
    tiles.store(sK + Tiles<kStep>::first_piece(tid));
    if (tid < kStep) sseg[tid] = key_seg;
  };

  int cur = next_live(sLive, masked, 0, n_steps);
  if (cur < n_steps) fetch(cur);
  {
    Tiles<kOwn> own;
    const int64_t first = (bh * Lq + q0) * kHD + Tiles<kOwn>::first_word(tid);
    own.fetch(q + first, d_out + first);
    own.store(sQ + Tiles<kOwn>::first_piece(tid));
  }
  if (cur < n_steps) store();
  fence_stores_for_wgmma();
  __syncthreads();  // Q, dO and the first step are in shared memory

  const uint64_t q_desc = wgmma_desc(sQ), do_desc = wgmma_desc(sdO);
  const uint64_t k_desc = wgmma_desc(sK), v_desc = wgmma_desc(sV);

  float acc[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) acc[i] = 0.0f;

  while (cur < n_steps) {
    const int nxt = next_live(sLive, masked, cur + 1, n_steps);
    if (nxt < n_steps) fetch(nxt);

    // s = Q K^T and dp = dO V^T of the block's 64 queries against the step's
    // keys: element 4j + 2h + c is (query row + 8h, key 8j + 2t + c)
    float p[4 * kNT], p_small[4 * kNT], ds[4 * kNT], ds_small[4 * kNT];
    wgmma_fence();
    wgmma_rows_dot_rows(p, p_small, q_desc, kOwnLo, kOwn, k_desc, kStepLo, kStep);
    wgmma_rows_dot_rows(ds, ds_small, do_desc, kOwnLo, kOwn, v_desc, kStepLo, kStep);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int32_t id = masked ? sseg[8 * j + 2 * t + c] : 0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * j + 2 * hh + c;
          float x = (p[e] + p_small[e]) * sm_scale;
          if (masked) x = x + (qseg[hh] == id ? 0.0f : kMaskValue);
          const float p_e = expf(x - m_r[hh]) * inv_l[hh];
          ds[e] = ((ds[e] + ds_small[e]) - di_r[hh]) * p_e * sm_scale;
        }
      }
    }
    add_regs_dot_plane<kNT, kHD, kStep, kStepPlane, 4>(ds, sK, down, acc);  // dq += ds K

    __syncthreads();  // every warp has read this step
    if (nxt < n_steps) store();
    fence_stores_for_wgmma();
    __syncthreads();
    cur = nxt;
  }

  float* dqb = dq + (bh * Lq + q0 + row) * kHD + 2 * t;
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) {
    *reinterpret_cast<float2*>(dqb + 8 * n) = make_float2(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<float2*>(dqb + 8 * kHD + 8 * n) =
        make_float2(acc[4 * n + 2], acc[4 * n + 3]);
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
  return Lq <= 0 || Lk <= 0 || Lq % kOwn != 0 || Lk % kOwn != 0 || hd != kHD ||
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
  const size_t smem = smem_bytes(kDkvWords, Lq / kStep);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(Lk / kOwn), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_dkv_kernel<<<grid, kThreads, smem,
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
  const size_t smem = smem_bytes(kDqWords, Lk / kStep);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(Lq / kOwn), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_dq_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(seg_q),
      static_cast<const int32_t*>(seg_kv), static_cast<const float*>(l),
      static_cast<const float*>(m), static_cast<const float*>(d_out),
      static_cast<const float*>(di), H, Lq, Lk, sm_scale, static_cast<float*>(dq));
  return static_cast<int>(cudaGetLastError());
}
