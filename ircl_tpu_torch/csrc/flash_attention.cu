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
// Design: the math of the library's kernel, not its TPU blocks, built as
// the backward's dQ kernel is (flash_attention_bwd.cu; the shared walk is in
// flash_attention_common.cuh). A block is one warpgroup and owns 64 query
// rows of one (b, h), 16 a warp; it walks the keys in steps of 32, and the
// [B, H, Lq, Lk] scores never reach device memory.
//
// - Products on the tensor cores at f32 accuracy (mma_tf32.cuh): q, k and v
//   are split into two TF32 values each (q once a block, k and v once a
//   step, as they go from device memory through registers into swizzled
//   hi/lo planes), and each product is hi.hi + (lo.hi + hi.lo) with f32
//   accumulators, the small terms summed apart. s = q k^T takes both
//   operands from the planes through wgmma.mma_async (24 instructions a
//   step); o += p v runs on mma.sync.m16n8k8, p held in the registers
//   wgmma's accumulators left it in and v's B fragments read from its
//   planes, each step's product summed in fresh fragments and added to o in
//   f32.
// - The scale, then the mask (the library's order, :408-437), then an online
//   softmax in f32 on the accumulator layout: the row maximum of a step by
//   two quad shuffles, alpha = exp(m_old - m_new) applied to the output
//   fragments and to the lane's part of the row sum, the parts of l summed
//   across the quad once and o divided by l once, at the end. expf, not
//   __expf: the plain version (flash_attention_ref, the whole softmax in
//   fp32) then differs by the split and the f32 summation order only
//   (flash_attention_fwd_ref(..., products="tf32x3") is the split in plain
//   PyTorch).
// - The next live step's k and v load into registers under this step's
//   products and are split into the planes between two barriers. 66 KB of
//   planes a block; the registers are bounded for two blocks an SM, which
//   keeps them out of local memory (bounded for three, 28 bytes spilled and
//   the kernel ran 3% slower on an H100).
// - No work on steps the masks empty. A step in which no query row of the
//   block shares a segment with any key adds exactly 0 to o and l, as long
//   as each of those rows has a key somewhere (exp(MASK - m) is 0). A row
//   whose segment no key carries has p = 1 / Lk on every key and keeps every
//   step: the forward cannot read m in advance as the backward does, so
//   each warp looks its rows' ids up among the keys before the walk.
//
// Bound on this card: tensor-core operations. At the served shape (B=32,
// H=12, L=512, hd=64, all pairs live) the two products are 2 x 6.4e9
// multiply-adds, three TF32 passes each: 7.7e10 FLOP, 0.156 ms at the
// published 495 TFLOP/s, while q, k, v and o move 50 MB (15 us at 3.35
// TB/s). As in the backward kernels, what holds it above that is shared
// memory (wgmma reads the block's own q planes again every step) and the
// softmax arithmetic between the products, which the two warpgroups of an
// SM hide from one another.

#include "flash_attention_common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMinBlocks = 2;  // blocks an SM: bounds the registers
// Q hi and lo planes, a step's K and V hi and lo planes, then a word a step
// row for the keys' segment ids and one an own row for the queries'
constexpr int kWords = 2 * kOwnPlane + 4 * kStepPlane + kStep + kOwn;

// Dynamic shared memory of a block: its words and one byte a step.
constexpr size_t smem_bytes(int64_t n_steps) {
  return sizeof(float) * kWords + static_cast<size_t>((n_steps + 15) / 16 * 16);
}

// kStats also writes each query row's softmax statistics, the row maximum m
// and the row sum l = sum_j exp(s_ij - m_i), f32 [B, H, Lq] each: what the
// backward kernels (flash_attention_bwd.cu) recompute the probabilities
// from, as the library's forward does under differentiation (:246-251).
template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int32_t* __restrict__ seg_q,
                       const int32_t* __restrict__ seg_kv, int64_t H, int64_t Lq,
                       int64_t Lk, float sm_scale, float* __restrict__ out,
                       float* __restrict__ l_out, float* __restrict__ m_out) {
  extern __shared__ __align__(1024) float4 smem4[];
  if (__cvta_generic_to_shared(smem4) % 1024 != 0) __trap();  // the planes' swizzle
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem4);  // Q hi, Q lo
  uint32_t* sK = sQ + 2 * kOwnPlane;  // the step: K hi, K lo, V hi, V lo
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

  int32_t qseg[2] = {0, 0};
  if (masked) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t r = q0 + row + 8 * hh;
      if (r < Lq) qseg[hh] = seg_q[b * Lq + r];
    }
    // rows past Lq are written nowhere: they take row q0's id, which keeps
    // no step alive that a real row does not
    if (tid < kOwn) sOwnSeg[tid] = seg_q[b * Lq + (q0 + tid < Lq ? q0 + tid : q0)];
    __syncthreads();
    // a real row whose id no key carries keeps every step alive; rows of
    // one segment are runs, so a warp looks an id up once a run
    bool lonely = false, found = true;
    int32_t last = 0;
    for (int i = 0; i < 16 && q0 + warp * 16 + i < Lq; ++i) {
      const int32_t id = sOwnSeg[warp * 16 + i];
      if (i == 0 || id != last) {
        bool any = false;
        for (int64_t j = lane; j < Lk; j += 32) any |= seg_kv[b * Lk + j] == id;
        found = __any_sync(0xffffffffu, any);
        last = id;
      }
      lonely |= !found;
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
    // the block's 64 query rows, split into planes; rows past Lq are zero
    constexpr int kPieces = kOwn * kVecs / kThreads;
    constexpr int kRowsAPass = kThreads / kVecs;
    const float* qb = q + (bh * Lq + q0) * kHD + Tiles<kOwn>::first_word(tid);
    uint32_t* at = sQ + Tiles<kOwn>::first_piece(tid);
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int r = tid / kVecs + i * kRowsAPass;
      const float4 x = q0 + r < Lq
                           ? *reinterpret_cast<const float4*>(qb + i * kRowsAPass * kHD)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      store_split4(at + i * kRowsAPass * 32, at + i * kRowsAPass * 32 + kOwnPlane, x);
    }
  }
  if (cur < n_steps) store();
  fence_stores_for_wgmma();
  __syncthreads();  // Q and the first step are in shared memory

  const uint64_t q_desc = wgmma_desc(sQ), k_desc = wgmma_desc(sK);

  // o's fragments: element 4n + 2h + c at (row + 8h, head column 8n + 2t + c);
  // m and the lane's part of l for rows row and row + 8
  float acc[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) acc[i] = 0.0f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.0f, 0.0f};

  while (cur < n_steps) {
    // the next live step's loads run under this step's products
    const int nxt = next_live(sLive, masked, cur + 1, n_steps);
    if (nxt < n_steps) fetch(nxt);

    // s = Q K^T of the block's 64 queries against the step's keys: element
    // 4j + 2h + c is (query row + 8h, key 8j + 2t + c)
    float p[4 * kNT], p_small[4 * kNT];
    wgmma_fence();
    wgmma_rows_dot_rows(p, p_small, q_desc, kOwnLo, kOwn, k_desc, kStepLo, kStep);
    wgmma_commit();
    wgmma_wait();
    float step_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
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
          p[e] = x;
          step_max[hh] = fmaxf(step_max[hh], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // the quad holds the step's 32 keys of a row
      step_max[hh] = fmaxf(step_max[hh], __shfl_xor_sync(0xffffffffu, step_max[hh], 1));
      step_max[hh] = fmaxf(step_max[hh], __shfl_xor_sync(0xffffffffu, step_max[hh], 2));
      const float m_new = fmaxf(m_r[hh], step_max[hh]);
      alpha[hh] = expf(m_r[hh] - m_new);  // 0 on the first step
      m_r[hh] = m_new;
      l_r[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * hh + c;
          p[e] = expf(p[e] - m_r[hh]);
          l_r[hh] += p[e];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[4 * n + 2 * hh] *= alpha[hh];
        acc[4 * n + 2 * hh + 1] *= alpha[hh];
      }
    }
    add_regs_dot_plane<kNT, kHD, kStep, kStepPlane, 4>(p, sV, down, acc);  // o += p V

    __syncthreads();  // every warp has read this step
    if (nxt < n_steps) store();
    fence_stores_for_wgmma();
    __syncthreads();
    cur = nxt;
  }

  // o = acc / l; l >= 1, since the row's largest score contributes exp(0)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 1);
    l_r[hh] += __shfl_xor_sync(0xffffffffu, l_r[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = q0 + row + 8 * hh;
    if (r >= Lq) continue;
    float* ob = out + (bh * Lq + r) * kHD + 2 * t;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      *reinterpret_cast<float2*>(ob + 8 * n) = make_float2(
          acc[4 * n + 2 * hh] / l_r[hh], acc[4 * n + 2 * hh + 1] / l_r[hh]);
    }
    if constexpr (kStats) {
      if (t == 0) {
        l_out[bh * Lq + r] = l_r[hh];
        m_out[bh * Lq + r] = m_r[hh];
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
  if (Lk <= 0 || Lk % kOwn != 0 || hd != kHD || any % 16 != 0 || B > 65535 ||
      H > 65535 || (seg_q == nullptr) != (seg_kv == nullptr) ||
      (kStats && (l_out == nullptr || m_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(Lk / kStep);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Lq + kOwn - 1) / kOwn),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_attention_kernel<kStats><<<grid, kThreads, smem,
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
