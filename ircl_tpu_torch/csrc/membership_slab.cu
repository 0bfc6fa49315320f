// Membership slab of the sparse index, for Hopper (sm_90a).
//
// Replaces two TPU kernels of ircl_tpu/ops/membership_pallas.py:
//   _slab_kernel          (membership_slab)
//   _windowed_slab_kernel (membership_slab_windowed)
// Both compute the same slab, so one kernel serves both wrappers:
//
//   M[u, d] = sum_k contrib[k, d] * (terms[k, d] == u_sorted[u])
//
// with u_sorted ascending (non-negative ids, sentinel pads at the end) and
// terms/contrib k-major [K, N] (term -1 and contrib 0 on pads). The slab is
// written into out[u * ld + col0 + d], so two calls can fill the column
// ranges of one buffer (the width buckets of the staged engines).
//
// Design. The TPU had no fast scatter, so Pallas compared every slab cell
// with every k. Here a block owns 128 doc columns, one thread a column, and
// a range of rows: all U where the doc blocks alone fill the card, else a
// share of them, so that a narrow batch (the query slab) still has about
// 2048 blocks. It stages its rows' union slots in shared memory (at most
// 4096) and walks them in chunks of 64 rows: the [64, 128] tile is zero in
// shared memory, each thread adds its own doc's hits into its own tile
// column, and the block streams the tile out in 16-byte stores, one
// 512-byte row segment a warp, marked evict-first (__stcs): the slab is
// not read again here, and its stores would otherwise push out of L2 the
// terms that each block reads twice (the check, then the cursor). Every
// slab cell is written once; nothing is zeroed beforehand and nothing is
// read back. No two threads share a column, so there are no atomics, and
// each cell sums its terms in k order from 0, the Pallas loop's order: the
// slab is bit-identical to the compare contract (adding 0 where a term does
// not match changes no sum, because a sum from +0 is never -0).
//
// Each thread first reads its doc's terms once, sixteen loads in flight,
// to check that they ascend with the pads trailing and to count those below
// the block's first id (where a block whose rows start past slot 0 starts
// reading). A doc that passes is walked by a cursor that reads each term
// once, four loads in flight, in the chunk whose ids it falls among: it
// stops at the first term past the chunk's last id and resumes there in the
// next chunk, so the reads spread over the chunks and overlap the block's
// stores. It keeps `floor`, the first slot past the last term's: a term
// below that slot's id is not in the union (one compare), any other is
// binary-searched from there within the chunk (the first equal slot and the
// run of equal slots: a union padded with copies of its last value matches
// every copy, and such a run may span chunks). It stops reading once
// `floor` passes the block's rows. Equal terms of a doc stand together and
// hit the same slots, so the cursor sums their values first (from 0, in k
// order: the bits of the cells' own sums). A doc that fails the check (a
// query with bucket-0 pads after its terms, or a pad before a term) rereads
// its terms in every chunk, eight loads in flight, and searches only those
// inside the chunk's value range. So the slab never depends on the order
// of the terms: membership_slab_windowed's inputs ascend by contract and
// pass the check. Ids below 0 are skipped, and an id absent from the union
// has no run, so out-of-range ids never write. Query pads are bucket 0 with
// weight 0 and add 0 to a real slot 0.
//
// Bound on this card: memory. The slab is U*N*4 bytes written once (2.05 GB
// for both buckets at 1M docs, 0.61 ms at 3.35 TB/s), plus the ELL rows read
// once (K*N*8 bytes; every block of a split range reads its docs' terms
// again for the check, mostly from L2). The searches are shared-memory
// reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDocs = 128;               // doc columns (threads) a block
constexpr int kRows = 64;                // slab rows a chunk
constexpr int64_t kMaxBlockRows = 4096;  // rows a block, staged union slots
constexpr int64_t kTargetBlocks = 2048;  // split the rows until this many blocks
constexpr int kQuadsPerRow = kDocs / 4;  // 16-byte stores in a tile row

// A column's terms, read four ahead: the loads of the next three are in
// flight while the first is searched.
struct TermStream {
  const int32_t* p;  // terms + d, one term every N
  int64_t N, K, k;   // t0 is term k
  int32_t t0, t1, t2, t3;

  __device__ __forceinline__ int32_t at(int64_t i) const {
    return i < K ? p[i * N] : -1;
  }
  __device__ __forceinline__ void begin(const int32_t* p_, int64_t N_, int64_t K_,
                                        int64_t k0) {
    p = p_;
    N = N_;
    K = K_;
    k = k0;
    t0 = at(k0);
    t1 = at(k0 + 1);
    t2 = at(k0 + 2);
    t3 = at(k0 + 3);
  }
  __device__ __forceinline__ bool done() const { return k >= K; }
  __device__ __forceinline__ void pop() {
    t0 = t1;
    t1 = t2;
    t2 = t3;
    t3 = at(k + 4);
    ++k;
  }
};

// First slot in [lo, hi) whose id is not below t; u holds slots [r_lo, ...).
__device__ __forceinline__ int64_t lower_bound(const int32_t* u, int64_t r_lo,
                                               int64_t lo, int64_t hi, int32_t t) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (u[mid - r_lo] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kDocs)
membership_slab_kernel(const int32_t* __restrict__ u_sorted, int64_t U,
                       const int32_t* __restrict__ terms,
                       const float* __restrict__ contrib, int64_t K, int64_t N,
                       float* __restrict__ out, int64_t ld, int64_t col0,
                       int64_t block_rows, bool aligned) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // [kRows][kDocs]
  int32_t* su = reinterpret_cast<int32_t*>(tile + kRows * kDocs);  // slots R0..R1
  const int dl = threadIdx.x;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kDocs;
  const int64_t d = d0 + dl;
  const bool live = d < N;
  const int64_t R0 = static_cast<int64_t>(blockIdx.y) * block_rows;
  const int64_t R1 = R0 + block_rows < U ? R0 + block_rows : U;

  for (int64_t i = dl; i < R1 - R0; i += kDocs) su[i] = u_sorted[R0 + i];
  for (int i = dl; i < kRows * kQuadsPerRow; i += kDocs) {
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The check: terms ascend with the pads trailing. For such a doc, `lo`
  // counts the terms below the block's first id, where its cursor starts.
  bool ascending = live;
  int64_t lo = 0;
  if (live) {
    const int32_t first = R0 > 0 ? u_sorted[R0] : 0;
    int32_t prev = 0;
    bool pads = false;
    for (int64_t k0 = 0; k0 < K; k0 += 16) {
      int32_t t[16];  // sixteen loads in flight
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = k0 + i < K ? terms[(k0 + i) * N + d] : -1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool pad = t[i] < 0;
        ascending = ascending && (pad || (!pads && t[i] >= prev));
        if (!pad) prev = t[i];
        pads = pads || pad;
        lo += !pad && t[i] < first;
      }
    }
  }

  // The cursor. Slots below `floor` hold ids below every term not yet read;
  // a pending hit adds p_val to slots [p_lo, p_end).
  TermStream ts;
  if (ascending) ts.begin(terms + d, N, K, lo);
  int64_t floor = R0, p_lo = 0, p_end = 0;
  float p_val = 0.f;
  bool pending = false;

  __syncthreads();  // the union's slots are staged
  for (int64_t r0 = R0; r0 < R1; r0 += kRows) {
    const int64_t r1 = r0 + kRows < R1 ? r0 + kRows : R1;
    float* col = tile + dl;
    if (ascending) {
      const int32_t v_hi = su[r1 - 1 - R0];  // the chunk's last id
      while (true) {
        if (pending) {
          const int64_t s_end = p_end < r1 ? p_end : r1;
          for (int64_t s = p_lo > r0 ? p_lo : r0; s < s_end; ++s) {
            col[(s - r0) * kDocs] += p_val;
          }
          if (p_end > r1) break;  // the run goes on in the next chunk
          pending = false;
        }
        if (floor >= R1 || ts.done()) break;  // no hit left in these rows
        const int32_t t = ts.t0;
        if (t > v_hi) break;  // a later chunk's: read it there
        const int64_t kt = ts.k;
        ts.pop();
        // a pad, or below the next slot's id: not in the union
        if (t < 0 || t < su[floor - R0]) continue;
        p_lo = lower_bound(su, R0, floor, r1, t);  // t <= v_hi: inside the chunk
        p_end = p_lo;
        while (p_end < R1 && su[p_end - R0] == t) ++p_end;
        floor = p_end;
        if (p_end == p_lo) continue;  // not in the union
        // the doc's later copies of t come next (pads aside) and hit the
        // same run, which may reach into later chunks: sum them here, from 0
        // in k order, as the cells would
        p_val = 0.f;
        p_val += contrib[kt * N + d];
        while (!ts.done() && (ts.t0 < 0 || ts.t0 == t)) {
          if (ts.t0 == t) p_val += contrib[ts.k * N + d];
          ts.pop();
        }
        pending = true;
      }
    } else if (live) {
      const int32_t v_lo = su[r0 - R0], v_hi = su[r1 - 1 - R0];
      for (int64_t k0 = 0; k0 < K; k0 += 8) {
        int32_t t[8];  // eight loads in flight
#pragma unroll
        for (int i = 0; i < 8; ++i) t[i] = k0 + i < K ? terms[(k0 + i) * N + d] : -1;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (t[i] < 0 || t[i] < v_lo || t[i] > v_hi) continue;
          const float c = contrib[(k0 + i) * N + d];
          for (int64_t s = lower_bound(su, R0, r0, r1, t[i]);
               s < r1 && su[s - R0] == t[i]; ++s) {
            col[(s - r0) * kDocs] += c;
          }
        }
      }
    }
    __syncthreads();
    // stream the tile's rows out and zero them for the next chunk
    const int rows = static_cast<int>(r1 - r0);
    for (int q = dl; q < rows * kQuadsPerRow; q += kDocs) {
      const int row = q / kQuadsPerRow;
      const int64_t c = d0 + 4 * (q % kQuadsPerRow);
      float* dst = out + (r0 + row) * ld + col0 + c;
      const float4 v = smem4[q];
      if (aligned && c + 3 < N) {
        __stcs(reinterpret_cast<float4*>(dst), v);  // evict first
      } else if (c < N) {  // the ragged edge, or an unaligned buffer
        dst[0] = v.x;
        if (c + 1 < N) dst[1] = v.y;
        if (c + 2 < N) dst[2] = v.z;
        if (c + 3 < N) dst[3] = v.w;
      }
      smem4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }
}

int launch(const void* u_sorted, int64_t U, const void* terms, const void* contrib,
           int64_t K, int64_t N, void* out, int64_t ld, int64_t col0,
           void* stream) {
  if (N <= 0 || U <= 0) return static_cast<int>(cudaGetLastError());
  // Rows a block: all U where the doc blocks alone fill the card, else split
  // in multiples of a chunk until about kTargetBlocks blocks.
  const int64_t col_blocks = (N + kDocs - 1) / kDocs;
  const int64_t chunks = (U + kRows - 1) / kRows;
  int64_t splits = (kTargetBlocks + col_blocks - 1) / col_blocks;
  splits = splits < chunks ? splits : chunks;
  const int64_t min_splits = (U + kMaxBlockRows - 1) / kMaxBlockRows;
  splits = splits > min_splits ? splits : min_splits;
  const int64_t block_rows = (chunks + splits - 1) / splits * kRows;
  splits = (U + block_rows - 1) / block_rows;
  const size_t smem = sizeof(float) * kRows * kDocs + sizeof(int32_t) * block_rows;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        membership_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0 && ld % 4 == 0 &&
                       col0 % 4 == 0;
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(splits));
  membership_slab_kernel<<<grid, kDocs, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u_sorted), U, static_cast<const int32_t*>(terms),
      static_cast<const float*>(contrib), K, N, static_cast<float*>(out), ld, col0,
      block_rows, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u_sorted [U] i32 ascending, terms/contrib [K, N] i32/f32 k-major, in any
// order down a column; the slab goes to out[u * ld + col0 + d] for u < U,
// d < N (every such cell written, nothing else touched). Needs col0 + N <=
// ld, N / 128 < 2^31 and U / 64 < 65536 (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int ircl_membership_slab(const void* u_sorted, int64_t U,
                                    const void* terms, const void* contrib,
                                    int64_t K, int64_t N, void* out, int64_t ld,
                                    int64_t col0, void* stream) {
  return launch(u_sorted, U, terms, contrib, K, N, out, ld, col0, stream);
}

// Name of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* ircl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
