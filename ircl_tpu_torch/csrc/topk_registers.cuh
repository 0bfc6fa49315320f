// Per-column light-pool add and a best-first list held in registers, for
// the kernels that end in light_add_topk_t's epilogue with k <= 8:
// light_add_topk.cu and fused_dot_light.cu. (fused_hybrid.cu, and those two
// kernels for a larger k, keep ColumnTopK of topk_columns.cuh, whose list
// lives in the output rows.)
//
// PoolCursor: the run add of one column over a window of docs [d_lo, d_hi)
// whose rows are visited from the last to the first. The pools are
// doc-ascending down a column, so the window is [#(doc < d_lo), #(doc <
// d_hi)); pads (doc ids at or past the last tile's end) fall outside every
// window. A row's total is its heavy score plus the run of pool entries for
// that doc, summed in pool order: the order of the Pallas loop and of
// light_add_topk_t_ref, so the totals are bit-equal to theirs.
//
// lower_bounds: N of those searches at once, each in a range [lo, hi) of a
// column, by a fixed number of halving steps, so the N dependent chains of
// loads overlap.
//
// RegisterTopK<KR>: the KR best (score, row) pairs, best first, where a pair
// beats another by its score and, on equal scores, by the larger row (the
// Pallas rule). Every index is a compile-time constant, so the list stays in
// registers. push_descending is for rows that arrive from the last to the
// first (a strict compare then keeps the earlier, larger row ahead); push
// takes pairs in any order (merging lists). A caller with k < KR keeps the
// KR best and emits the first k: the same pairs, as the order is total.

#pragma once

#include <cstdint>

#include "topk_columns.cuh"

namespace ircl {

template <int N>
__device__ __forceinline__ void lower_bounds(const int32_t* __restrict__ docs, int64_t B,
                                             const int64_t (&col)[N],
                                             const int64_t (&lo)[N],
                                             const int64_t (&hi)[N],
                                             const int64_t (&v)[N], int64_t (&pos)[N]) {
  int64_t longest = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    pos[j] = lo[j];
    longest = hi[j] - lo[j] > longest ? hi[j] - lo[j] : longest;
  }
  if (longest <= 0) return;
  int64_t step = 1;
  while (step * 2 <= longest) step *= 2;
  for (; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t t = pos[j] + step;
      if (t <= hi[j] && static_cast<int64_t>(docs[(t - 1) * B + col[j]]) < v[j]) pos[j] = t;
    }
  }
}

// The window is handed over as pointers to its first entry and the stride
// between entries (B in device memory, 1 in a copy in shared memory), and
// its length n. The cursor holds the next run's docs and contributions in
// registers, loaded at the previous hit: a hit on a run of one or two
// entries adds them without waiting for memory, and only starts the loads
// of the run after it (a longer run is walked in memory).
struct PoolCursor {
  int32_t q;           // entries [0, q) belong to rows not yet visited
  int32_t d1, d2, d3;  // docs of entries q - 1, q - 2, q - 3 (-1 past the window)
  float c1, c2;        // contributions of entries q - 1, q - 2

  __device__ __forceinline__ void load(const int32_t* __restrict__ docs,
                                       const float* __restrict__ contribs,
                                       int64_t stride) {
    d1 = q >= 1 ? docs[(q - 1) * stride] : -1;
    d2 = q >= 2 ? docs[(q - 2) * stride] : -1;
    d3 = q >= 3 ? docs[(q - 3) * stride] : -1;
    c1 = q >= 1 ? contribs[(q - 1) * stride] : 0.0f;
    c2 = q >= 2 ? contribs[(q - 2) * stride] : 0.0f;
  }

  __device__ __forceinline__ void begin(const int32_t* __restrict__ docs,
                                        const float* __restrict__ contribs, int64_t stride,
                                        int32_t n) {
    q = n;
    load(docs, contribs, stride);
  }

  // Row d (descending from call to call, never negative) with heavy score
  // x: its total.
  __device__ __forceinline__ float add(const int32_t* __restrict__ docs,
                                       const float* __restrict__ contribs, int64_t stride,
                                       int32_t d, float x) {
    if (d1 == d) {
      if (d2 != d) {
        x += c1;
        q -= 1;
      } else if (d3 != d) {
        x += c2;  // pool order: entry q - 2 first
        x += c1;
        q -= 2;
      } else {
        const int32_t run_end = q;
        while (q > 0 && docs[(q - 1) * stride] == d) --q;
        for (int32_t p = q; p < run_end; ++p) x += contribs[p * stride];
      }
      load(docs, contribs, stride);
    }
    return x;
  }
};

template <int KR>
struct RegisterTopK {
  float s[KR];
  int32_t r[KR];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      s[i] = -__int_as_float(0x7f800000);  // -inf: any score enters
      r[i] = -1;
    }
  }

  __device__ __forceinline__ void push_descending(float x, int32_t d) {
    if (!(x > s[KR - 1])) return;
#pragma unroll
    for (int i = KR - 1; i > 0; --i) {
      const bool up = x > s[i - 1], here = x > s[i];
      s[i] = up ? s[i - 1] : (here ? x : s[i]);
      r[i] = up ? r[i - 1] : (here ? d : r[i]);
    }
    if (x > s[0]) {
      s[0] = x;
      r[0] = d;
    }
  }

  static __device__ __forceinline__ bool beats(float x, int32_t d, float y, int32_t e) {
    return x > y || (x == y && d > e);
  }

  __device__ __forceinline__ void push(float x, int32_t d) {
    if (!beats(x, d, s[KR - 1], r[KR - 1])) return;
#pragma unroll
    for (int i = KR - 1; i > 0; --i) {
      const bool up = beats(x, d, s[i - 1], r[i - 1]), here = beats(x, d, s[i], r[i]);
      s[i] = up ? s[i - 1] : (here ? x : s[i]);
      r[i] = up ? r[i - 1] : (here ? d : r[i]);
    }
    if (beats(x, d, s[0], r[0])) {
      s[0] = x;
      r[0] = d;
    }
  }

  // Entries 0..k-1 of the list, then k8 - k pads (-3.4e38 / -1), one every
  // `stride` elements from out_s / out_i (k <= KR).
  __device__ __forceinline__ void write(int k, int k8, float* __restrict__ out_s,
                                        int32_t* __restrict__ out_i, int64_t stride) const {
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      if (i < k) {
        out_s[i * stride] = s[i];
        out_i[i * stride] = r[i];
      }
    }
    for (int i = k; i < k8; ++i) {
      out_s[i * stride] = kNegScore;
      out_i[i * stride] = -1;
    }
  }
};

}  // namespace ircl
