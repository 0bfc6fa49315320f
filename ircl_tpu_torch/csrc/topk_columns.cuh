// Per-column light-pool add and tile top-k, shared by the kernels that end
// in the light_add_topk_t epilogue: light_add_topk.cu, fused_hybrid.cu and
// fused_dot_light.cu.
//
// One thread owns one (d-tile, column) pair. It hands its tile's rows to
// add_row() from the LAST row to the first, each with the row's heavy score.
// The pools are doc-ascending down a column, so the tile's pool window
// [#(doc < d_lo), #(doc < d_hi)) comes from two binary searches; pads (any
// doc id at or past d_hi of the last tile) fall outside every window and are
// never read. A row's total is its heavy score plus the run of pool entries
// for that doc, summed in pool order, which is the order of the Pallas loop.
// The row then enters a best-first list kept in the thread's own output
// rows (entry r of column b at out[r * B]). Rows arrive in descending order,
// so a strict compare keeps the larger row ahead on a tie: the Pallas rule
// (ties to the largest row). After the first k rows a row enters the list
// only if it beats the k-th score, held in a register, so the list is rarely
// touched. finish() writes the k8 - k pad entries (-3.4e38 / -1).

#pragma once

#include <cstdint>

namespace ircl {

constexpr float kNegScore = -3.4e38f;

__device__ __forceinline__ int64_t column_lower_bound(
    const int32_t* __restrict__ docs, int64_t P, int64_t B, int64_t b,
    int64_t v) {
  int64_t lo = 0, hi = P;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(docs[mid * B + b]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct ColumnTopK {
  const int32_t* docs;    // [P, B] pool docs, ascending down the column
  const float* contribs;  // [P, B]
  int64_t B, b;
  int64_t p_lo;      // first pool entry of the tile's window
  int64_t q;         // pool entries [p_lo, q) belong to rows not yet visited
  int64_t next_doc;  // doc of entry q - 1, or -1 when the window is used up
  float* s;          // list entry r at s[r * B]
  int32_t* rows;
  int k, filled;
  float kth;  // k-th best score, once the list is full

  // The tile covers docs [d_lo, d_hi); out_s / out_i point at list entry 0
  // of this (tile, column).
  __device__ __forceinline__ void begin(const int32_t* docs_, const float* contribs_,
                                        int64_t P, int64_t B_, int64_t b_,
                                        int64_t d_lo, int64_t d_hi, float* out_s,
                                        int32_t* out_i, int k_) {
    docs = docs_;
    contribs = contribs_;
    B = B_;
    b = b_;
    p_lo = column_lower_bound(docs, P, B, b, d_lo);
    q = column_lower_bound(docs, P, B, b, d_hi);
    next_doc = q > p_lo ? docs[(q - 1) * B + b] : -1;
    s = out_s;
    rows = out_i;
    k = k_;
    filled = 0;
    kth = 0.0f;
  }

  // Row d (descending from call to call) with heavy score x.
  __device__ __forceinline__ void add_row(int64_t d, float x) {
    if (next_doc == d) {
      const int64_t run_end = q;
      while (q > p_lo && docs[(q - 1) * B + b] == d) --q;
      for (int64_t p = q; p < run_end; ++p) x += contribs[p * B + b];
      next_doc = q > p_lo ? docs[(q - 1) * B + b] : -1;
    }
    int j;
    if (filled < k) {
      j = filled++;
    } else if (x > kth) {
      j = k - 1;  // the old k-th drops out
    } else {
      return;
    }
    while (j > 0 && x > s[(j - 1) * B]) {
      s[j * B] = s[(j - 1) * B];
      rows[j * B] = rows[(j - 1) * B];
      --j;
    }
    s[j * B] = x;
    rows[j * B] = static_cast<int32_t>(d);
    if (filled == k) kth = s[(k - 1) * B];
  }

  __device__ __forceinline__ void finish(int k8) {
    for (int r = k; r < k8; ++r) {
      s[r * B] = kNegScore;
      rows[r * B] = -1;
    }
  }
};

}  // namespace ircl
