// f32 matrix products on the tensor cores at f32 accuracy: the split of an
// f32 value into two TF32 values, shared-memory planes of split values in the
// layout the warpgroup instruction reads, and two tile products built on
// them, each as the three products hi.hi + (lo.hi + hi.lo).
//
// One TF32 product keeps a 10-bit mantissa, three decimal digits. With
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (ties away),
// hi + lo is within 2^-22 of x, and hi.hi + lo.hi + hi.lo leaves out only
// lo.lo, at most 2^-22 of the product: close to an f32 product's own
// rounding, at a third of the TF32 rate. The small terms go into an
// accumulator of their own and are added once, so they are not rounded away
// against the large sum.
//
// A tile is split once by the block that stages it, into a hi plane and a lo
// plane, so that the warps that share it do not each repeat the split. A
// plane is K-major (a row's columns are contiguous; a product that reads it
// through a descriptor sums over its columns) in the 128-byte swizzle: R rows
// (R a multiple of 8) of 32 * A columns are A atoms one after the other, an
// atom R rows of 128 bytes, and the 16-byte piece c of row r sits at piece
// c ^ (r % 8) of that row. A plane's first byte is 1024-byte aligned.
//
// - wgmma_rows_dot_rows: A . B^T over the planes' columns, both operands read
//   from shared memory by wgmma.mma_async (four warps, 64 rows of A), the
//   only way to the tensor cores' full rate. 32-bit operands have no
//   transposed descriptors, so this covers products that sum over the
//   columns of both tiles.
// - add_regs_dot_plane: W . B over B's rows, W in registers, by the warp-level
//   mma.sync.m16n8k8. Its fragments (g = lane / 4, t = lane % 4):
//     A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//     B [ 8 x 8]: b0 (k = t, n = g), b1 (k = t + 4, n = g)
//     C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//   The warpgroup product leaves each warp its 16 rows as such C fragments
//   side by side, and a C fragment is the next product's A fragment without
//   leaving its registers when that product's k index is read in the order
//   0, 2, 4, 6, 1, 3, 5, 7 (k slots t and t + 4 are C's columns 2t and
//   2t + 1): a sum does not care, as long as B is loaded in the same order.
//   B's words (row 8j + 2t (+ 1), column 8n + g) lie in 32 different banks
//   of a swizzled plane, so the same planes serve both products and no tile
//   is transposed.

#pragma once

#include <cstdint>

namespace {

// x rounded to TF32 (a 10-bit mantissa), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for a finite x. Written as two integer
// operations on the bits (sign and magnitude: add half a unit of the last
// kept place, cut the 13 low bits) because sm_90 has no instruction for that
// conversion and the compiler emits a longer sequence with tests for NaN
// and infinity; the kernels' inputs are finite.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // the difference is exact in f32
}

// Four words split and stored into a hi plane and a lo plane, 16 bytes each.
__device__ __forceinline__ void store_split4(uint32_t* hi_at, uint32_t* lo_at,
                                             const float4& x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(hi_at) = hi;
  *reinterpret_cast<uint4*>(lo_at) = lo;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where a lane finds its B fragments of add_regs_dot_plane in a plane: rows
// 8j + 2t + i (i = 0, 1), columns 8n + g. at[n % 4][i] is the word offset for
// j = 0 and n < 4; a step in j adds 8 rows (256 words), n / 4 another atom.
// The swizzle makes the offset depend on n % 4 and on the row's last three
// bits only, so eight offsets a lane cover every fragment.
struct DownLane {
  int at[4][2];

  __device__ __forceinline__ DownLane(int g, int t) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        at[x][i] = (2 * t + i) * 32 + ((2 * x + g / 4) ^ (2 * t + i)) * 4 + g % 4;
      }
    }
  }
};

// acc += W . B: W [16 x 8 * NT] in registers as NT C fragments side by side
// (w[4j + 2h + c] is row g + 8h, column 8j + 2t + c), B the first 8 * NT rows
// and all kCols columns of the split planes of kRows rows at `plane` (hi) and
// `plane + kLoAt`; acc[4n + 2h + c] is row g + 8h, column 8n + 2t + c. Each
// call's product is summed by the tensor cores in fresh fragments (NT chained
// instructions) and added to acc with an ordinary f32 add, so acc sees one
// rounding a call whatever the tensor cores do inside. kGroup fragments are
// in flight together so that instructions sharing an accumulator lie apart.
template <int NT, int kCols, int kRows, int kLoAt, int kGroup>
__device__ __forceinline__ void add_regs_dot_plane(const float (&w)[4 * NT],
                                                   const uint32_t* plane,
                                                   const DownLane& lane,
                                                   float (&acc)[kCols / 2]) {
  uint32_t w_hi[NT][4], w_lo[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(w[4 * j + 0], w_hi[j][0], w_lo[j][0]);
    split_tf32(w[4 * j + 2], w_hi[j][1], w_lo[j][1]);
    split_tf32(w[4 * j + 1], w_hi[j][2], w_lo[j][2]);
    split_tf32(w[4 * j + 3], w_hi[j][3], w_lo[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < kCols / 8; n0 += kGroup) {
    float big[kGroup][4], small[kGroup][4];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][e] = small[i][e] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b_hi[kGroup][2], b_lo[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {  // k slots t, t + 4: rows 8j + 2t, + 1
        const int n = n0 + i;
        const uint32_t* p = plane + (n / 4) * kRows * 32 + j * 256;
        b_hi[i][0] = p[lane.at[n % 4][0]];
        b_hi[i][1] = p[lane.at[n % 4][1]];
        b_lo[i][0] = p[lane.at[n % 4][0] + kLoAt];
        b_lo[i][1] = p[lane.at[n % 4][1] + kLoAt];
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(small[i], w_lo[j], b_hi[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(big[i], w_hi[j], b_hi[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) mma_tf32(small[i], w_hi[j], b_lo[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * (n0 + i) + e] += big[i][e] + small[i][e];
    }
  }
}

// ---- the warpgroup product (wgmma) ----

// Word offset of the 16-byte piece holding columns 4c .. 4c + 3 of row r in a
// plane of `rows` rows.
__device__ __forceinline__ int swizzled_piece(int rows, int r, int c) {
  return (c / 8) * rows * 32 + r * 32 + ((c % 8) ^ (r % 8)) * 4;
}

// Descriptor of a plane (or of a point 32 * j bytes into one of its atoms):
// rows 128 bytes apart, groups of 8 rows 1024 bytes apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const void* plane) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(plane));
  return static_cast<uint64_t>((at & 0x3ffffu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{64} << 32) | (uint64_t{1} << 62);
}

// Descriptor units (16 bytes) from a plane's start to step kt of a plane of
// `rows` rows.
__device__ __forceinline__ uint64_t wgmma_step(int rows, int kt) {
  return static_cast<uint64_t>((kt / 4) * rows * 8 + (kt % 4) * 2);
}

// Before the first product, and after registers a product reads or adds to
// were written by ordinary instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared memory written by ordinary stores, made visible to the products.
__device__ __forceinline__ void fence_stores_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d [64 x 32] (+)= A [64 x 8] . B [32 x 8]^T, both from shared memory. Thread
// of warp w, g = lane / 4, t = lane % 4 holds d[4j + 2h + c] = element (16w +
// g + 8h, 8j + 2t + c): the C fragments of mma.m16n8k8, side by side.
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], uint64_t a, uint64_t b,
                                               bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(static_cast<int>(add)));
}

// big + small = A . B^T over 64 columns: A 64 rows and B 32 rows, each as
// split planes (hi at the descriptor given, lo `*_lo` descriptor units
// further). 24 instructions are started and not waited for: the caller
// commits and waits, and may start more first.
__device__ __forceinline__ void wgmma_rows_dot_rows(float (&big)[16], float (&small)[16],
                                                    uint64_t a, uint64_t a_lo,
                                                    int a_rows, uint64_t b,
                                                    uint64_t b_lo, int b_rows) {
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    const uint64_t at = a + wgmma_step(a_rows, kt), bt = b + wgmma_step(b_rows, kt);
    wgmma_m64n32k8(small, at + a_lo, bt, kt > 0);
    wgmma_m64n32k8(small, at, bt + b_lo, true);
    wgmma_m64n32k8(big, at, bt, kt > 0);
  }
}

}  // namespace
