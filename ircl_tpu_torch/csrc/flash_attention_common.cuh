// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the head width, the block of one
// warpgroup, the mask value, and the walk of every kernel. A block owns 64
// rows of one sequence (16 a warp) and walks the other in steps of 32 rows;
// each step's two [32, 64] f32 tiles go from device memory through registers
// into split TF32 planes (mma_tf32.cuh), and the steps the segment ids empty
// are marked before the walk and never loaded.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kHD = 64;                // head width
constexpr int kThreads = 128;          // one warpgroup: wgmma's unit
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e+38);

constexpr int kOwn = 64;               // rows a block owns, 16 a warp
constexpr int kStep = 32;              // rows of the other sequence a step
constexpr int kNT = kStep / 8;         // C fragments across a step's rows
constexpr int kVecs = kHD / 4;         // 16-byte pieces of a row
constexpr int kOwnPlane = kOwn * kHD;    // words of a [64 x 64] plane
constexpr int kStepPlane = kStep * kHD;  // and of a [32 x 64] plane
// Descriptor units from a hi plane to its lo plane.
constexpr uint64_t kOwnLo = kOwnPlane * sizeof(float) / 16;
constexpr uint64_t kStepLo = kStepPlane * sizeof(float) / 16;

// ROWS rows of two [n_rows, 64] f32 matrices, on their way from device memory
// to split planes: this thread's 16-byte pieces (16 lanes a row, 8 rows a
// pass of the block), held in registers in between. The pointers given to
// fetch and store are the thread's own: its piece of the first row, and
// where that piece goes in a plane (Tiles::first_piece).
template <int ROWS>
struct Tiles {
  static constexpr int kPieces = ROWS * kVecs / kThreads;
  static constexpr int kRowsAPass = kThreads / kVecs;
  float4 a[kPieces], b[kPieces];

  __device__ __forceinline__ static int first_word(int tid) {
    return (tid / kVecs) * kHD + 4 * (tid % kVecs);
  }

  // 8 rows further the piece lies 8 * 32 words further: the swizzle reads
  // the row's last three bits only.
  __device__ __forceinline__ static int first_piece(int tid) {
    return swizzled_piece(ROWS, tid / kVecs, tid % kVecs);
  }

  __device__ __forceinline__ void fetch(const float* pa, const float* pb) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      a[i] = *reinterpret_cast<const float4*>(pa + i * kRowsAPass * kHD);
      b[i] = *reinterpret_cast<const float4*>(pb + i * kRowsAPass * kHD);
    }
  }

  // planes: a hi, a lo, b hi, b lo, ROWS * 64 words each.
  __device__ __forceinline__ void store(uint32_t* planes) const {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      uint32_t* at = planes + i * kRowsAPass * 32;
      store_split4(at, at + ROWS * kHD, a[i]);
      store_split4(at + 2 * ROWS * kHD, at + 3 * ROWS * kHD, b[i]);
    }
  }
};

// a query row whose largest score is under this has no key of its segment
constexpr float kNoKeyBelow = 0.5f * kMaskValue;

// live[s] for every step s of the other sequence: whether one of its rows
// shares a segment with one of the block's own rows, or `always`. A warp
// takes every fourth step, a lane its rows. `lonely` is what makes a row of
// the other sequence keep its step alive whatever the ids (dK/dV: the m of a
// query with no key), or null.
__device__ __forceinline__ void mark_live_steps(unsigned char* live, int n_steps,
                                                const int32_t* other_seg,
                                                const float* lonely,
                                                const int32_t* own_seg, bool always,
                                                int warp, int lane) {
  for (int s = warp; s < n_steps; s += kWarps) {
    bool any = always;
    for (int r = lane; r < kStep; r += 32) {
      const int64_t at = static_cast<int64_t>(s) * kStep + r;
      const int32_t id = other_seg[at];
      if (lonely != nullptr) any |= lonely[at] < kNoKeyBelow;
#pragma unroll 8
      for (int j = 0; j < kOwn; ++j) any |= id == own_seg[j];
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[s] = any ? 1 : 0;
  }
}

__device__ __forceinline__ int next_live(const unsigned char* live, bool masked, int s,
                                         int n_steps) {
  if (masked) {
    while (s < n_steps && live[s] == 0) ++s;
  }
  return s;
}

}  // namespace
