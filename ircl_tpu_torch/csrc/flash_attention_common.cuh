// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the head width, the 128-thread
// block and the mask value; and what the forward's block is made of: a group
// of 8 lanes sharing 4 rows of a 64-row tile, the padded shared-memory row,
// and the cp.async tile copies. (The backward kernels' tiles are split planes
// in another layout: mma_tf32.cuh.)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kHD = 64;           // head width
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;   // lanes sharing a group of rows
constexpr int kPad = 4;           // floats of padding per shared row
constexpr int kQS = kHD + kPad;   // shared row stride of q, k, v (and do)
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e+38);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [n_rows, 64] f32 matrix into a shared tile of
// row stride kQS, 16 bytes a copy; rows past n_rows read zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t row0, int64_t n_rows, int tid) {
  constexpr int kVecs = kHD / 4;
  for (int idx = tid; idx < 64 * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = 4 * (idx % kVecs);
    float* d = dst + r * kQS + c;
    if (row0 + r < n_rows) {
      cp_async16(d, src + (row0 + r) * kHD + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

}  // namespace
