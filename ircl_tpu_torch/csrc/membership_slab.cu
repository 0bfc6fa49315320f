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
// terms/contrib k-major [K, N] (term -1 and contrib 0 on pads).
//
// Design. The TPU had no fast scatter, so Pallas compared every slab cell
// with every k (U*N*K compares; the windowed kernel cut k to a value range).
// Hopper scatters cheaply. One thread owns one column d: it walks k in
// order, binary-searches terms[k, d] in u_sorted, and adds contrib[k, d]
// into M[pos, d] on a hit. That is N*K searches of log2(U) steps instead of
// U*N*K compares. No two threads share a column, so there are no atomics,
// and each cell sums its terms in the Pallas loop's k order: the slab is
// bit-identical to the TPU kernel's. The kernel adds, never assigns: query
// pads are bucket 0 with weight 0 and may land on a real slot 0. Ids below
// 0 are skipped, and a search that runs off the end of u_sorted never
// writes, so out-of-range ids cannot write out of bounds.
//
// Bound on this card: memory. The wrapper zeroes M first (U*N*4 bytes: 1.68
// GB at the 50K-doc bench shape, 0.5 ms at 3.35 TB/s), which outweighs the
// kernel's own traffic: the k-major reads are coalesced (neighbouring
// threads read neighbouring columns) and each hit is one scattered 4-byte
// read-modify-write. The searches read u_sorted (tens of KB) through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void membership_slab_kernel(const int32_t* __restrict__ u_sorted,
                                       int64_t U,
                                       const int32_t* __restrict__ terms,
                                       const float* __restrict__ contrib,
                                       int64_t K, int64_t N,
                                       float* __restrict__ out) {
  const int64_t d = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (d >= N) return;
  for (int64_t k = 0; k < K; ++k) {
    const int32_t t = terms[k * N + d];
    if (t < 0) continue;  // ELL pad
    const float c = contrib[k * N + d];
    int64_t lo = 0, hi = U;  // lower bound of t in u_sorted
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(u_sorted + mid) < t) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // Every slot equal to t matches, as in the compare contract.
    for (int64_t pos = lo; pos < U && __ldg(u_sorted + pos) == t; ++pos) {
      float* cell = out + pos * N + d;
      *cell = *cell + c;
    }
  }
}

}  // namespace

// out [U, N] must hold zeros on entry. Returns cudaGetLastError() after
// the launch.
extern "C" int ircl_membership_slab(const void* u_sorted, int64_t U,
                                    const void* terms, const void* contrib,
                                    int64_t K, int64_t N, void* out,
                                    void* stream) {
  if (N > 0 && U > 0 && K > 0) {
    const int threads = 256;
    const int64_t blocks = (N + threads - 1) / threads;
    membership_slab_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(u_sorted), U,
        static_cast<const int32_t*>(terms), static_cast<const float*>(contrib),
        K, N, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Name of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* ircl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
