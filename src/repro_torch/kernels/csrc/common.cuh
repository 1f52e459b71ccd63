// Block-level helpers shared by the kernels. Every reduction and scan here
// combines values in a fixed order, so a kernel gives the same bits on every
// run (no float atomics anywhere).
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum of `v` over the threads of the block whose index is greater than the
// caller's (exclusive suffix). `*total` receives the sum over the whole
// block, the same value in every thread. All threads of the block must call.
template <int THREADS, typename T>
__device__ __forceinline__ T block_exclusive_suffix(T v, T* total) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
  constexpr int kWarps = THREADS / 32;
  __shared__ T warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T s = v;  // becomes the sum over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_down_sync(kFullMask, s, off);
    if (lane + off < 32) s += y;
  }
  T excl = __shfl_down_sync(kFullMask, s, 1);  // sum over lanes > lane
  if (lane == 31) excl = T(0);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  T after = T(0);
  for (int w = kWarps - 1; w > warp; --w) after += warp_sums[w];
  T tot = T(0);
  for (int w = kWarps - 1; w >= 0; --w) tot += warp_sums[w];
  __syncthreads();  // warp_sums is reused by the next call
  *total = tot;
  return excl + after;
}

// Sum of `v` over the block, valid in thread 0 only. All threads must call.
template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
  constexpr int kWarps = THREADS / 32;
  __shared__ T warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) tot += warp_sums[w];
  }
  __syncthreads();  // warp_sums is reused by the next call
  return tot;
}

}  // namespace repro
