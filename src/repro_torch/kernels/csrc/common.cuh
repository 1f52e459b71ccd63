// Block-level helpers shared by the kernels. Every reduction and scan here
// combines values in a fixed order, so a kernel gives the same bits on every
// run (no float atomics anywhere).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Element loads and stores of the two input types the panel kernels take;
// arithmetic is float32 either way.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// Sums of N values over the block in one exchange, valid in every thread.
// Each is summed in a fixed order. All threads of the block must call.
template <int THREADS, int N>
__device__ __forceinline__ void block_sum_all(float (&v)[N]) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
  constexpr int kWarps = THREADS / 32;
  __shared__ float warp_sums[N][kWarps];
#pragma unroll
  for (int q = 0; q < N; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_down_sync(kFullMask, v[q], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) warp_sums[q][threadIdx.x >> 5] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += warp_sums[q][w];
    v[q] = t;
  }
  __syncthreads();  // warp_sums is reused by the next call
}

// For each of N values: the sum over the threads whose index is greater
// than the caller's (exclusive suffix), in one exchange. All threads call.
template <int THREADS, int N>
__device__ __forceinline__ void block_exclusive_suffix_all(
    const float (&v)[N], float (&after)[N]) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
  constexpr int kWarps = THREADS / 32;
  __shared__ float warp_sums[N][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    s[q] = v[q];  // becomes the sum over lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFullMask, s[q], off);
      if (lane + off < 32) s[q] += y;
    }
    float excl = __shfl_down_sync(kFullMask, s[q], 1);
    after[q] = lane == 31 ? 0.f : excl;
    if (lane == 0) warp_sums[q][warp] = s[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float a = 0.f;
    for (int w = kWarps - 1; w > warp; --w) a += warp_sums[q][w];
    after[q] += a;
  }
  __syncthreads();  // warp_sums is reused by the next call
}

}  // namespace repro
