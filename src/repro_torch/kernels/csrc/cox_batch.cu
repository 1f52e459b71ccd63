// All-coordinate Cox gradient and diagonal Hessian on tie-free, time-sorted
// rows (the swapped-order GEMV form):
//
//   grad_j = sum_i r_i x_ij
//   hess_j = sum_i wa_i x_ij^2 - sum_i delta_i (s1_ij inv_s0_i)^2,
//   s1_ij  = sum_{k >= i} w_k x_kj
//
// from x (n, p), float32 or bfloat16, and the float32 vectors w, r = wa -
// delta, wa = w A, delta and inv_s0 = 1 / suffix(w) that the wrapper's
// caller forms in plain torch (ops.cox_batch_grad_hess).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cox_batch.py::_kernel
// (pallas_call in _cox_batch_jit). That kernel tiles (n, p) into panels on
// a (p-blocks, n-blocks) grid, walks the n-blocks from last to first and
// carries the suffix of w x in a VMEM row; both column sums and the suffix
// run on the MXU. Hopper blocks run in no fixed order, so the carry is
// split, in the (chunk, column) layout of revcumsum.cu and lipschitz.cu:
// rows are cut into chunks of 256, one thread per (chunk, column),
// neighbouring threads on neighbouring columns so every warp load of x is
// one line, and the vectors are warp-uniform loads:
//   1. cb_chunk_wx: each (chunk, column) sums w x over its rows;
//   2. cb_chunk_carry: per column, the exclusive suffix of those sums over
//      chunks (the part of s1 that lies below each chunk), in place;
//   3. cb_walk: each (chunk, column) walks its rows from last to first,
//      extending s1 from its carry, and accumulates r x, wa x^2 and
//      delta (s1 inv_s0)^2 in float64;
//   4. cb_finish: per column, the chunk partials summed in a fixed order by
//      a block of 32 columns x 32 lanes.
// The rows past n are never read: each chunk stops at min(lo + 256, n),
// where the TPU kernel pads them with zeros.
//
// What bounds it on an H100: bytes. The function must read x once plus the
// five vectors (4 n p + 20 n bytes in float32; 263 MB at (65,536, 1,000))
// for ~11 flops an element (~0.7 GFLOP there, 10.7 us at 67 TFLOP/s against
// 78.6 us of bytes). This design reads x twice (steps 1 and 3), so it can
// reach half the bound at best; fusing the two reads (a look-back over
// chunks) is left for a later change.
//
// No float atomics: every sum has a fixed order, so a fit repeats its bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 256;  // rows per chunk
constexpr int kColThreads = 32;
constexpr int kChunkThreads = 8;
constexpr int kLanes = 32;  // chunk lanes of the carry and finish blocks

template <typename T>
__global__ void __launch_bounds__(kColThreads * kChunkThreads)
cb_chunk_wx(const T* __restrict__ x, const float* __restrict__ w, int n,
            int p, int nc, float* __restrict__ ws) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= p || c >= nc) return;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float s = 0.f;
#pragma unroll 8
  for (int i = hi - 1; i >= lo; --i) {
    s += w[i] * repro::to_f32(x[static_cast<size_t>(i) * p + j]);
  }
  ws[static_cast<size_t>(c) * p + j] = s;
}

__global__ void __launch_bounds__(kColThreads * kLanes)
cb_chunk_carry(float* __restrict__ ws, int p, int nc) {
  repro::column_exclusive_suffix<kLanes>(ws, p, nc);
}

template <typename T>
__global__ void __launch_bounds__(kColThreads * kChunkThreads)
cb_walk(const T* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ r, const float* __restrict__ wa,
        const float* __restrict__ delta, const float* __restrict__ inv_s0,
        int n, int p, int nc, const float* __restrict__ carry,
        double* __restrict__ pg, double* __restrict__ ph) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= p || c >= nc) return;
  const size_t o = static_cast<size_t>(c) * p + j;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float s1 = carry[o];
  double g = 0.0, h1 = 0.0, h2 = 0.0;
#pragma unroll 4
  for (int i = hi - 1; i >= lo; --i) {
    const float xv = repro::to_f32(x[static_cast<size_t>(i) * p + j]);
    s1 += w[i] * xv;
    const float mean = s1 * inv_s0[i];
    g += static_cast<double>(r[i] * xv);
    h1 += static_cast<double>(wa[i] * xv * xv);
    h2 += static_cast<double>(delta[i] * mean * mean);
  }
  pg[o] = g;
  ph[o] = h1 - h2;
}

// grad[j] <- sum_c pg[c, j]; hess[j] <- sum_c ph[c, j]. Block (32, kLanes);
// lane y sums a contiguous run of chunks, the lanes combine in order.
__global__ void __launch_bounds__(kColThreads * kLanes)
cb_finish(const double* __restrict__ pg, const double* __restrict__ ph,
          int p, int nc, float* __restrict__ grad, float* __restrict__ hess) {
  __shared__ double sg[kLanes][kColThreads + 1];
  __shared__ double sh[kLanes][kColThreads + 1];
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int y = threadIdx.y;
  const int per = (nc + kLanes - 1) / kLanes;
  const int lo = y * per;
  const int hi = min(lo + per, nc);
  double g = 0.0, h = 0.0;
  if (j < p) {
    for (int c = lo; c < hi; ++c) {
      g += pg[static_cast<size_t>(c) * p + j];
      h += ph[static_cast<size_t>(c) * p + j];
    }
  }
  sg[y][threadIdx.x] = g;
  sh[y][threadIdx.x] = h;
  __syncthreads();
  if (y == 0 && j < p) {
    double gt = 0.0, ht = 0.0;
    for (int yy = 0; yy < kLanes; ++yy) {
      gt += sg[yy][threadIdx.x];
      ht += sh[yy][threadIdx.x];
    }
    grad[j] = static_cast<float>(gt);
    hess[j] = static_cast<float>(ht);
  }
}

struct Layout {
  double* pg;
  double* ph;
  float* ws;
};

Layout layout(void* scratch, int n, int p) {
  const size_t nc = (n + kChunk - 1) / kChunk;
  Layout l;
  l.pg = static_cast<double*>(scratch);
  l.ph = l.pg + nc * p;
  l.ws = reinterpret_cast<float*>(l.ph + nc * p);
  return l;
}

template <typename T>
int launch(const T* x, const float* w, const float* r, const float* wa,
           const float* delta, const float* inv_s0, int n, int p,
           void* scratch, float* grad, float* hess, cudaStream_t st) {
  const int nc = (n + kChunk - 1) / kChunk;
  if ((nc + kChunkThreads - 1) / kChunkThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout s = layout(scratch, n, p);
  const dim3 block(kColThreads, kChunkThreads);
  const dim3 grid((p + kColThreads - 1) / kColThreads,
                  (nc + kChunkThreads - 1) / kChunkThreads);
  const dim3 col_block(kColThreads, kLanes);
  const int col_grid = (p + kColThreads - 1) / kColThreads;
  cudaError_t err;
  cb_chunk_wx<T><<<grid, block, 0, st>>>(x, w, n, p, nc, s.ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cb_chunk_carry<<<col_grid, col_block, 0, st>>>(s.ws, p, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cb_walk<T><<<grid, block, 0, st>>>(x, w, r, wa, delta, inv_s0, n, p, nc,
                                     s.ws, s.pg, s.ph);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cb_finish<<<col_grid, col_block, 0, st>>>(s.pg, s.ph, p, nc, grad, hess);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch that repro_cox_batch needs for an (n, p) panel.
long long repro_cox_batch_scratch_bytes(int n, int p) {
  const long long nc = (n + kChunk - 1) / kChunk;
  return nc * p * (2 * sizeof(double) + sizeof(float));
}

// grad, hess (p,) from a time-sorted, tie-free row-major x (n, p) and the
// (n,) vectors; bf16 != 0 means x is bfloat16, else float32.
int repro_cox_batch(const void* x, const float* w, const float* r,
                    const float* wa, const float* delta, const float* inv_s0,
                    int n, int p, int bf16, void* scratch, float* grad,
                    float* hess, void* stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(x), w, r, wa, delta,
                  inv_s0, n, p, scratch, grad, hess, st);
  }
  return launch(static_cast<const float*>(x), w, r, wa, delta, inv_s0, n, p,
                scratch, grad, hess, st);
}

}  // extern "C"
