// Suffix (reverse cumulative) sum along axis 0:
//
//   out[i, :] = sum_{k >= i} x[k, :]
//
// x is row-major (n, m), float32 or bfloat16; sums run in float32 and the
// output takes x's type, rounded once at the end.
//
// Replaces the Pallas TPU kernel src/repro/kernels/revcumsum.py::
// _revcumsum_kernel (pallas_call in _revcumsum_jit). That kernel walks the
// n-blocks from last to first on one core, forms each block's suffix with a
// triangular matmul on the MXU and carries the running total in a VMEM row.
// Hopper blocks run in no fixed order, so the carry cannot pass from block
// to block; the scan is split instead, in one of two layouts:
//
// m >= 32 (the streaming fit's (chunk_rows, p) panel of w x): rows are cut
// into chunks of 256, one thread per (chunk, column), neighbouring threads
// on neighbouring columns so every warp load is one line, as lipschitz.cu:
//   1. rcs_chunk_totals: each (chunk, column) sums its rows;
//   2. rcs_chunk_carry: per column, the exclusive suffix of those totals
//      over chunks (what lies below each chunk), in place;
//   3. rcs_walk: each (chunk, column) walks its rows from last to first,
//      starting from its carry, and writes the running sum.
// m < 32 (the (chunk_rows,) hazard vector w): one thread per column would
// leave m threads on the card, so the rows of each column are scanned
// cooperatively, as cox_coord.cu does:
//   1. rcs_local_suffix: each block of 1024 rows forms its block-local
//      suffix sums (to scratch) and its total;
//   2. rcs_block_offsets: one block per column scans the block totals;
//   3. rcs_finish: out = local suffix + its block's offset.
//
// What bounds it on an H100: bytes. The function must read x once and
// write out once (8 n m bytes in float32; 524 MB at (65,536, 1,000)) for
// one add an element. The m >= 32 layout reads x twice (steps 1 and 3), so
// it can reach two thirds of the bound at best.
//
// No float atomics: every sum has a fixed order, so a fit repeats its bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 256;  // rows per chunk, m >= 32 layout
constexpr int kColThreads = 32;
constexpr int kChunkThreads = 8;
constexpr int kCarryLanes = 32;
constexpr int kThreads = 256;  // m < 32 layout
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // rows per block
constexpr int kScanThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kColThreads * kChunkThreads)
rcs_chunk_totals(const T* __restrict__ x, int n, int m, int nc,
                 float* __restrict__ tot) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= m || c >= nc) return;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float s = 0.f;
#pragma unroll 8
  for (int i = hi - 1; i >= lo; --i) {
    s += repro::to_f32(x[static_cast<size_t>(i) * m + j]);
  }
  tot[static_cast<size_t>(c) * m + j] = s;
}

__global__ void __launch_bounds__(kColThreads * kCarryLanes)
rcs_chunk_carry(float* __restrict__ tot, int m, int nc) {
  repro::column_exclusive_suffix<kCarryLanes>(tot, m, nc);
}

template <typename T>
__global__ void __launch_bounds__(kColThreads * kChunkThreads)
rcs_walk(const T* __restrict__ x, int n, int m, int nc,
         const float* __restrict__ carry, T* __restrict__ out) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= m || c >= nc) return;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float s = carry[static_cast<size_t>(c) * m + j];
#pragma unroll 8
  for (int i = hi - 1; i >= lo; --i) {
    const size_t o = static_cast<size_t>(i) * m + j;
    s += repro::to_f32(x[o]);
    out[o] = repro::from_f32<T>(s);
  }
}

// local[j * n + i] <- sum of column j over i's block from i on;
// totals[j * nb + b] <- block b's sum of column j. Grid (nb, m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcs_local_suffix(const T* __restrict__ x, int n, int m, int nb,
                 float* __restrict__ local, float* __restrict__ totals) {
  __shared__ float sv[kTile];
  const int j = blockIdx.y;
  const int base = blockIdx.x * kTile;
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const int i = base + q;
    sv[q] = i < n ? repro::to_f32(x[static_cast<size_t>(i) * m + j]) : 0.f;
  }
  __syncthreads();
  const int first = threadIdx.x * kItems;
  float suf[kItems];
  float acc = 0.f;
#pragma unroll
  for (int q = kItems - 1; q >= 0; --q) {
    acc += sv[first + q];
    suf[q] = acc;
  }
  float total;
  const float after = repro::block_exclusive_suffix<kThreads>(acc, &total);
#pragma unroll
  for (int q = 0; q < kItems; ++q) sv[first + q] = suf[q] + after;
  __syncthreads();
  float* col = local + static_cast<size_t>(j) * n;
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const int i = base + q;
    if (i < n) col[i] = sv[q];
  }
  if (threadIdx.x == 0) totals[static_cast<size_t>(j) * nb + blockIdx.x] = total;
}

// In place, per column (one block each): totals[j][b] <- sum over b' > b.
__global__ void __launch_bounds__(kScanThreads)
rcs_block_offsets(float* __restrict__ totals, int nb) {
  float* t = totals + static_cast<size_t>(blockIdx.x) * nb;
  float carry = 0.f;
  for (int start = ((nb - 1) / kScanThreads) * kScanThreads; start >= 0;
       start -= kScanThreads) {
    const int b = start + threadIdx.x;
    const float v = b < nb ? t[b] : 0.f;
    float chunk_total;
    const float after =
        repro::block_exclusive_suffix<kScanThreads>(v, &chunk_total);
    if (b < nb) t[b] = after + carry;
    carry += chunk_total;
  }
}

template <typename T>
__global__ void rcs_finish(const float* __restrict__ local,
                           const float* __restrict__ offsets, int n, int m,
                           int nb, T* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(n) * m) return;
  const int i = static_cast<int>(e / m);
  const int j = static_cast<int>(e % m);
  out[e] = repro::from_f32<T>(local[static_cast<size_t>(j) * n + i] +
                              offsets[static_cast<size_t>(j) * nb + i / kTile]);
}

template <typename T>
int launch(const T* x, int n, int m, float* scratch, T* out,
           cudaStream_t st) {
  cudaError_t err;
  if (m >= kColThreads) {
    const int nc = (n + kChunk - 1) / kChunk;
    if ((nc + kChunkThreads - 1) / kChunkThreads > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kColThreads, kChunkThreads);
    const dim3 grid((m + kColThreads - 1) / kColThreads,
                    (nc + kChunkThreads - 1) / kChunkThreads);
    rcs_chunk_totals<T><<<grid, block, 0, st>>>(x, n, m, nc, scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rcs_chunk_carry<<<(m + kColThreads - 1) / kColThreads,
                      dim3(kColThreads, kCarryLanes), 0, st>>>(scratch, m, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rcs_walk<T><<<grid, block, 0, st>>>(x, n, m, nc, scratch, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int nb = (n + kTile - 1) / kTile;
  float* local = scratch;
  float* totals = scratch + static_cast<size_t>(n) * m;
  rcs_local_suffix<T><<<dim3(nb, m), kThreads, 0, st>>>(x, n, m, nb, local,
                                                        totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rcs_block_offsets<<<m, kScanThreads, 0, st>>>(totals, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(n) * m;
  rcs_finish<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      local, totals, n, m, nb, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch that repro_revcumsum needs for an (n, m) panel.
long long repro_revcumsum_scratch_floats(int n, int m) {
  if (m >= kColThreads) {
    const long long nc = (n + kChunk - 1) / kChunk;
    return nc * m;
  }
  const long long nb = (n + kTile - 1) / kTile;
  return static_cast<long long>(n) * m + nb * m;
}

// out (n, m) <- suffix sum of x (n, m) along rows; bf16 != 0 means both are
// bfloat16, else float32.
int repro_revcumsum(const void* x, int n, int m, int bf16, float* scratch,
                    void* out, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(x), n, m, scratch,
                  static_cast<__nv_bfloat16*>(out), st);
  }
  return launch(static_cast<const float*>(x), n, m, scratch,
                static_cast<float*>(out), st);
}

}  // extern "C"
