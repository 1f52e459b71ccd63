// The survival-curve panel of the scoring path, shared by
// survival_curves.cu (one baseline) and survival_curves_stratified.cu (a
// baseline per request):
//
//   S[r, c] = exp(-H0[k_r, c] * exp(clip(eta[r], -30, 30))),
//
// k_r = strata[r] for a stratified model; the single baseline is the case
// s = 1 with no strata read.
//
// What bounds it on an H100: bytes, and at the scoring path's sizes the
// launch itself. The panel is written once (4 b g bytes, 2.1 MB at
// b = 4,096, g = 128: 0.63 us at 3.35 TB/s); eta, strata and H0 are read
// once. The design keeps as little as possible between a warp's first load
// and its stores:
//
//  - A fixed number of blocks, a few an SM and no more than the work needs,
//    from the wrapper's launch plan (kernels/survival_curves.py::plan):
//    each warp writes a slab of up to kSlabMax rows and walks on to its
//    next slab by a stride of every warp of the grid.
//  - Columns are cut into chunks of 32 x VEC, one chunk a grid row (y); a
//    lane owns VEC neighbouring columns of its chunk. With g % 4 == 0
//    (VEC = 4) every row starts on 16 bytes and a lane writes its columns
//    with one 16-byte store, neighbouring lanes on neighbouring addresses:
//    at g = 128 one warp store is one whole row. Otherwise a lane writes
//    one float (VEC = 1). The last chunk of a row holds the tail, and its
//    lanes past the tail stay idle.
//  - The row-invariant factor exp(clip(eta)) is computed once a row: a
//    warp loads its slab's eta (and strata) in one coalesced load, lane i
//    row i, and __shfl_sync hands each row's factor (and stratum) to the
//    warp. An element costs one expf and a multiply.
//  - H0 is read once a block. A lane keeps its columns of the single
//    baseline in registers across all its rows, loaded while the first
//    slab's eta is in flight. A stratified table of up to kStagedStrata
//    strata (the plan says so) has its chunk staged in static shared
//    memory, 32 column slots a stratum: a thread issues all its loads
//    before it stores any, so the staging is one round trip beside the eta
//    load's. A larger table is read a row at a time through the read-only
//    path (__ldg).
//  - The single-baseline panel is stored evict-first (__stcs), the
//    stratified one with plain stores: each was the faster on the card.
//    Storing several rows a step, __ldg for a small table, a flat copy of
//    the table and staging 16 strata were measured too and lost (PERF.md;
//    scripts/ab_curves.py).
//
// Plain expf, no fast math: an element is a pure function of its inputs,
// so the same inputs give the same bits. Strata are not range-checked
// here; the engine checks them on the host.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace curves {

constexpr int kWarps = 4;          // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabMax = 32;       // rows of one eta load, lane i row i
constexpr int kMaxChunks = 65535;  // grid y
constexpr int kStagedStrata = 8;   // most strata staged in shared memory
// the staging loads a thread issues, 32 slots a stratum
constexpr int kStageLoads = kStagedStrata * 32 / kThreads;
constexpr float kClip = 30.f;

// VEC neighbouring columns: one 16-byte access, or one float.
template <int VEC>
using Cols = std::conditional_t<VEC == 4, float4, float>;

template <int VEC>
__device__ __forceinline__ void unpack(const Cols<VEC>& c, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    v[0] = c.x, v[1] = c.y, v[2] = c.z, v[3] = c.w;
  } else {
    v[0] = c;
  }
}

// VEC columns from p through the read-only path.
template <int VEC>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[VEC]) {
  unpack<VEC>(__ldg(reinterpret_cast<const Cols<VEC>*>(p)), v);
}

// VEC columns to p, evict-first (__stcs) when EVICT_FIRST.
template <int VEC, bool EVICT_FIRST>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[VEC]) {
  Cols<VEC> c;
  if constexpr (VEC == 4) {
    c = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    c = v[0];
  }
  if constexpr (EVICT_FIRST) {
    __stcs(reinterpret_cast<Cols<VEC>*>(p), c);
  } else {
    *reinterpret_cast<Cols<VEC>*>(p) = c;
  }
}

// The block's chunk of an (s, g) table, s <= kStagedStrata, into `staged`
// at 32 slots a stratum: slot i holds stratum i / 32, columns
// c0 + VEC (i % 32); slots past the chunk's width stay unwritten. A thread
// issues all its loads before it stores any, so the staging is one round
// trip.
template <int VEC>
__device__ __forceinline__ void stage(const float* __restrict__ h0, int g,
                                      int s, int c0, int width,
                                      Cols<VEC>* staged) {
  Cols<VEC> q[kStageLoads];
#pragma unroll
  for (int u = 0; u < kStageLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int t = i >> 5, j = i & 31;
    if (t < s && j * VEC < width)
      q[u] = __ldg(reinterpret_cast<const Cols<VEC>*>(
                       h0 + static_cast<size_t>(t) * g + c0) + j);
  }
#pragma unroll
  for (int u = 0; u < kStageLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if ((i >> 5) < s && (i & 31) * VEC < width) staged[i] = q[u];
  }
  __syncthreads();
}

// The values of loads issued together, all wanted here: an empty asm that
// takes them as outputs, so none of the loads can move past this point.
template <int VEC>
__device__ __forceinline__ void tie(float& e, int& k, float (&h)[VEC]) {
  asm volatile("" : "+f"(e), "+r"(k));
#pragma unroll
  for (int q = 0; q < VEC; ++q) asm volatile("" : "+f"(h[q]));
}

template <int VEC, bool STRATIFIED, bool STAGED>
__global__ void __launch_bounds__(kThreads)
curves_panel(const float* __restrict__ eta, const float* __restrict__ h0,
             const int* __restrict__ strata, int b, int g, int s, int slab,
             int tail, float* __restrict__ out) {
  constexpr int kChunk = 32 * VEC;
  __shared__ Cols<VEC> staged[STAGED ? kStagedStrata * 32 : 1];
  const int lane = threadIdx.x & 31;
  const int width = blockIdx.y + 1 == gridDim.y ? tail : kChunk;
  const int c0 = blockIdx.y * kChunk;
  const int col = c0 + lane * VEC;
  const bool holds = lane * VEC < width;

  // The first slab's eta (and strata) are asked for before the baseline,
  // so the two round trips overlap.
  const int stride = gridDim.x * kWarps * slab;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * slab;
  float e = 0.f;
  int k = 0;
  if (first < b && lane < min(slab, b - first)) {
    e = eta[first + lane];
    if (STRATIFIED) k = strata[first + lane];
  }
  float h[VEC] = {};
  if (!STRATIFIED && holds) load_cols<VEC>(h0 + col, h);
  if constexpr (STAGED) stage<VEC>(h0, g, s, c0, width, staged);
  tie(e, k, h);

  for (int r0 = first; r0 < b; r0 += stride) {
    const int rows = min(slab, b - r0);
    if (r0 != first && lane < rows) {
      e = eta[r0 + lane];
      if (STRATIFIED) k = strata[r0 + lane];
    }
    const float risk = expf(fminf(fmaxf(e, -kClip), kClip));
    for (int row = 0; row < rows; ++row) {  // the same in every lane
      const float rk = __shfl_sync(kFullMask, risk, row);
      const int kk = STRATIFIED ? __shfl_sync(kFullMask, k, row) : 0;
      if (holds) {
        float v[VEC];
        if constexpr (STAGED) {
          unpack<VEC>(staged[kk * 32 + lane], v);
        } else if constexpr (STRATIFIED) {
          load_cols<VEC>(h0 + static_cast<size_t>(kk) * g + col, v);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[q] = h[q];
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = expf(-(v[q] * rk));
        store_cols<VEC, !STRATIFIED>(
            out + static_cast<size_t>(r0 + row) * g + col, v);
      }
    }
  }
}

template <int VEC, bool STRATIFIED>
void launch_vec(dim3 grid, bool staged, const float* eta, const float* h0,
                const int* strata, int b, int g, int s, int slab, int tail,
                float* out, cudaStream_t stream) {
  if constexpr (STRATIFIED) {
    if (staged) {
      curves_panel<VEC, true, true><<<grid, kThreads, 0, stream>>>(
          eta, h0, strata, b, g, s, slab, tail, out);
      return;
    }
  }
  curves_panel<VEC, STRATIFIED, false><<<grid, kThreads, 0, stream>>>(
      eta, h0, strata, b, g, s, slab, tail, out);
}

// Launch the panel by the wrapper's plan: `blocks` blocks a column chunk,
// warps taking slabs of `slab` rows, VEC = `vec` columns a lane, `tail`
// columns in the last chunk, a stratified table of `s` strata staged in
// shared memory when `staged`. A plan that does not fit the shape is
// refused.
template <bool STRATIFIED>
cudaError_t launch(const float* eta, const float* h0, const int* strata,
                   int b, int g, int s, int blocks, int slab, int vec,
                   int tail, int staged, float* out, cudaStream_t stream) {
  if (b <= 0 || g <= 0 || s <= 0 || blocks <= 0 || slab < 1 ||
      slab > kSlabMax || (vec != 1 && vec != 4) || g % vec != 0 ||
      (staged && (!STRATIFIED || s > kStagedStrata)))
    return cudaErrorInvalidValue;
  const int chunk = 32 * vec;
  const int chunks = (g + chunk - 1) / chunk;
  const long long stride = static_cast<long long>(blocks) * kWarps * slab;
  if (chunks > kMaxChunks || tail != g - (chunks - 1) * chunk ||
      b + stride > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks, chunks);
  if (vec == 4)
    launch_vec<4, STRATIFIED>(grid, staged, eta, h0, strata, b, g, s, slab,
                              tail, out, stream);
  else
    launch_vec<1, STRATIFIED>(grid, staged, eta, h0, strata, b, g, s, slab,
                              tail, out, stream);
  return cudaGetLastError();
}

}  // namespace curves
}  // namespace repro
