// Fused per-coordinate Cox derivatives (Theorem 3.1 of FastSurvival) for one
// feature column, with Breslow ties.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cox_coord.py::_make_kernel
// (pallas_call in _cox_coord_jit). Given time-sorted eta, x, delta and each
// sample's risk_start (the first index of its tie group):
//
//   w    = exp(eta - max eta)
//   S_r  = suffix_sum(w * x^r),                  r = 0..order
//   m_r  = S_r[risk_start[i]] / max(S_0[risk_start[i]], 1e-30)
//   g    = sum_i delta_i (m1 - x_i)
//   h    = sum_i delta_i (m2 - m1^2)
//   c3   = sum_i delta_i (m3 + 2 m1^3 - 3 m2 m1)      (order 3 only)
//
// The TPU kernel walks the n-blocks in order and carries the running
// suffix in VMEM; it is tie-free (it reads S at i, not at risk_start[i]).
// Hopper blocks run in no order, so the carry becomes a decoupled scan in
// four launches:
//   1. coord_local_suffix: each block of 1024 samples forms w*x^r and its
//      block-local suffix sums (written to scratch), plus the block totals;
//   2. coord_block_offsets: one block turns the totals into the exclusive
//      suffix over blocks (what every block must add);
//   3. coord_gather: S at risk_start[i] is the local suffix plus its block's
//      offset; each block reduces its delta-weighted terms to one partial;
//   4. coord_final: one block sums the partials in a fixed order.
// Adding the offsets at the gather saves a read-modify-write pass over S.
// Only the moments 0..order are formed: the TPU kernel also forms an
// (order+1)-th that it never reads.
//
// What bounds it on an H100: bytes. The function reads eta, x, delta and
// risk_start once (16 bytes a sample) and does ~30 flops and one exp a
// sample, far below the card's 295 flops/byte ridge. This design also
// writes and re-reads S ((order+1) * 4 bytes a sample each way) and pays
// four launches, which dominate at the sizes CD uses (n ~ 1e5..1e6 is
// 1.6..16 MB, microseconds of traffic). Fusing the launches (a single-pass
// decoupled look-back scan) is left for a later change.
//
// No float atomics: every sum has a fixed order, so a CD trajectory is
// bitwise reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // samples per block
constexpr int kScanThreads = 1024;
constexpr int kMaxMoments = 4;  // S_0..S_3 for order 3

__global__ void __launch_bounds__(kThreads)
coord_local_suffix(const float* __restrict__ eta, const float* __restrict__ x,
                   const float* __restrict__ eta_max, int n, int k, int nb,
                   float* __restrict__ s_local, float* __restrict__ totals) {
  __shared__ float sw[kTile];
  __shared__ float sx[kTile];
  const int base = blockIdx.x * kTile;
  const float m = *eta_max;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = base + j;
    float w = 0.f, xv = 0.f;
    if (i < n) {
      xv = x[i];
      w = expf(eta[i] - m);
    }
    sw[j] = w;
    sx[j] = xv;
  }
  __syncthreads();
  const int first = threadIdx.x * kItems;
  float p[kItems], xs[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    p[q] = sw[first + q];
    xs[q] = sx[first + q];
  }
  for (int r = 0; r < k; ++r) {
    if (r > 0) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) p[q] *= xs[q];
    }
    float suf[kItems];
    float acc = 0.f;
#pragma unroll
    for (int q = kItems - 1; q >= 0; --q) {
      acc += p[q];
      suf[q] = acc;
    }
    float total;
    const float after = repro::block_exclusive_suffix<kThreads>(acc, &total);
    float* row = s_local + static_cast<size_t>(r) * n;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = base + first + q;
      if (i < n) row[i] = suf[q] + after;
    }
    if (threadIdx.x == 0) totals[r * nb + blockIdx.x] = total;
  }
}

// In place: totals[r][b] <- sum over b' > b of totals[r][b'].
__global__ void __launch_bounds__(kScanThreads)
coord_block_offsets(float* __restrict__ totals, int k, int nb) {
  for (int r = 0; r < k; ++r) {
    float* t = totals + static_cast<size_t>(r) * nb;
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
}

__global__ void __launch_bounds__(kThreads)
coord_gather(const float* __restrict__ x, const float* __restrict__ delta,
             const int* __restrict__ risk_start,
             const float* __restrict__ s_local,
             const float* __restrict__ offsets, int n, int order, int nb,
             float* __restrict__ partials) {
  const int k = order + 1;
  float g = 0.f, h = 0.f, c3 = 0.f;
  const int base = blockIdx.x * kTile;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = base + q * kThreads + threadIdx.x;
    if (i < n) {
      const int rs = risk_start[i];
      const int blk = rs / kTile;
      float s[kMaxMoments];
#pragma unroll
      for (int r = 0; r < kMaxMoments; ++r) {
        s[r] = r < k ? s_local[static_cast<size_t>(r) * n + rs] +
                           offsets[r * nb + blk]
                     : 0.f;
      }
      const float s0 = fmaxf(s[0], 1e-30f);
      const float m1 = s[1] / s0;
      const float m2 = s[2] / s0;
      const float d = delta[i];
      g += d * (m1 - x[i]);
      h += d * (m2 - m1 * m1);
      if (order >= 3) {
        const float m3 = s[3] / s0;
        c3 += d * (m3 + 2.f * m1 * m1 * m1 - 3.f * m2 * m1);
      }
    }
  }
  g = repro::block_sum<kThreads>(g);
  h = repro::block_sum<kThreads>(h);
  c3 = repro::block_sum<kThreads>(c3);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = g;
    partials[3 * blockIdx.x + 1] = h;
    partials[3 * blockIdx.x + 2] = c3;
  }
}

__global__ void __launch_bounds__(kScanThreads)
coord_final(const float* __restrict__ partials, int nb,
            float* __restrict__ out) {
  for (int q = 0; q < 3; ++q) {
    float v = 0.f;
    for (int b = threadIdx.x; b < nb; b += kScanThreads) v += partials[3 * b + q];
    v = repro::block_sum<kScanThreads>(v);
    if (threadIdx.x == 0) out[q] = v;
  }
}

}  // namespace

extern "C" {

// Floats of scratch that repro_cox_coord needs for n samples.
long long repro_cox_coord_scratch_floats(int n, int order) {
  const long long k = order + 1;
  const long long nb = (n + kTile - 1) / kTile;
  return k * n + k * nb + 3 * nb;
}

// out (3,) <- (g, h, c3); c3 is 0 for order 2. eta_max is a device scalar.
int repro_cox_coord(const float* eta, const float* x, const float* delta,
                    const int* risk_start, const float* eta_max, int n,
                    int order, float* scratch, float* out, void* stream) {
  if (n <= 0 || order < 2 || order > 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = order + 1;
  const int nb = (n + kTile - 1) / kTile;
  float* s_local = scratch;
  float* offsets = s_local + static_cast<size_t>(k) * n;
  float* partials = offsets + static_cast<size_t>(k) * nb;
  cudaError_t err;
  coord_local_suffix<<<nb, kThreads, 0, st>>>(eta, x, eta_max, n, k, nb,
                                              s_local, offsets);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  coord_block_offsets<<<1, kScanThreads, 0, st>>>(offsets, k, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  coord_gather<<<nb, kThreads, 0, st>>>(x, delta, risk_start, s_local,
                                        offsets, n, order, nb, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  coord_final<<<1, kScanThreads, 0, st>>>(partials, nb, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
