// Fused per-coordinate Cox derivatives (Theorem 3.1 of FastSurvival) for one
// feature column, with Breslow ties.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cox_coord.py::_make_kernel
// (pallas_call in _cox_coord_jit). Given time-sorted eta, x and delta:
//
//   w    = exp(eta - max eta)
//   S_r  = suffix_sum(w * x^r),                  r = 0..order
//   m_r  = S_r[risk_start[i]] / max(S_0[risk_start[i]], 1e-30)
//   g    = sum_i delta_i (m1 - x_i)
//   h    = sum_i delta_i (m2 - m1^2)
//   c3   = sum_i delta_i (m3 + 2 m1^3 - 3 m2 m1)      (order 3 only)
//
// The TPU kernel walks the n-blocks in order and carries the running suffix
// in VMEM; it is tie-free (it reads S at i, not at risk_start[i]).
//
// The tie gather is rewritten so that every term is local to its index:
// sum_i delta_i f(m(risk_start_i)) = sum_s D[s] f(m(s)), where D[s] is the
// event count of the tie group that starts at s (0 elsewhere). D depends on
// delta and risk_start only; the fit makes it once (kernels/ref.py::
// group_events) and lipschitz.cu takes the same D. A tie group spanning
// many tiles costs nothing extra.
//
// What bounds it on an H100: bytes. The function reads eta, x, delta and D
// once (16 bytes a sample; 4 MB at n = 262,144, 1.25 us at 3.35 TB/s) and
// does ~30 flops and one exp a sample, far below the card's ridge. At the
// sizes coordinate descent uses, launch and memory latency cost more than
// the traffic, so the design keeps to two launches, writes nothing of size
// n and keeps the dependent steps of each launch few:
//   1. coord_tile_aggregates: each tile of 1024 samples forms its local max
//      M_b and its moments T_r,b = sum w_b x^r with w_b = exp(eta - M_b);
//   2. coord_terms: each block issues the loads of its tile of eta, x,
//      delta and D, then one pass over the aggregates gives the
//      global max M and the later tiles' offsets O_r = sum over b' > b of
//      exp(M_b' - M) T_r,b' (the online-softmax rescaling, merged in a fixed
//      order); the block forms the in-tile suffix of exp(eta - M) x^r, adds
//      O_r and evaluates the terms at its own group starts. Its partial sums
//      go to scratch; the last block to finish (a ticket that it resets
//      itself, so no memset is needed) sums the partials in a fixed order.
// There is no separate max pass and S never reaches device memory.
//
// No float atomics: every sum has a fixed order, so a CD trajectory is
// bitwise reproducible.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // samples per block
constexpr int kHeaderFloats = 4;          // the ticket, padded to 16 bytes

// Shared-memory slot of tile element j: thread t reads its kItems contiguous
// elements t * kItems + q; one pad word every 32 keeps those reads off a
// common bank.
__device__ __forceinline__ int slot(int j) { return j + (j >> 5); }
constexpr int kSlots = kTile + kTile / 32;

struct Scratch {
  unsigned int* ticket;
  float* tile_max;  // (nb,)
  float* tile_tot;  // (k, nb)
  float* partials;  // (nb, 3)
};

__device__ __forceinline__ Scratch carve(float* scratch, int k, int nb) {
  Scratch s;
  s.ticket = reinterpret_cast<unsigned int*>(scratch);
  s.tile_max = scratch + kHeaderFloats;
  s.tile_tot = s.tile_max + nb;
  s.partials = s.tile_tot + static_cast<size_t>(k) * nb;
  return s;
}

// Max of `v` over the block, returned to every thread.
__device__ __forceinline__ float block_max_all(float v) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ float result;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(repro::kFullMask, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    result = m;
  }
  __syncthreads();
  return result;
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
coord_tile_aggregates(const float* __restrict__ eta,
                      const float* __restrict__ x, int n, int nb,
                      float* __restrict__ scratch) {
  constexpr int K = ORDER + 1;
  const Scratch s = carve(scratch, K, nb);
  const int base = blockIdx.x * kTile;
  float e[kItems], xv[kItems];
  float local = -INFINITY;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = base + q * kThreads + threadIdx.x;
    e[q] = i < n ? eta[i] : -INFINITY;
    xv[q] = i < n ? x[i] : 0.f;
    local = fmaxf(local, e[q]);
  }
  const float mb = block_max_all(local);  // finite: the tile holds a sample
  float t[K];
#pragma unroll
  for (int r = 0; r < K; ++r) t[r] = 0.f;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    float p = expf(e[q] - mb);  // 0 for the padding
#pragma unroll
    for (int r = 0; r < K; ++r) {
      t[r] += p;
      p *= xv[q];
    }
  }
  repro::block_sum_all<kThreads>(t);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) s.tile_tot[r * nb + blockIdx.x] = t[r];
    s.tile_max[blockIdx.x] = mb;
  }
}

// (running max, sums relative to it) of the later tiles' moments, merged
// with another such pair: the online-softmax rescaling.
template <int K>
__device__ __forceinline__ void merge(float& m, float (&o)[K], float m2,
                                      const float (&o2)[K]) {
  const float mm = fmaxf(m, m2);
  const float a = mm == -INFINITY ? 0.f : expf(m - mm);
  const float b = mm == -INFINITY ? 0.f : expf(m2 - mm);
#pragma unroll
  for (int r = 0; r < K; ++r) o[r] = o[r] * a + o2[r] * b;
  m = mm;
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
coord_terms(const float* __restrict__ eta, const float* __restrict__ x,
            const float* __restrict__ delta,
            const float* __restrict__ group_events, int n, int nb,
            float* __restrict__ scratch, float* __restrict__ out) {
  constexpr int K = ORDER + 1;
  const Scratch s = carve(scratch, K, nb);
  __shared__ float sw[kSlots];
  __shared__ float sx[kSlots];
  __shared__ float sd[kSlots];
  __shared__ float s_red[kThreads / 32][K + 2];
  __shared__ float s_off[K + 1];
  __shared__ bool s_last;

  // The tile's inputs, coalesced, issued before the aggregates are read
  // so that the two latencies overlap. Sum delta x on the way (a local
  // term of g).
  const int base = blockIdx.x * kTile;
  float e[kItems], xv[kItems], dv[kItems];
  float dx = 0.f;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = base + q * kThreads + threadIdx.x;
    e[q] = -INFINITY;
    xv[q] = dv[q] = 0.f;
    if (i < n) {
      e[q] = eta[i];
      xv[q] = x[i];
      dv[q] = group_events[i];
      dx += delta[i] * xv[q];
    }
  }

  // One pass over the tiles' aggregates: the global max M, and the later
  // tiles' moments as (running max, sums relative to it), each thread
  // taking tiles t, t + kThreads, ... in order, then merged across the
  // block in a fixed tree.
  float mx = -INFINITY, lm = -INFINITY;
  float o[K];
#pragma unroll
  for (int r = 0; r < K; ++r) o[r] = 0.f;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const float mb = s.tile_max[b];
    mx = fmaxf(mx, mb);
    if (b > static_cast<int>(blockIdx.x)) {
      float tb[K];
#pragma unroll
      for (int r = 0; r < K; ++r) tb[r] = s.tile_tot[r * nb + b];
      merge<K>(lm, o, mb, tb);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_down_sync(repro::kFullMask, mx, off));
    float o2[K];
#pragma unroll
    for (int r = 0; r < K; ++r)
      o2[r] = __shfl_down_sync(repro::kFullMask, o[r], off);
    merge<K>(lm, o, __shfl_down_sync(repro::kFullMask, lm, off), o2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[warp][0] = mx;
    s_red[warp][1] = lm;
#pragma unroll
    for (int r = 0; r < K; ++r) s_red[warp][2 + r] = o[r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mx = fmaxf(mx, s_red[w][0]);
      float o2[K];
#pragma unroll
      for (int r = 0; r < K; ++r) o2[r] = s_red[w][2 + r];
      merge<K>(lm, o, s_red[w][1], o2);
    }
    // offsets relative to the global max
    const float scale = lm == -INFINITY ? 0.f : expf(lm - mx);
#pragma unroll
    for (int r = 0; r < K; ++r) s_off[r] = o[r] * scale;
    s_off[K] = mx;
  }
  __syncthreads();
  const float M = s_off[K];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int j = q * kThreads + threadIdx.x;
    sw[slot(j)] = expf(e[q] - M);  // 0 for the padding
    sx[slot(j)] = xv[q];
    sd[slot(j)] = dv[q];
  }
  __syncthreads();

  // Each thread's kItems contiguous samples: their in-thread suffix, the
  // later threads' sums and the later tiles' offsets.
  const int first = threadIdx.x * kItems;
  float p[kItems], xs[kItems], d[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    p[q] = sw[slot(first + q)];
    xs[q] = sx[slot(first + q)];
    d[q] = sd[slot(first + q)];
  }
  float suf[K][kItems], acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r > 0) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) p[q] *= xs[q];
    }
    acc[r] = 0.f;
#pragma unroll
    for (int q = kItems - 1; q >= 0; --q) {
      acc[r] += p[q];
      suf[r][q] = acc[r];
    }
  }
  float after[K];
  repro::block_exclusive_suffix_all<kThreads>(acc, after);

  float terms[3] = {-dx, 0.f, 0.f};  // g, h, c3
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (d[q] != 0.f) {
      float S[K];
#pragma unroll
      for (int r = 0; r < K; ++r) S[r] = suf[r][q] + (after[r] + s_off[r]);
      const float s0 = fmaxf(S[0], 1e-30f);
      const float m1 = S[1] / s0;
      const float m2 = S[2] / s0;
      terms[0] += d[q] * m1;
      terms[1] += d[q] * (m2 - m1 * m1);
      if (ORDER >= 3) {
        const float m3 = S[K - 1] / s0;
        terms[2] += d[q] * (m3 + 2.f * m1 * m1 * m1 - 3.f * m2 * m1);
      }
    }
  }
  repro::block_sum_all<kThreads>(terms);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) s.partials[3 * blockIdx.x + q] = terms[q];
    __threadfence();  // the partials are visible before the ticket moves
    s_last = atomicAdd(s.ticket, 1u) == static_cast<unsigned int>(nb - 1);
  }
  __syncthreads();
  if (!s_last) return;

  // The last block: the partials of every block, summed in a fixed order
  // whichever block this is; then the ticket is reset for the next call.
  __threadfence();
  float v[3] = {0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < nb; b += kThreads) {
#pragma unroll
    for (int q = 0; q < 3; ++q) v[q] += __ldcg(&s.partials[3 * b + q]);
  }
  repro::block_sum_all<kThreads>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) out[q] = v[q];
    *s.ticket = 0u;
  }
}

template <int ORDER>
int launch(const float* eta, const float* x, const float* delta,
           const float* group_events, int n, float* scratch, float* out,
           cudaStream_t st) {
  const int nb = (n + kTile - 1) / kTile;
  coord_tile_aggregates<ORDER><<<nb, kThreads, 0, st>>>(eta, x, n, nb,
                                                        scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coord_terms<ORDER><<<nb, kThreads, 0, st>>>(eta, x, delta, group_events, n,
                                              nb, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch that repro_cox_coord needs for n samples. The first
// word is a ticket that must be zero before the first call; every call
// leaves it zero.
long long repro_cox_coord_scratch_floats(int n, int order) {
  const long long k = order + 1;
  const long long nb = (n + kTile - 1) / kTile;
  return kHeaderFloats + nb + k * nb + 3 * nb;
}

// out (3,) <- (g, h, c3); c3 is 0 for order 2. group_events[s] is the event
// count of the tie group starting at s, 0 where no group starts. Two
// launches on `stream`, no other device work.
int repro_cox_coord(const float* eta, const float* x, const float* delta,
                    const float* group_events, int n, int order,
                    float* scratch, float* out, void* stream) {
  if (n <= 0 || order < 2 || order > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (order == 2)
    return launch<2>(eta, x, delta, group_events, n, scratch, out, st);
  return launch<3>(eta, x, delta, group_events, n, scratch, out, st);
}

}  // extern "C"
