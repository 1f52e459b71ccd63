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
//
// A candidate axis. Both kernels take blockIdx.y as a candidate c with its
// own eta row (C, n), its own column (rows ld_x floats apart), its own
// scratch slice and its own ticket, tickets[c]; delta and D are shared.
// The tickets are a buffer of their own: the slices move with n, order and
// C, and a ticket among them would meet an earlier call's aggregates. A
// candidate's terms never read another's, so each of C candidates gets the
// bits that a call on its eta and column alone gives; C = 1 is the
// single-coordinate launch. Beam search finetunes all candidate supports
// of one size as one coordinate descent over this axis.
//
// The fused step (repro_cox_coord_step, order 2, the batched finetune's
// entry): each candidate's ticket holder also takes the quadratic
// surrogate step of core/surrogate.py::quad_min,
//   step = -(g + 2 lam2 beta[c, j]) / max(curv[c, j], 1e-12),
// adds it to beta[c, j] and writes step[c]. The step's eta update,
// eta[c] += x_prev[c] * step[c], is folded into the next step's
// coord_tile_aggregates, which writes eta back; so a step stays two
// launches, and a sweep needs no host read. The caller makes the last
// step's update itself.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // samples per block

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

// Floats of scratch a candidate takes.
__host__ __device__ __forceinline__ long long candidate_floats(int k,
                                                               int nb) {
  return static_cast<long long>(k + 4) * nb;
}

// Candidate blockIdx.y's ticket and slice of the scratch.
__device__ __forceinline__ Scratch carve(float* scratch,
                                         unsigned int* tickets, int k,
                                         int nb) {
  scratch += blockIdx.y * candidate_floats(k, nb);
  Scratch s;
  s.ticket = tickets + blockIdx.y;
  s.tile_max = scratch;
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

// A pending step, applied by the aggregates before they read eta:
// eta[c] += x_prev[c] * step[c] (x_prev null: none pending).
struct Pending {
  const float* x_prev;  // rows ld_x floats apart, as x
  const float* step;    // (C,)
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
coord_tile_aggregates(float* __restrict__ eta, const float* __restrict__ x,
                      long long ld_x, Pending pend, int n, int nb,
                      float* __restrict__ scratch,
                      unsigned int* __restrict__ tickets) {
  constexpr int K = ORDER + 1;
  const Scratch s = carve(scratch, tickets, K, nb);
  const int c = blockIdx.y;
  eta += static_cast<long long>(c) * n;
  x += c * ld_x;
  const float* xp = pend.x_prev ? pend.x_prev + c * ld_x : nullptr;
  const float sp = xp ? pend.step[c] : 0.f;
  const int base = blockIdx.x * kTile;
  float e[kItems], xv[kItems];
  float local = -INFINITY;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = base + q * kThreads + threadIdx.x;
    e[q] = -INFINITY;
    xv[q] = 0.f;
    if (i < n) {
      e[q] = eta[i];
      xv[q] = x[i];
      if (xp) {
        e[q] = fmaf(xp[i], sp, e[q]);
        eta[i] = e[q];
      }
    }
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

// The fused step's coefficients: beta and curv at column j of each
// candidate (rows ld floats apart); beta is null where no step is taken.
struct Step {
  float* beta;
  const float* curv;
  int ld;
  float two_lam2;  // float32(2 lam2), as torch rounds the scalar
  float* step;     // (C,)
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
coord_terms(const float* __restrict__ eta, const float* __restrict__ x,
            long long ld_x, const float* __restrict__ delta,
            const float* __restrict__ group_events, int n, int nb,
            float* __restrict__ scratch, unsigned int* __restrict__ tickets,
            float* __restrict__ out, Step step) {
  constexpr int K = ORDER + 1;
  const Scratch s = carve(scratch, tickets, K, nb);
  const int c = blockIdx.y;
  eta += static_cast<long long>(c) * n;
  x += c * ld_x;
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
    for (int q = 0; q < 3; ++q) out[3 * c + q] = v[q];
    if (step.beta) {
      // quad_min's operations in torch's order, none fused, so the step
      // is what the eager step gives from the same g
      float* b = step.beta + static_cast<long long>(c) * step.ld;
      const float a = __fadd_rn(v[0], __fmul_rn(step.two_lam2, *b));
      const float d = __fdiv_rn(-a, fmaxf(step.curv[c * step.ld], 1e-12f));
      *b = __fadd_rn(*b, d);
      step.step[c] = d;
    }
    *s.ticket = 0u;
  }
}

template <int ORDER>
int launch(float* eta, const float* x, long long ld_x, Pending pend,
           const float* delta, const float* group_events, int n, int c,
           float* scratch, unsigned int* tickets, float* out, Step step,
           cudaStream_t st) {
  const int nb = (n + kTile - 1) / kTile;
  const dim3 grid(nb, c);
  coord_tile_aggregates<ORDER><<<grid, kThreads, 0, st>>>(
      eta, x, ld_x, pend, n, nb, scratch, tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coord_terms<ORDER><<<grid, kThreads, 0, st>>>(
      eta, x, ld_x, delta, group_events, n, nb, scratch, tickets, out, step);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int n, int c) { return n <= 0 || c <= 0 || c > 65535; }

}  // namespace

extern "C" {

// Floats of scratch that repro_cox_coord and repro_cox_coord_step need for
// c candidates of n samples, beside c tickets (unsigned ints) that must be
// zero before the first call; every call leaves them zero.
long long repro_cox_coord_scratch_floats(int n, int order, int c) {
  const int nb = (n + kTile - 1) / kTile;
  return c * candidate_floats(order + 1, nb);
}

// out (c, 3) <- each candidate's (g, h, c3) from its eta row and column (c
// rows of n, contiguous); c3 is 0 for order 2. group_events[s] is the
// event count of the tie group starting at s, 0 where no group starts.
// Two launches on `stream`, no other device work.
int repro_cox_coord(const float* eta, const float* x, const float* delta,
                    const float* group_events, int n, int c, int order,
                    float* scratch, unsigned int* tickets, float* out,
                    void* stream) {
  if (bad_shape(n, c) || order < 2 || order > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // read only: no step is pending, so the aggregates write no eta
  float* e = const_cast<float*>(eta);
  const Pending none{nullptr, nullptr};
  const Step no_step{nullptr, nullptr, 0, 0.f, nullptr};
  if (order == 2)
    return launch<2>(e, x, n, none, delta, group_events, n, c, scratch,
                     tickets, out, no_step, st);
  return launch<3>(e, x, n, none, delta, group_events, n, c, scratch, tickets,
                   out, no_step, st);
}

// One quadratic-surrogate coordinate step of c candidates: first the
// pending step's update eta[c] += x_prev[c] * step[c] (none when x_prev is
// null), then (g, h) of column x into out (c, 3) as repro_cox_coord gives
// them, then step[c] and beta[c] += step[c] (see the header). x and x_prev
// are rows ld_x floats apart, beta and curv rows ld_coef floats apart (each
// pointing at column j). Two launches on `stream`, no other device work.
int repro_cox_coord_step(float* eta, const float* x, const float* x_prev,
                         long long ld_x, const float* delta,
                         const float* group_events, int n, int c,
                         float* beta, const float* curv, int ld_coef,
                         float two_lam2, float* step, float* scratch,
                         unsigned int* tickets, float* out, void* stream) {
  if (bad_shape(n, c) || ld_x < n || ld_coef < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<2>(eta, x, ld_x, Pending{x_prev, step}, delta, group_events,
                   n, c, scratch, tickets, out,
                   Step{beta, curv, ld_coef, two_lam2, step},
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
