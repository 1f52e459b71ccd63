// Theorem 3.4 Lipschitz constants of FastSurvival, with Breslow ties:
//
//   L2_l = 1/4      sum_i delta_i range_l(risk_start[i])^2
//   L3_l = 1/(6√3)  sum_i delta_i range_l(risk_start[i])^3
//   range_l(a) = max_{k >= a} X_kl - min_{k >= a} X_kl    (rows time-sorted)
//
// Replaces the Pallas TPU kernel src/repro/kernels/lipschitz.py::_kernel
// (pallas_call in _lipschitz_jit). That kernel walks n-blocks in order with
// the running extrema in VMEM, and is tie-free: it reads the range at i,
// not at the start of i's tie group.
//
// Design. X is row-major (n, p), so neighbouring threads take neighbouring
// columns and every warp load is one 128-byte line. One thread walking a
// whole column would leave p threads on the card (1,000 at the main path's
// width, 32 warps for 132 SMs) with little memory traffic in flight; the
// rows are cut into chunks of 256 instead, one thread per (chunk, column).
// The kernel takes D (n,), D[a] = the sum of delta over the tie group that
// starts at a (0 off group starts; kernels/ref.py::group_events, made once
// per fit and shared with cox_coord), so the sum over i becomes a sum over
// group starts and chunks need not know each other's groups: a group that
// holds a large share of n (administrative censoring at one date) costs no
// walk.
//   1. lip_chunk_extrema: max/min of each (chunk, column);
//   2. lip_chunk_carry: per column, the exclusive suffix of those extrema
//      over chunks (what lies to the right of each chunk), in place;
//   3. lip_walk: each (chunk, column) walks its rows from last to first,
//      extending the carried extrema, and adds D[a] range^2 and D[a] range^3
//      at each group start a, accumulating in double;
//   4. lip_finish: per column, the chunk partials in a fixed order.
//
// What bounds it on an H100: bytes. The function must read X once (4 n p
// bytes; 1.05 GB at n = 262,144, p = 1,000) for ~8 flops an element. This
// design reads X twice (steps 1 and 3), so it can reach half the bound at
// best. It runs once per fit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;   // rows per chunk
constexpr int kColThreads = 32;
constexpr int kChunkThreads = 8;
constexpr double kInv6Sqrt3 = 0.09622504486493763;  // 1 / (6 sqrt(3))

__global__ void lip_chunk_extrema(const float* __restrict__ x, int n, int p,
                                  int nc, float* __restrict__ cmax,
                                  float* __restrict__ cmin) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= p || c >= nc) return;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float mx = -INFINITY, mn = INFINITY;
  for (int i = lo; i < hi; ++i) {
    const float v = x[static_cast<size_t>(i) * p + j];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
  }
  cmax[static_cast<size_t>(c) * p + j] = mx;
  cmin[static_cast<size_t>(c) * p + j] = mn;
}

__global__ void lip_chunk_carry(float* __restrict__ cmax,
                                float* __restrict__ cmin, int p, int nc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  float mx = -INFINITY, mn = INFINITY;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t o = static_cast<size_t>(c) * p + j;
    const float a = cmax[o], b = cmin[o];
    cmax[o] = mx;
    cmin[o] = mn;
    mx = fmaxf(mx, a);
    mn = fminf(mn, b);
  }
}

__global__ void lip_walk(const float* __restrict__ x,
                         const float* __restrict__ dsum, int n, int p, int nc,
                         const float* __restrict__ cmax,
                         const float* __restrict__ cmin,
                         double* __restrict__ part2,
                         double* __restrict__ part3) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kChunkThreads + threadIdx.y;
  if (j >= p || c >= nc) return;
  const size_t o = static_cast<size_t>(c) * p + j;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, n);
  float mx = cmax[o], mn = cmin[o];
  double a2 = 0.0, a3 = 0.0;
  for (int i = hi - 1; i >= lo; --i) {
    const float v = x[static_cast<size_t>(i) * p + j];
    mx = fmaxf(mx, v);
    mn = fminf(mn, v);
    const float d = dsum[i];
    if (d != 0.f) {
      const double r = static_cast<double>(mx - mn);
      a2 += d * r * r;
      a3 += d * r * r * r;
    }
  }
  part2[o] = a2;
  part3[o] = a3;
}

__global__ void lip_finish(const double* __restrict__ part2,
                           const double* __restrict__ part3, int p, int nc,
                           float* __restrict__ l2, float* __restrict__ l3) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  double a2 = 0.0, a3 = 0.0;
  for (int c = 0; c < nc; ++c) {
    a2 += part2[static_cast<size_t>(c) * p + j];
    a3 += part3[static_cast<size_t>(c) * p + j];
  }
  l2[j] = static_cast<float>(0.25 * a2);
  l3[j] = static_cast<float>(kInv6Sqrt3 * a3);
}

struct Layout {
  double* part2;
  double* part3;
  float* cmax;
  float* cmin;
};

Layout layout(void* scratch, int n, int p) {
  const size_t nc = (n + kChunk - 1) / kChunk;
  Layout l;
  l.part2 = static_cast<double*>(scratch);
  l.part3 = l.part2 + nc * p;
  l.cmax = reinterpret_cast<float*>(l.part3 + nc * p);
  l.cmin = l.cmax + nc * p;
  return l;
}

}  // namespace

extern "C" {

// Bytes of scratch that repro_lipschitz needs for an (n, p) panel.
long long repro_lipschitz_scratch_bytes(int n, int p) {
  const long long nc = (n + kChunk - 1) / kChunk;
  return nc * p * (2 * sizeof(double) + 2 * sizeof(float));
}

// l2, l3 (p,) from a time-sorted row-major x (n, p) and the tie groups'
// event counts dsum (n,) at their starts.
int repro_lipschitz(const float* x, const float* dsum, int n, int p,
                    void* scratch, float* l2, float* l3, void* stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (n + kChunk - 1) / kChunk;
  const Layout s = layout(scratch, n, p);
  const dim3 block(kColThreads, kChunkThreads);
  const dim3 grid((p + kColThreads - 1) / kColThreads,
                  (nc + kChunkThreads - 1) / kChunkThreads);
  cudaError_t err;
  lip_chunk_extrema<<<grid, block, 0, st>>>(x, n, p, nc, s.cmax, s.cmin);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lip_chunk_carry<<<(p + 255) / 256, 256, 0, st>>>(s.cmax, s.cmin, p, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lip_walk<<<grid, block, 0, st>>>(x, dsum, n, p, nc, s.cmax, s.cmin,
                                   s.part2, s.part3);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  lip_finish<<<(p + 255) / 256, 256, 0, st>>>(s.part2, s.part3, p, nc, l2, l3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
