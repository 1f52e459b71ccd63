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
// run on the MXU. Hopper blocks run in no fixed order, so the carry goes
// through revcumsum.cu's strip tiles (strip.cuh): one launch that reads x
// once. For each (segment, strip) tile:
//   1. load: each thread loads its run of 32 rows raw into registers, all
//      loads in flight at once; the block stages the segment's five vectors
//      in shared memory, float4 (w, r, wa, delta) and inv_s0 a row (5 KB for
//      256 float32 rows, 10 KB for 512 bfloat16 rows);
//   2. from its registers, before any carry: g += r x, h1 += wa x^2 and the
//      run's sum of w x; the block forms the tile's column totals of w x;
//   3. carry: the tile publishes those totals and gathers the suffix of w x
//      below it by strip.cuh's ticket, epoch-tagged words and fixed
//      8-segment formula;
//   4. walk: from the last row, s1 += w x, h2 += delta (s1 inv_s0)^2.
// A thread sums its 32 rows in float32; the block sums its runs' g and
// h1 - h2 per column in float64, and strip.cuh::sum_partials sums those
// (segment, column) partials in a fixed order and the strip's last block
// writes grad and hess. Rows past n are never read: the run holds zeros
// there and the staged vectors are zero.
//
// What bounds it on an H100: bytes. The function must read x once plus the
// five vectors (4 n p + 20 n bytes in float32; 263 MB at (65,536, 1,000),
// 78.6 us at 3.35 TB/s) for ~11 flops an element (~0.7 GFLOP there,
// 10.7 us at 67 TFLOP/s). This design reads x once; the carry words and the
// partials add ~3 % to the bytes at that shape.
//
// No float atomics: every sum has a fixed order, so a fit repeats its bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "strip.cuh"

namespace {

namespace strip = repro::strip;

constexpr int kParts = 2;  // g and h of a column
constexpr int kCols = strip::kCols;

template <typename T, bool PAIRED>
__global__ void __launch_bounds__(strip::kThreads, 4)
cb_panel(const T* __restrict__ x, const float* __restrict__ w,
         const float* __restrict__ r, const float* __restrict__ wa,
         const float* __restrict__ delta, const float* __restrict__ inv_s0,
         int n, int p, int strips, int nseg, unsigned epoch,
         unsigned* __restrict__ ticket, strip::Words words_wx,
         strip::Partials<kParts> parts, float* __restrict__ grad,
         float* __restrict__ hess) {
  using L = strip::Layout<T>;
  constexpr int SLOTS = L::SLOTS;
  constexpr int W = strip::Slot<T>::kW;
  constexpr int kRun = strip::kRun;
  constexpr int kGroups = L::kGroups;
  constexpr int kSegRows = L::kSegRows;
  __shared__ float4 s_vec[kSegRows];  // (w, r, wa, delta) of a row
  // inv_s0 of a row; one pad word every 32 rows keeps the two runs a
  // bfloat16 warp reads off a common bank
  __shared__ float s_inv[kSegRows + kSegRows / kRun];
  __shared__ float s_tot[kGroups][kCols];
  __shared__ float s_g[kGroups][kCols];
  __shared__ float s_h[kGroups][kCols];
  const strip::Tile tile = strip::take_tile(ticket, strips, nseg);
  const int c = threadIdx.x % SLOTS;
  const int grp = threadIdx.x / SLOTS;
  const int j = tile.strip * kCols + c * W;  // the thread's first column
  const int base = tile.seg * kSegRows;
  const int lo = base + grp * kRun;

  // 1. The run, raw, all its loads in flight; the segment's vectors.
  typename strip::Slot<T>::V v[kRun];
  strip::load_run<T, PAIRED>(x, n, p, lo, j, v);
  for (int q = threadIdx.x; q < kSegRows; q += strip::kThreads) {
    const int i = base + q;
    const bool in = i < n;
    s_vec[q] = in ? make_float4(w[i], r[i], wa[i], delta[i])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    s_inv[q + q / kRun] = in ? inv_s0[i] : 0.f;
  }
  __syncthreads();
  const float4* rows = s_vec + grp * kRun;
  const float* invs = s_inv + grp * (kRun + 1);

  // 2. What needs no carry: g, h1 and the run's sum of w x.
  float acc[W] = {}, g[W] = {}, h1[W] = {};
#pragma unroll
  for (int k = kRun - 1; k >= 0; --k) {
    const float4 a = rows[k];
    float xv[W];
    strip::unpack(v[k], xv);
#pragma unroll
    for (int u = 0; u < W; ++u) {
      acc[u] += a.x * xv[u];
      g[u] += a.y * xv[u];
      h1[u] += a.z * xv[u] * xv[u];
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) s_tot[grp][c * W + u] = acc[u];
  __syncthreads();
  float later[W] = {};  // the later runs of this tile, these columns
  for (int q = kGroups - 1; q > grp; --q) {
#pragma unroll
    for (int u = 0; u < W; ++u) later[u] += s_tot[q][c * W + u];
  }

  // 3. The suffix of w x below this tile.
  strip::Words words[W];
  int col[W];
  float total[W], carry[W];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    words[u] = words_wx;
    col[u] = c * W + u;
    total[u] = later[u] + acc[u];  // the tile's, in thread group 0
  }
  strip::carry_from_below<strip::Sum, L::kWindow, SLOTS>(
      words, col, total, strips, tile, nseg, grp, c, epoch, carry);

  // 4. The walk, last row first, s1 from everything below the row.
  float s1[W], h2[W] = {};
#pragma unroll
  for (int u = 0; u < W; ++u) s1[u] = carry[u] + later[u];
#pragma unroll
  for (int k = kRun - 1; k >= 0; --k) {
    const float4 a = rows[k];
    const float is0 = invs[k];
    float xv[W];
    strip::unpack(v[k], xv);
#pragma unroll
    for (int u = 0; u < W; ++u) {
      s1[u] += a.x * xv[u];
      const float mean = s1[u] * is0;
      h2[u] += a.w * mean * mean;
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) {
    s_g[grp][c * W + u] = g[u];
    s_h[grp][c * W + u] = h1[u] - h2[u];
  }
  __syncthreads();

  // The tile's partials, over its runs in float64: thread t < kCols the g
  // of column t, thread kCols + t its h.
  const int t = threadIdx.x;
  double mine = 0.0;
  if (t < kParts * kCols) {
    const float(*src)[kCols] = t < kCols ? s_g : s_h;
    for (int q = 0; q < kGroups; ++q)
      mine += static_cast<double>(src[q][t % kCols]);
  }
  double sum = 0.0;
  if (!strip::sum_partials<kParts>(parts, mine, strips, tile, nseg, epoch,
                                   &sum))
    return;
  if (t < kParts * kCols) {
    const int jj = tile.strip * kCols + t % kCols;
    if (jj < p) (t < kCols ? grad : hess)[jj] = static_cast<float>(sum);
  }
}

struct Dims {
  int strips;
  int nseg;
};

template <typename T>
Dims dims(int n, int p) {
  return Dims{(p + kCols - 1) / kCols,
              (n + strip::Layout<T>::kSegRows - 1) /
                  strip::Layout<T>::kSegRows};
}

// Bytes of the tagged scratch (ticket, words A and P, counters) or, with
// `partials`, of the partials' scratch.
template <typename T>
long long scratch_bytes(int n, int p, bool partials) {
  const Dims d = dims<T>(n, p);
  if (partials) return strip::partials_bytes<kParts>(d.nseg, d.strips);
  const long long nw = static_cast<long long>(d.nseg) * d.strips * kCols;
  return strip::kTicketBytes + 2 * nw * 8 +
         strip::counters_bytes(d.nseg, d.strips);
}

template <typename T, bool PAIRED>
int launch_panel(const T* x, const float* w, const float* r, const float* wa,
                 const float* delta, const float* inv_s0, int n, int p,
                 unsigned epoch, char* tagged, void* partials, float* grad,
                 float* hess, cudaStream_t st) {
  const Dims d = dims<T>(n, p);
  if (static_cast<long long>(d.strips) * d.nseg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t nw = static_cast<size_t>(d.nseg) * d.strips * kCols;
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(tagged + strip::kTicketBytes);
  const strip::Words wx{words, words + nw};
  const strip::Partials<kParts> parts = strip::carve_partials<kParts>(
      partials, words + 2 * nw, d.nseg, d.strips);
  cb_panel<T, PAIRED><<<d.strips * d.nseg, strip::kThreads, 0, st>>>(
      x, w, r, wa, delta, inv_s0, n, p, d.strips, d.nseg, epoch,
      reinterpret_cast<unsigned*>(tagged), wx, parts, grad, hess);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* w, const float* r, const float* wa,
           const float* delta, const float* inv_s0, int n, int p,
           unsigned epoch, char* tagged, void* partials, float* grad,
           float* hess, cudaStream_t st) {
  // bfloat16 pairs load whole when no pair straddles a row or a 4-byte
  // boundary
  const bool paired = strip::Slot<T>::kW == 2 && p % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 4 == 0;
  return paired ? launch_panel<T, true>(x, w, r, wa, delta, inv_s0, n, p,
                                        epoch, tagged, partials, grad, hess,
                                        st)
                : launch_panel<T, false>(x, w, r, wa, delta, inv_s0, n, p,
                                         epoch, tagged, partials, grad, hess,
                                         st);
}

}  // namespace

extern "C" {

// Bytes of scratch that repro_cox_batch needs for an (n, p) panel: the
// tagged scratch, or with `partials` != 0 the partials' scratch. The
// tagged scratch's first word is a ticket that must be zero before the
// first call (every call leaves it zero), and its other words must never
// hold a later epoch than the call's: a zeroed buffer and epochs counting
// up from 1 do. It must not be shared with another kernel's scratch. The
// partials' scratch may hold anything.
long long repro_cox_batch_scratch_bytes(int n, int p, int bf16,
                                        int partials) {
  return bf16 ? scratch_bytes<__nv_bfloat16>(n, p, partials != 0)
              : scratch_bytes<float>(n, p, partials != 0);
}

// grad, hess (p,) from a time-sorted, tie-free row-major x (n, p) and the
// (n,) vectors; bf16 != 0 means x is bfloat16, else float32. `epoch` is
// nonzero and differs from the previous call's on the same scratch. One
// launch on `stream`, no other device work.
int repro_cox_batch(const void* x, const float* w, const float* r,
                    const float* wa, const float* delta, const float* inv_s0,
                    int n, int p, int bf16, void* tagged, void* partials,
                    unsigned epoch, float* grad, float* hess, void* stream) {
  if (n <= 0 || p <= 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(tagged);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(x), w, r, wa, delta,
                  inv_s0, n, p, epoch, s, partials, grad, hess, st);
  }
  return launch(static_cast<const float*>(x), w, r, wa, delta, inv_s0, n, p,
                epoch, s, partials, grad, hess, st);
}

}  // extern "C"
