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
// The kernel takes D (n,), D[a] = the sum of delta over the tie group that
// starts at a (0 off group starts; kernels/ref.py::group_events, made once
// per fit and shared with cox_coord), so the sum over i becomes a sum over
// group starts, each term local to its row: a tie group that straddles
// segments, or holds every row, costs no walk and needs no gather.
//
// Design: one launch that reads X once, on revcumsum.cu's strip tiles
// (strip.cuh; 256-row segments, 32-column strips). For each tile:
//   1. each thread loads its run of 32 rows raw into registers and forms
//      the run's max and min; the block stages the segment's D in shared
//      memory and forms, per column, the extrema of its later runs;
//   2. the tile publishes its extrema and gathers those of every later
//      segment of the strip by strip.cuh's ticket, epoch-tagged words
//      (a max word and a min word a column) and fixed 8-segment formula;
//      max and min are exact in any order, the tickets and epochs keep the
//      values valid and the waits free of deadlock;
//   3. each thread walks its run from the last row, extending the extrema,
//      and adds D range^2 and D range^3 in float64 at each row with D != 0;
//   4. the (segment, column) partials are summed in a fixed order
//      (strip.cuh::sum_partials), and the strip's last block writes L2, L3.
//
// What bounds it on an H100: bytes. The function must read X once (4 n p
// bytes; 1.05 GB at n = 262,144, p = 1,000, 313 us at 3.35 TB/s) for ~8
// flops an element. This design reads X once; the carry words and the
// partials add ~5 % to the bytes at that shape. It runs once per fit.
//
// No float atomics: every sum has a fixed order, so a fit repeats its bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "strip.cuh"

namespace {

namespace strip = repro::strip;

constexpr int kParts = 2;  // the sums of D range^2 and D range^3
constexpr int kCols = strip::kCols;
constexpr double kInv6Sqrt3 = 0.09622504486493763;  // 1 / (6 sqrt(3))
using L = strip::Layout<float>;

__global__ void __launch_bounds__(strip::kThreads, 4)
lip_panel(const float* __restrict__ x, const float* __restrict__ dsum, int n,
          int p, int strips, int nseg, unsigned epoch,
          unsigned* __restrict__ ticket, strip::Words words_max,
          strip::Words words_min, strip::Partials<kParts> parts,
          float* __restrict__ l2, float* __restrict__ l3) {
  constexpr int SLOTS = L::SLOTS;
  constexpr int kRun = strip::kRun;
  constexpr int kGroups = L::kGroups;
  constexpr int kSegRows = L::kSegRows;
  __shared__ float s_d[kSegRows];
  __shared__ float s_mx[kGroups][kCols];
  __shared__ float s_mn[kGroups][kCols];
  __shared__ double s_a2[kGroups][kCols];
  __shared__ double s_a3[kGroups][kCols];
  const strip::Tile tile = strip::take_tile(ticket, strips, nseg);
  const int c = threadIdx.x % SLOTS;
  const int grp = threadIdx.x / SLOTS;
  const int j = tile.strip * kCols + c;
  const int base = tile.seg * kSegRows;
  const int lo = base + grp * kRun;
  const int rows = min(kRun, n - lo);  // rows of the run that exist

  // 1. The run, raw, all its loads in flight; its extrema; the segment's D.
  float v[kRun];
  strip::load_run<float, true>(x, n, p, lo, j, v);
  for (int q = threadIdx.x; q < kSegRows; q += strip::kThreads) {
    const int i = base + q;
    s_d[q] = i < n ? dsum[i] : 0.f;
  }
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int k = kRun - 1; k >= 0; --k) {
    if (k < rows) {
      mx = fmaxf(mx, v[k]);
      mn = fminf(mn, v[k]);
    }
  }
  s_mx[grp][c] = mx;
  s_mn[grp][c] = mn;
  __syncthreads();
  float later_mx = -INFINITY, later_mn = INFINITY;  // the tile's later runs
  for (int q = kGroups - 1; q > grp; --q) {
    later_mx = fmaxf(later_mx, s_mx[q][c]);
    later_mn = fminf(later_mn, s_mn[q][c]);
  }

  // 2. The extrema of every later segment of the strip.
  const strip::Words words[2] = {words_max, words_min};
  const int col[2] = {c, c};
  const float total[2] = {fmaxf(later_mx, mx), fminf(later_mn, mn)};
  float carry[2];
  strip::carry_from_below<strip::MaxMin, L::kWindow, SLOTS>(
      words, col, total, strips, tile, nseg, grp, c, epoch, carry);

  // 3. The walk, last row first, from everything below the run.
  float hi = fmaxf(carry[0], later_mx), low = fminf(carry[1], later_mn);
  const float* d = s_d + grp * kRun;
  double a2 = 0.0, a3 = 0.0;
#pragma unroll
  for (int k = kRun - 1; k >= 0; --k) {
    if (k < rows) {
      hi = fmaxf(hi, v[k]);
      low = fminf(low, v[k]);
      const float dk = d[k];
      if (dk != 0.f) {
        const double range = static_cast<double>(hi - low);
        a2 += dk * range * range;
        a3 += dk * range * range * range;
      }
    }
  }
  s_a2[grp][c] = a2;
  s_a3[grp][c] = a3;
  __syncthreads();

  // 4. The tile's partials over its runs: thread t < kCols the sum of
  // D range^2 of column t, thread kCols + t that of D range^3.
  const int t = threadIdx.x;
  double mine = 0.0;
  if (t < kParts * kCols) {
    const double(*src)[kCols] = t < kCols ? s_a2 : s_a3;
    for (int q = 0; q < kGroups; ++q) mine += src[q][t % kCols];
  }
  double sum = 0.0;
  if (!strip::sum_partials<kParts>(parts, mine, strips, tile, nseg, epoch,
                                   &sum))
    return;
  if (t < kParts * kCols) {
    const int jj = tile.strip * kCols + t % kCols;
    if (jj < p) {
      if (t < kCols) {
        l2[jj] = static_cast<float>(0.25 * sum);
      } else {
        l3[jj] = static_cast<float>(kInv6Sqrt3 * sum);
      }
    }
  }
}

struct Dims {
  int strips;
  int nseg;
  size_t words;  // words of one carried value: (nseg, strips, kCols)
};

Dims dims(int n, int p) {
  Dims d;
  d.strips = (p + kCols - 1) / kCols;
  d.nseg = (n + L::kSegRows - 1) / L::kSegRows;
  d.words = static_cast<size_t>(d.nseg) * d.strips * kCols;
  return d;
}

}  // namespace

extern "C" {

// Bytes of scratch that repro_lipschitz needs for an (n, p) panel: the
// tagged scratch (ticket, words A and P of the max and the min, counters),
// or with `partials` != 0 the partials' scratch. The tagged scratch's first
// word is a ticket that must be zero before the first call (every call
// leaves it zero), and its other words must never hold a later epoch than
// the call's: a zeroed buffer and epochs counting up from 1 do. It must not
// be shared with another kernel's scratch. The partials' scratch may hold
// anything.
long long repro_lipschitz_scratch_bytes(int n, int p, int partials) {
  const Dims d = dims(n, p);
  if (partials) return strip::partials_bytes<kParts>(d.nseg, d.strips);
  return strip::kTicketBytes + 4 * static_cast<long long>(d.words) * 8 +
         strip::counters_bytes(d.nseg, d.strips);
}

// l2, l3 (p,) from a time-sorted row-major x (n, p) and the tie groups'
// event counts dsum (n,) at their starts. `epoch` is nonzero and differs
// from the previous call's on the same scratch. One launch on `stream`, no
// other device work.
int repro_lipschitz(const float* x, const float* dsum, int n, int p,
                    void* tagged, void* partials, unsigned epoch, float* l2,
                    float* l3, void* stream) {
  if (n <= 0 || p <= 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = dims(n, p);
  if (static_cast<long long>(d.strips) * d.nseg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(tagged);
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(s + strip::kTicketBytes);
  const strip::Words wmax{words, words + d.words};
  const strip::Words wmin{words + 2 * d.words, words + 3 * d.words};
  const strip::Partials<kParts> parts = strip::carve_partials<kParts>(
      partials, words + 4 * d.words, d.nseg, d.strips);
  lip_panel<<<d.strips * d.nseg, strip::kThreads, 0, st>>>(
      x, dsum, n, p, d.strips, d.nseg, epoch, reinterpret_cast<unsigned*>(s),
      wmax, wmin, parts, l2, l3);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
