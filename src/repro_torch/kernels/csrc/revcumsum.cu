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
//
// What bounds it on an H100: bytes. The function must read x once and
// write out once (8 n m bytes in float32; 524 MB at (65,536, 1,000), 156 us
// at 3.35 TB/s) for one add an element. A plain device copy of the same
// panel, which moves the same bytes, takes 173 us on an H100 at 700 W
// (scripts/time_scan_kernels.py): that is the mark to measure against.
//
// m >= 32 (the streaming fit's (chunk_rows, p) panel of w x): one launch
// that reads x once and writes out once, 8 n m bytes in float32. Columns are
// cut into strips of 32 (a 128-byte line of float32, 64 bytes of bfloat16;
// 32 strips at m = 1,000) and rows into segments of 256 (float32) or 512
// (bfloat16); a block takes one (segment, strip) tile of 32 KB. Each thread
// loads a run of 32 rows of its column (a bfloat16 thread a pair of
// columns) into registers, raw, all loads in flight at once; the block
// forms the tile's column totals, publishes them, gathers the carry from
// below, publishes its inclusive sum and walks its runs from the last row,
// writing each row once. Registers hold only the raw run, so four blocks
// fit an SM. Tiles are dealt through a ticket, later segments first, so a
// block only ever waits on blocks that already hold a ticket and run: no
// deadlock whatever the scheduler does. The carry of segment s is always
// the same sum, in the same order, of the aggregates of the next 7
// segments and the inclusive sum of the 8th, so bits repeat, and the
// serial chain steps 8 segments at a time. Each value is packed with the
// call's epoch in one 64-bit word: no memset or fence per call. The tiles,
// the ticket, the epoch-tagged words and the carry formula live in
// strip.cuh, shared with cox_batch.cu and lipschitz.cu.
//
// m < 32 (the (chunk_rows,) hazard vector w, and narrow panels): one block
// per (tile of 1024 rows, column), in two launches, as cox_coord.cu:
//   1. rcs_vec_totals: each tile's column total;
//   2. rcs_vec_finish: the sum of the later tiles' totals in a fixed order,
//      plus the in-tile suffix, written once. It re-reads x, from L2 at the
//      sizes the fit uses (256 KB at 65,536 rows).
//
// No float atomics: every sum has a fixed order, so a fit repeats its bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "strip.cuh"

namespace {

namespace strip = repro::strip;

constexpr int kThreads = 256;       // m < 32 layout
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // rows per block

__device__ __forceinline__ void add_slot(float (&a)[1], float v) { a[0] += v; }
__device__ __forceinline__ void add_slot(float (&a)[2], __nv_bfloat162 v) {
  a[0] += __low2float(v);
  a[1] += __high2float(v);
}

template <typename T, bool PAIRED>
__device__ __forceinline__ void store_slot(T* out, size_t o, int j, int m,
                                           const float (&a)[strip::Slot<T>::kW]) {
  if constexpr (strip::Slot<T>::kW == 1) {
    out[o] = a[0];
  } else if constexpr (PAIRED) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) =
        __floats2bfloat162_rn(a[0], a[1]);
  } else {
    out[o] = __float2bfloat16(a[0]);
    if (j + 1 < m) out[o + 1] = __float2bfloat16(a[1]);
  }
}

template <typename T, bool PAIRED>
__global__ void __launch_bounds__(strip::kThreads, 4)
rcs_panel(const T* __restrict__ x, int n, int m, int strips, int nseg,
          unsigned epoch, unsigned* __restrict__ ticket,
          unsigned long long* __restrict__ aggregates,
          unsigned long long* __restrict__ inclusive, T* __restrict__ out) {
  using L = strip::Layout<T>;
  constexpr int SLOTS = L::SLOTS;
  constexpr int W = strip::Slot<T>::kW;
  constexpr int kRun = strip::kRun;
  constexpr int kGroups = L::kGroups;
  constexpr int kSegRows = L::kSegRows;
  __shared__ float s_tot[kGroups][strip::kCols];
  const strip::Tile tile = strip::take_tile(ticket, strips, nseg);
  const int c = threadIdx.x % SLOTS;
  const int grp = threadIdx.x / SLOTS;
  const int j = tile.strip * strip::kCols + c * W;  // the thread's first column
  const int lo = tile.seg * kSegRows + grp * kRun;

  // The run, raw, all its loads in flight at once; its sum.
  typename strip::Slot<T>::V v[kRun];
  strip::load_run<T, PAIRED>(x, n, m, lo, j, v);
  float acc[W] = {};
#pragma unroll
  for (int r = kRun - 1; r >= 0; --r) add_slot(acc, v[r]);
#pragma unroll
  for (int w = 0; w < W; ++w) s_tot[grp][c * W + w] = acc[w];
  __syncthreads();
  float later[W] = {};  // the later runs of this tile, these columns
  for (int q = kGroups - 1; q > grp; --q) {
#pragma unroll
    for (int w = 0; w < W; ++w) later[w] += s_tot[q][c * W + w];
  }

  // The carry from the later segments of the strip (strip.cuh).
  strip::Words words[W];
  int col[W];
  float total[W], carry[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    words[w] = strip::Words{aggregates, inclusive};
    col[w] = c * W + w;
    total[w] = later[w] + acc[w];  // the tile's, in thread group 0
  }
  strip::carry_from_below<strip::Sum, L::kWindow, SLOTS>(
      words, col, total, strips, tile, nseg, grp, c, epoch, carry);
  if (j >= m) return;
  float run[W];
#pragma unroll
  for (int w = 0; w < W; ++w) run[w] = carry[w] + later[w];
  // The walk, last row first, from everything below the run.
#pragma unroll
  for (int r = kRun - 1; r >= 0; --r) {
    const int i = lo + r;
    if (i < n) {
      add_slot(run, v[r]);
      store_slot<T, PAIRED>(out, static_cast<size_t>(i) * m + j, j, m, run);
    }
  }
}

// totals[j * nb + b] <- the sum of column j over row tile b. Grid (nb, m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcs_vec_totals(const T* __restrict__ x, int n, int m, int nb,
               float* __restrict__ totals) {
  const int j = blockIdx.y;
  const int base = blockIdx.x * kTile;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = base + q * kThreads + threadIdx.x;
    if (i < n) s += repro::to_f32(x[static_cast<size_t>(i) * m + j]);
  }
  s = repro::block_sum<kThreads>(s);
  if (threadIdx.x == 0) totals[static_cast<size_t>(j) * nb + blockIdx.x] = s;
}

// out rows of tile b, column j <- the in-tile suffix plus the later tiles'
// totals, summed in a fixed order. Grid (nb, m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rcs_vec_finish(const T* __restrict__ x, int n, int m, int nb,
               const float* __restrict__ totals, T* __restrict__ out) {
  __shared__ float sv[kTile + kTile / 32];
  __shared__ float s_off;
  const int j = blockIdx.y;
  const int base = blockIdx.x * kTile;
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const int i = base + q;
    sv[q + (q >> 5)] = i < n ? repro::to_f32(x[static_cast<size_t>(i) * m + j]) : 0.f;
  }
  const float* tj = totals + static_cast<size_t>(j) * nb;
  float o = 0.f;
  for (int b = blockIdx.x + 1 + threadIdx.x; b < nb; b += kThreads) o += tj[b];
  o = repro::block_sum<kThreads>(o);
  if (threadIdx.x == 0) s_off = o;
  __syncthreads();
  const int first = threadIdx.x * kItems;
  float suf[kItems];
  float acc = 0.f;
#pragma unroll
  for (int q = kItems - 1; q >= 0; --q) {
    const int e = first + q;
    acc += sv[e + (e >> 5)];
    suf[q] = acc;
  }
  float total;
  const float after = repro::block_exclusive_suffix<kThreads>(acc, &total);
  const float off = after + s_off;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int e = first + q;
    sv[e + (e >> 5)] = suf[q] + off;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const int i = base + q;
    if (i < n)
      out[static_cast<size_t>(i) * m + j] = repro::from_f32<T>(sv[q + (q >> 5)]);
  }
}

template <typename T>
long long panel_scratch_bytes(int n, int m) {
  using L = strip::Layout<T>;
  const long long strips = (m + strip::kCols - 1) / strip::kCols;
  const long long nseg = (n + L::kSegRows - 1) / L::kSegRows;
  return strip::kTicketBytes + 2 * nseg * strips * strip::kCols * 8;  // A, P
}

template <typename T, bool PAIRED>
int launch_panel(const T* x, int n, int m, unsigned epoch, char* scratch,
                 T* out, cudaStream_t st) {
  using L = strip::Layout<T>;
  const int strips = (m + strip::kCols - 1) / strip::kCols;
  const int nseg = (n + L::kSegRows - 1) / L::kSegRows;
  if (static_cast<long long>(strips) * nseg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(scratch + strip::kTicketBytes);
  rcs_panel<T, PAIRED><<<strips * nseg, strip::kThreads, 0, st>>>(
      x, n, m, strips, nseg, epoch, reinterpret_cast<unsigned*>(scratch),
      words, words + static_cast<size_t>(nseg) * strips * strip::kCols, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, int n, int m, unsigned epoch, char* scratch, T* out,
           cudaStream_t st) {
  if (m >= 32) {
    // bfloat16 pairs load whole when no pair straddles a row or a 4-byte
    // boundary
    const bool paired = strip::Slot<T>::kW == 2 && m % 2 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 4 == 0;
    return paired
               ? launch_panel<T, true>(x, n, m, epoch, scratch, out, st)
               : launch_panel<T, false>(x, n, m, epoch, scratch, out, st);
  }
  const int nb = (n + kTile - 1) / kTile;
  float* totals = reinterpret_cast<float*>(scratch + strip::kTicketBytes);
  rcs_vec_totals<T><<<dim3(nb, m), kThreads, 0, st>>>(x, n, m, nb, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rcs_vec_finish<T><<<dim3(nb, m), kThreads, 0, st>>>(x, n, m, nb, totals,
                                                       out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch that repro_revcumsum needs for an (n, m) panel. Its
// first word is a ticket that must be zero before the first call (every
// call leaves it zero), and the carry words must never hold a later epoch
// than the call's: a zeroed buffer and epochs counting up from 1 do.
long long repro_revcumsum_scratch_bytes(int n, int m, int bf16) {
  if (m >= 32) {
    return bf16 ? panel_scratch_bytes<__nv_bfloat16>(n, m)
                : panel_scratch_bytes<float>(n, m);
  }
  const long long nb = (n + kTile - 1) / kTile;
  return strip::kTicketBytes + nb * m * 4;
}

// out (n, m) <- suffix sum of x (n, m) along rows; bf16 != 0 means both are
// bfloat16, else float32. `epoch` is nonzero and differs from the previous
// call's on the same scratch. One launch for m >= 32, two below.
int repro_revcumsum(const void* x, int n, int m, int bf16, void* scratch,
                    unsigned epoch, void* out, void* stream) {
  if (n <= 0 || m <= 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(scratch);
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(x), n, m, epoch, s,
                  static_cast<__nv_bfloat16*>(out), st);
  }
  return launch(static_cast<const float*>(x), n, m, epoch, s,
                static_cast<float*>(out), st);
}

}  // extern "C"
