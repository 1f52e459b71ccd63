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
// call's epoch in one 64-bit word: no memset or fence per call.
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

namespace {

constexpr int kPanelThreads = 256;
constexpr int kHeaderBytes = 16;    // the panel ticket, padded
constexpr int kThreads = 256;       // m < 32 layout
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // rows per block

// What a panel thread holds of one row: one float32 column, or a pair of
// neighbouring bfloat16 columns in one 32-bit register.
template <typename T>
struct Slot;
template <>
struct Slot<float> {
  using V = float;
  static constexpr int kW = 1;
  static __device__ __forceinline__ V zero() { return 0.f; }
};
template <>
struct Slot<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static constexpr int kW = 2;
  static __device__ __forceinline__ V zero() {
    return __float2bfloat162_rn(0.f);
  }
};

constexpr int kRun = 32;        // rows a panel thread holds
constexpr int kStripCols = 32;  // columns of a strip

// The panel layout: SLOTS threads across a strip of kStripCols columns,
// kGroups runs of kRun rows down a tile.
template <typename T>
struct Layout {
  static constexpr int SLOTS = kStripCols / Slot<T>::kW;
  static constexpr int kCols = kStripCols;
  static constexpr int kGroups = kPanelThreads / SLOTS;
  static constexpr int kSegRows = kGroups * kRun;
  // segments a carry reaches back in one step (a thread group fetches each)
  static constexpr int kWindow = kGroups < 8 ? kGroups : 8;
};

// Row i of the thread's columns j, j + 1, ...: whole-pair loads when PAIRED
// (m even, so a pair never straddles a row), else element by element.
template <typename T, bool PAIRED>
__device__ __forceinline__ typename Slot<T>::V load_slot(const T* x, size_t o,
                                                         int j, int m) {
  if constexpr (Slot<T>::kW == 1) {
    return x[o];
  } else if constexpr (PAIRED) {
    return *reinterpret_cast<const __nv_bfloat162*>(x + o);
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    return __halves2bfloat162(x[o], j + 1 < m ? x[o + 1] : zero);
  }
}

__device__ __forceinline__ void add_slot(float (&a)[1], float v) { a[0] += v; }
__device__ __forceinline__ void add_slot(float (&a)[2], __nv_bfloat162 v) {
  a[0] += __low2float(v);
  a[1] += __high2float(v);
}

template <typename T, bool PAIRED>
__device__ __forceinline__ void store_slot(T* out, size_t o, int j, int m,
                                           const float (&a)[Slot<T>::kW]) {
  if constexpr (Slot<T>::kW == 1) {
    out[o] = a[0];
  } else if constexpr (PAIRED) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) =
        __floats2bfloat162_rn(a[0], a[1]);
  } else {
    out[o] = __float2bfloat16(a[0]);
    if (j + 1 < m) out[o + 1] = __float2bfloat16(a[1]);
  }
}

__device__ __forceinline__ unsigned long long pack(float v, unsigned epoch) {
  return (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned epoch) {
  *reinterpret_cast<volatile unsigned long long*>(p) = pack(v, epoch);
}

// The value of `*p` once it carries this call's epoch. Its writer holds an
// earlier ticket and runs; a value that has not come after ~2^26 polls is
// a fault: trap, never hang.
__device__ __forceinline__ float wait_for(const unsigned long long* p,
                                          unsigned epoch) {
  const volatile unsigned long long* src = p;
  unsigned long long word = *src;
  for (unsigned spins = 0; static_cast<unsigned>(word >> 32) != epoch;
       ++spins) {
    if (spins > (1u << 26)) __trap();
    __nanosleep(64);
    word = *src;
  }
  return __uint_as_float(static_cast<unsigned>(word));
}

template <typename T, bool PAIRED>
__global__ void __launch_bounds__(kPanelThreads, 4)
rcs_panel(const T* __restrict__ x, int n, int m, int strips, int nseg,
          unsigned epoch, unsigned* __restrict__ ticket,
          unsigned long long* __restrict__ aggregates,
          unsigned long long* __restrict__ inclusive, T* __restrict__ out) {
  using L = Layout<T>;
  constexpr int SLOTS = L::SLOTS;
  constexpr int W = Slot<T>::kW;
  constexpr int kCols = L::kCols;
  constexpr int kGroups = L::kGroups;
  constexpr int kSegRows = L::kSegRows;
  constexpr int kWindow = L::kWindow;
  __shared__ int s_tile;
  __shared__ float s_tot[kGroups][kCols];
  __shared__ float s_in[kWindow + 1][kCols];
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    // every other block holds its ticket already: reset for the next call
    if (t == strips * nseg - 1) *ticket = 0u;
    s_tile = t;
  }
  __syncthreads();
  const int t = s_tile;
  const int strip = t % strips;
  const int seg = nseg - 1 - t / strips;
  const int c = threadIdx.x % SLOTS;
  const int grp = threadIdx.x / SLOTS;
  const int j = strip * kCols + c * W;  // the thread's first column
  const int lo = seg * kSegRows + grp * kRun;
  const bool col_ok = j < m;

  // The run, raw, all its loads in flight at once; its sum.
  typename Slot<T>::V v[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int i = lo + r;
    v[r] = (col_ok && i < n)
               ? load_slot<T, PAIRED>(x, static_cast<size_t>(i) * m + j, j, m)
               : Slot<T>::zero();
  }
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

  // Word (segment, strip, column) of the aggregates and the inclusive sums.
  auto word = [&](int sg, int col) {
    return (static_cast<size_t>(sg) * strips + strip) * kCols + col;
  };
  // This tile's aggregate is known: publish it at once.
  if (grp == 0) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      publish(aggregates + word(seg, c * W + w), later[w] + acc[w], epoch);
  }
  // The carry from below, by one formula whatever the timing:
  //   carry(s) = A(s + 1) + ... + A(s + kWindow - 1) + P(s + kWindow),
  // the terms past the last segment 0, where A is a tile's aggregate and
  // P(s) = carry(s) + A(s) its inclusive sum. Thread group k - 1 fetches
  // A(s + k) for 1 <= k < kWindow and P(s + kWindow) for k = kWindow, so
  // the serial chain runs through every kWindow-th segment only.
  if (grp < kWindow) {
    const int k = grp + 1;
    const int sg = seg + k;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float in = 0.f;
      if (sg < nseg) {
        in = wait_for((k < kWindow ? aggregates : inclusive) +
                          word(sg, c * W + w), epoch);
      }
      s_in[k][c * W + w] = in;
    }
  }
  __syncthreads();
  float run[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int col = c * W + w;
    float carry = 0.f;
    for (int k = kWindow; k >= 1; --k) carry += s_in[k][col];
    if (grp == 0 && seg > 0)
      publish(inclusive + word(seg, col), carry + (later[w] + acc[w]), epoch);
    run[w] = carry + later[w];
  }
  if (!col_ok) return;
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
  using L = Layout<T>;
  const long long strips = (m + L::kCols - 1) / L::kCols;
  const long long nseg = (n + L::kSegRows - 1) / L::kSegRows;
  return kHeaderBytes + 2 * nseg * strips * L::kCols * 8;  // A and P words
}

template <typename T, bool PAIRED>
int launch_panel(const T* x, int n, int m, unsigned epoch, char* scratch,
                 T* out, cudaStream_t st) {
  using L = Layout<T>;
  const int strips = (m + L::kCols - 1) / L::kCols;
  const int nseg = (n + L::kSegRows - 1) / L::kSegRows;
  if (static_cast<long long>(strips) * nseg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(scratch + kHeaderBytes);
  rcs_panel<T, PAIRED><<<strips * nseg, kPanelThreads, 0, st>>>(
      x, n, m, strips, nseg, epoch, reinterpret_cast<unsigned*>(scratch),
      words, words + static_cast<size_t>(nseg) * strips * L::kCols, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, int n, int m, unsigned epoch, char* scratch, T* out,
           cudaStream_t st) {
  if (m >= 32) {
    // bfloat16 pairs load whole when no pair straddles a row or a 4-byte
    // boundary
    const bool paired = Slot<T>::kW == 2 && m % 2 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 4 == 0;
    return paired
               ? launch_panel<T, true>(x, n, m, epoch, scratch, out, st)
               : launch_panel<T, false>(x, n, m, epoch, scratch, out, st);
  }
  const int nb = (n + kTile - 1) / kTile;
  float* totals = reinterpret_cast<float*>(scratch + kHeaderBytes);
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
  return kHeaderBytes + nb * m * 4;
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
