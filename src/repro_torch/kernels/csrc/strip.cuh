// Strip tiles: the one-read layout of a row-major (n, m) panel that
// revcumsum.cu, cox_batch.cu and lipschitz.cu share, for work that carries
// a value per column from the later rows to the earlier ones (a suffix sum,
// a suffix max or min).
//
// Columns are cut into strips of kCols = 32 (a 128-byte line of float32,
// 64 bytes of bfloat16) and rows into segments of kSegRows (256 float32
// rows, 512 bfloat16); a block of kThreads takes one (segment, strip) tile.
// Each thread holds a run of kRun = 32 rows of its column (a bfloat16
// thread a pair of columns) in registers, raw, all its loads in flight at
// once, so four blocks fit an SM.
//
// Tiles are dealt through a ticket, later segments first (take_tile), so a
// block only ever waits on blocks that already hold a ticket and run: no
// deadlock whatever the scheduler does. A tile publishes its aggregate A(s)
// of each carried value, gathers its carry from the later segments by one
// fixed formula (carry_from_below), and publishes its inclusive value P(s).
// The formula takes the same terms in the same order whatever the timing,
// so bits repeat. Every published value is packed with the call's epoch in
// one 64-bit word: no memset or fence per call.
//
// Per-(segment, column) partial sums in float64 go to a scratch of their
// own and are summed in a fixed order (sum_partials): the last tile of each
// group of kSuper segments to finish sums its group's partials, the last
// group of a strip the groups' sums. The counters that say which is last
// are epoch-tagged words too, so nothing needs resetting between calls.
// The tagged scratch holds only the ticket and tagged words, whatever
// shapes earlier calls had, so a stale word never carries this call's
// epoch; the partials, untagged, are written before they are read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {
namespace strip {

constexpr int kThreads = 256;     // a block
constexpr int kRun = 32;          // rows a thread holds
constexpr int kCols = 32;         // columns of a strip
constexpr int kTicketBytes = 16;  // the ticket opening the tagged scratch
constexpr int kSuper = 32;        // segments whose partials one block sums

// What a thread holds of one row: one float32 column, or a pair of
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

// SLOTS threads across a strip, kGroups runs of kRun rows down a tile.
template <typename T>
struct Layout {
  static constexpr int SLOTS = kCols / Slot<T>::kW;
  static constexpr int kGroups = kThreads / SLOTS;
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

// The thread's run, rows lo .. lo + kRun - 1 of its columns from j, raw;
// zero past n or past the last column.
template <typename T, bool PAIRED>
__device__ __forceinline__ void load_run(const T* __restrict__ x, int n,
                                         int m, int lo, int j,
                                         typename Slot<T>::V (&v)[kRun]) {
  const bool col_ok = j < m;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int i = lo + r;
    v[r] = (col_ok && i < n)
               ? load_slot<T, PAIRED>(x, static_cast<size_t>(i) * m + j, j, m)
               : Slot<T>::zero();
  }
}

// The slot's values as float32.
__device__ __forceinline__ void unpack(float v, float (&a)[1]) { a[0] = v; }
__device__ __forceinline__ void unpack(__nv_bfloat162 v, float (&a)[2]) {
  a[0] = __low2float(v);
  a[1] = __high2float(v);
}

// The tile this block takes: (strip, segment), later segments first. The
// block that takes the last ticket resets it for the next call (every
// other block holds its ticket already). All threads of the block call.
struct Tile {
  int strip;
  int seg;
};
__device__ __forceinline__ Tile take_tile(unsigned* ticket, int strips,
                                          int nseg) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    if (t == strips * nseg - 1) *ticket = 0u;
    s_ticket = t;
  }
  __syncthreads();
  const int t = s_ticket;
  return Tile{t % strips, nseg - 1 - t / strips};
}

__device__ __forceinline__ unsigned long long pack(float v, unsigned epoch) {
  return (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned epoch) {
  *reinterpret_cast<volatile unsigned long long*>(p) = pack(v, epoch);
}

// The values of the words `p[v]` once each carries this call's epoch,
// polled together, so a thread that waits on several words (a bfloat16
// column pair, a max and a min) waits one round trip, not one a word. Their
// writers hold earlier tickets and run; a value that has not come after
// ~2^26 polls is a fault: trap, never hang.
template <int NV>
__device__ __forceinline__ void wait_for(
    const unsigned long long* const (&p)[NV], unsigned epoch,
    float (&out)[NV]) {
  unsigned long long word[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v)
    word[v] = *reinterpret_cast<const volatile unsigned long long*>(p[v]);
  for (unsigned spins = 0;; ++spins) {
    bool ready = true;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      ready = ready && static_cast<unsigned>(word[v] >> 32) == epoch;
    if (ready) break;
    if (spins > (1u << 26)) __trap();
    __nanosleep(64);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (static_cast<unsigned>(word[v] >> 32) != epoch)
        word[v] = *reinterpret_cast<const volatile unsigned long long*>(p[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
    out[v] = __uint_as_float(static_cast<unsigned>(word[v]));
}

// How values combine down a strip; each functor takes the value's index v
// among those a thread carries, so one functor can carry a max and a min.
struct Sum {
  static __device__ __forceinline__ float identity(int) { return 0.f; }
  static __device__ __forceinline__ float apply(int, float a, float b) {
    return a + b;
  }
};
struct MaxMin {  // value 0 a max, value 1 a min
  static __device__ __forceinline__ float identity(int v) {
    return v == 0 ? -INFINITY : INFINITY;
  }
  static __device__ __forceinline__ float apply(int v, float a, float b) {
    return v == 0 ? fmaxf(a, b) : fminf(a, b);
  }
};

// The words of one carried value: A(s), a tile's aggregate, and P(s), its
// inclusive value, each (nseg, strips, kCols).
struct Words {
  unsigned long long* aggregates;
  unsigned long long* inclusive;
};

// The carry of this tile: for each of the NV values a thread carries (its
// W columns' sums, or one column's max and min), the combination of that
// value over every later segment of the strip, by one formula whatever the
// timing:
//   carry(s) = A(s + 1) (+) ... (+) A(s + kWindow - 1) (+) P(s + kWindow),
// the terms past the last segment the identity, P(s) = carry(s) (+) A(s).
// Thread group k - 1 fetches the k-th term, so the serial chain runs
// through every kWindow-th segment only. `total[v]`, this tile's aggregate
// of value v in column col[v], is read in thread group 0. Publishes A(s)
// at once and P(s) once the carry is known. All threads of the block call,
// once per kernel.
template <typename Op, int kWindow, int SLOTS, int NV>
__device__ __forceinline__ void carry_from_below(
    const Words (&words)[NV], const int (&col)[NV], const float (&total)[NV],
    int strips, Tile tile, int nseg, int grp, int slot, unsigned epoch,
    float (&carry)[NV]) {
  __shared__ float s_in[kWindow + 1][NV][SLOTS];
  auto word = [&](int sg, int v) {
    return (static_cast<size_t>(sg) * strips + tile.strip) * kCols + col[v];
  };
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      publish(words[v].aggregates + word(tile.seg, v), total[v], epoch);
  }
  if (grp < kWindow) {
    const int k = grp + 1;
    const int sg = tile.seg + k;
    float in[NV];
    if (sg < nseg) {
      const unsigned long long* src[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        src[v] = (k < kWindow ? words[v].aggregates : words[v].inclusive) +
                 word(sg, v);
      wait_for(src, epoch, in);
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) in[v] = Op::identity(v);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) s_in[k][v][slot] = in[v];
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float c = Op::identity(v);
    for (int k = kWindow; k >= 1; --k) c = Op::apply(v, c, s_in[k][v][slot]);
    carry[v] = c;
    if (grp == 0 && tile.seg > 0)
      publish(words[v].inclusive + word(tile.seg, v),
              Op::apply(v, c, total[v]), epoch);
  }
}

// Adds one to an epoch-tagged counter and returns the new count; a word
// tagged with another epoch counts as 0, so a counter needs no reset.
__device__ __forceinline__ unsigned count_in(unsigned long long* counter,
                                             unsigned epoch) {
  unsigned long long seen = *reinterpret_cast<volatile unsigned long long*>(
      counter);
  unsigned count;
  for (;;) {
    count = static_cast<unsigned>(seen >> 32) == epoch
                ? static_cast<unsigned>(seen) + 1u
                : 1u;
    const unsigned long long next =
        (static_cast<unsigned long long>(epoch) << 32) | count;
    const unsigned long long was = atomicCAS(counter, seen, next);
    if (was == seen) return count;
    seen = was;
  }
}

// The partial sums, in a buffer of their own (plain float64, no epoch
// tags): kParts values a column for every (segment, strip) tile, and the
// same for every group of kSuper segments. Their counters are epoch-tagged
// words in the tagged scratch, (ngroups + 1, strips).
template <int kParts>
struct Partials {
  double* tiles;   // (nseg, strips, kParts, kCols)
  double* groups;  // (ngroups, strips, kParts, kCols)
  unsigned long long* counters;
};

__host__ __device__ inline int super_groups(int nseg) {
  return (nseg + kSuper - 1) / kSuper;
}

template <int kParts>
__host__ __device__ inline long long partials_bytes(int nseg, int strips) {
  return static_cast<long long>(nseg + super_groups(nseg)) * strips *
         kParts * kCols * 8;
}

__host__ __device__ inline long long counters_bytes(int nseg, int strips) {
  return static_cast<long long>(super_groups(nseg) + 1) * strips * 8;
}

template <int kParts>
__host__ __device__ inline Partials<kParts> carve_partials(
    void* at, unsigned long long* counters, int nseg, int strips) {
  Partials<kParts> s;
  s.tiles = static_cast<double*>(at);
  s.groups = s.tiles + static_cast<size_t>(nseg) * strips * kParts * kCols;
  s.counters = counters;
  return s;
}

// Sums `part` (kParts values of column c in `part[q * kCols + c]`, valid
// in threads 0 .. kParts * kCols - 1) over every segment of the strip, in
// a fixed order whichever block does it. Returns true in the one block
// that holds the strip's sums, which then lie in `out` of those threads.
// All threads of the block call, once per kernel.
template <int kParts>
__device__ __forceinline__ bool sum_partials(const Partials<kParts>& s,
                                             double mine, int strips,
                                             Tile tile, int nseg,
                                             unsigned epoch, double* out) {
  constexpr int kPairs = kParts * kCols;
  constexpr int kLanes = kThreads / kPairs;
  static_assert(kThreads % kPairs == 0, "whole lanes only");
  __shared__ double s_red[kLanes][kPairs];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int pair = t % kPairs;
  const int lane = t / kPairs;
  const int ngroups = super_groups(nseg);
  const int grp = tile.seg / kSuper;
  const int first = grp * kSuper;
  const int members = min(kSuper, nseg - first);

  // fixed-order sum of rows first .. first + count - 1 of a table
  auto reduce = [&](const double* table, int first_row, int count) {
    double acc = 0.0;
#pragma unroll 8
    for (int r = lane; r < count; r += kLanes) {
      acc += __ldcg(table + (static_cast<size_t>(first_row + r) * strips +
                             tile.strip) * kPairs + pair);
    }
    s_red[lane][pair] = acc;
    __syncthreads();
    double tot = 0.0;
    if (t < kPairs) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) tot += s_red[l][t];
    }
    __syncthreads();  // s_red is reused
    return tot;
  };
  auto last_of = [&](unsigned long long* counter, unsigned need) {
    __syncthreads();
    if (t == 0) s_last = count_in(counter, epoch) == need;
    __syncthreads();
    const bool last = s_last;
    if (last) __threadfence();  // the other blocks' sums are visible
    return last;
  };

  if (t < kPairs) {
    s.tiles[(static_cast<size_t>(tile.seg) * strips + tile.strip) * kPairs +
            t] = mine;
    __threadfence();  // visible before the counter moves
  }
  if (!last_of(s.counters + static_cast<size_t>(grp) * strips + tile.strip,
               members))
    return false;
  const double group_sum = reduce(s.tiles, first, members);
  if (t < kPairs) {
    s.groups[(static_cast<size_t>(grp) * strips + tile.strip) * kPairs + t] =
        group_sum;
    __threadfence();
  }
  if (!last_of(s.counters + static_cast<size_t>(ngroups) * strips +
                   tile.strip,
               ngroups))
    return false;
  const double total = reduce(s.groups, 0, ngroups);
  if (t < kPairs) *out = total;
  return true;
}

}  // namespace strip
}  // namespace repro
