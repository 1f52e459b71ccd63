// A second design of the revcumsum panel scan, kept for comparison with
// src/repro_torch/kernels/csrc/revcumsum.cu (scripts/ab_revcumsum_ring.py
// builds it and times the two in turns). It is not part of the package.
//
//   out[i, :] = sum_{k >= i} x[k, :]    x row-major (n, m), float32 or
//                                       bfloat16; sums in float32
//
// The design: one block per strip of SB bytes of columns (8 float32
// columns at SB = 32, so 125 strips at m = 1,000), walking the row tiles
// from the last to the first. The tiles (R rows x SB bytes) reach shared
// memory through a ring of S stages fed by TMA (cp.async.bulk.tensor.2d,
// one thread issuing), each stage with an mbarrier that the copy
// completes. The block carries the strip's running total in registers, so
// blocks never wait on each other and x is read once: 8 n m bytes moved in
// float32. A warp takes R / 8 rows of a tile, 32 / (SB / 4) rows a step
// with a 4-byte slot (one float32, or a pair of bfloat16) a lane, so its
// shared-memory reads are conflict-free; the step's suffix is formed by
// shuffles, the warp's by a running sum, the tile's by the warps' totals
// in a fixed order. No float atomics: bits repeat.
//
// A second family (rcs_ring_chain) keeps the package kernel's tiling and
// carry chain and feeds it through the same ring: persistent blocks, as
// many as fit on the card, each holding S tickets ahead; a ticket is a
// (row segment, strip) tile of R rows x SB bytes, dealt later segments
// first; the carry of segment s is A(s+1) + ... + A(s+7) + P(s+8) from
// epoch-tagged words, as in the package. A block processes its tickets in
// ascending order, so the lowest unfinished ticket always runs: no
// deadlock.
//
// TMA asks for a row stride that is a multiple of 16 bytes (m a multiple of
// 4 in float32, of 8 in bfloat16) and a 16-byte aligned base.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Slot;
template <>
struct Slot<float> {
  using V = float;
  static constexpr int kW = 1;
  static __device__ __forceinline__ void unpack(V v, float (&a)[1]) {
    a[0] = v;
  }
};
template <>
struct Slot<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static constexpr int kW = 2;
  static __device__ __forceinline__ void unpack(V v, float (&a)[2]) {
    a[0] = __low2float(v);
    a[1] = __high2float(v);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete; a copy that has not landed
// after ~2^26 polls is a fault: trap, never hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void store(T* out, size_t o, int j, int m,
                                      const float (&a)[Slot<T>::kW]) {
  if constexpr (Slot<T>::kW == 1) {
    out[o] = a[0];
  } else {
    if ((m & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(out + o) =
          __floats2bfloat162_rn(a[0], a[1]);
    } else {
      out[o] = __float2bfloat16(a[0]);
      if (j + 1 < m) out[o + 1] = __float2bfloat16(a[1]);
    }
  }
}

template <typename T, int SB, int R, int S>
__global__ void __launch_bounds__(kThreads, 1)
rcs_ring(const __grid_constant__ CUtensorMap map, int n, int m,
         T* __restrict__ out) {
  using P = Slot<T>;
  constexpr int W = P::kW;
  constexpr int SLOTS = SB / 4;        // 4-byte slots across a strip
  constexpr int COLS = SLOTS * W;      // columns of a strip
  constexpr int RPW = 32 / SLOTS;      // rows a warp covers in one step
  constexpr int WROWS = R / kWarps;    // rows a warp takes of a tile
  constexpr int STEPS = WROWS / RPW;
  constexpr unsigned kStageBytes = R * SB;
  static_assert(WROWS % RPW == 0, "a warp's rows are whole steps");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ float tot[2][kWarps][COLS];

  const int col0 = blockIdx.x * COLS;
  const int tiles = (n + R - 1) / R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane % SLOTS;
  const int q = lane / SLOTS;  // the lane's row within a step
  const int j = col0 + slot * W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < S && i < tiles; ++i) {
      mbar_expect_tx(&full[i], kStageBytes);
      tma_load(ring + i * kStageBytes, &map, &full[i], col0,
               (tiles - 1 - i) * R);
    }
  }
  float carry[W] = {};  // the later tiles' total, this lane's columns
  for (int i = 0; i < tiles; ++i) {
    const int s = i % S;
    const int row0 = (tiles - 1 - i) * R;
    mbar_wait(&full[s], (i / S) & 1);
    const typename P::V* tile =
        reinterpret_cast<const typename P::V*>(ring + s * kStageBytes);
    float o[STEPS][W];
    float run[W] = {};
#pragma unroll
    for (int k = STEPS - 1; k >= 0; --k) {
      float v[W];
      P::unpack(tile[(warp * WROWS + k * RPW + q) * SLOTS + slot], v);
#pragma unroll
      for (int d = 1; d < RPW; d *= 2) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float u = __shfl_down_sync(0xffffffffu, v[w], d * SLOTS);
          if (q + d < RPW) v[w] += u;
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        o[k][w] = v[w] + run[w];
        run[w] += __shfl_sync(0xffffffffu, v[w], slot);  // the step's total
      }
    }
    const int buf = i & 1;
    if (q == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) tot[buf][warp][slot * W + w] = run[w];
    }
    __syncthreads();  // every read of stage s is done: refill it
    if (threadIdx.x == 0 && i + S < tiles) {
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load(ring + s * kStageBytes, &map, &full[s], col0,
               (tiles - 1 - i - S) * R);
    }
    float off[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float later = 0.f, all = 0.f;
      for (int u = kWarps - 1; u >= 0; --u) {
        const float t = tot[buf][u][slot * W + w];
        if (u > warp) later += t;
        all += t;
      }
      off[w] = carry[w] + later;
      carry[w] += all;
    }
    if (j < m) {
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int r = row0 + warp * WROWS + k * RPW + q;
        if (r < n) {
          float a[W];
#pragma unroll
          for (int w = 0; w < W; ++w) a[w] = o[k][w] + off[w];
          store(out, static_cast<size_t>(r) * m + j, j, m, a);
        }
      }
    }
  }
}

constexpr int kWindow = 8;  // segments a carry reaches back in one step

__device__ __forceinline__ void publish(unsigned long long* p, float v,
                                        unsigned epoch) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
}

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

template <typename T, int SB, int R, int S>
__global__ void __launch_bounds__(kThreads, 1)
rcs_ring_chain(const __grid_constant__ CUtensorMap map, int n, int m,
               int strips, int nseg, unsigned epoch,
               unsigned* __restrict__ ticket,
               unsigned long long* __restrict__ aggregates,
               unsigned long long* __restrict__ inclusive,
               T* __restrict__ out) {
  using P = Slot<T>;
  constexpr int W = P::kW;
  constexpr int SLOTS = SB / 4;
  constexpr int COLS = SLOTS * W;
  constexpr int RPW = 32 / SLOTS;
  constexpr int WROWS = R / kWarps;
  constexpr int STEPS = WROWS / RPW;
  constexpr unsigned kStageBytes = R * SB;
  static_assert(WROWS % RPW == 0, "a warp's rows are whole steps");
  static_assert(kWindow <= kWarps, "a warp fetches each carry term");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ int tick[S];
  __shared__ float tot[2][kWarps][COLS];
  __shared__ float s_in[kWindow + 1][COLS];

  const int total = strips * nseg;
  const unsigned grabs = static_cast<unsigned>(total) + gridDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = lane % SLOTS;
  const int q = lane / SLOTS;
  bool stopped = false;  // thread 0's: its last grab found no tile
  // Thread 0: take the next ticket for stage s and start its copy. Every
  // block makes exactly one grab that finds no tile, so the grab numbered
  // total + gridDim.x - 1 is the last of the call: it resets the counter.
  auto refill = [&](int s) {
    int t = -1;
    if (!stopped) {
      const unsigned g = atomicAdd(ticket, 1u);
      if (g == grabs - 1) *ticket = 0u;
      if (g < static_cast<unsigned>(total)) {
        t = static_cast<int>(g);
      } else {
        stopped = true;
      }
    }
    tick[s] = t;
    if (t >= 0) {
      const int strip = t % strips;
      const int seg = nseg - 1 - t / strips;
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load(ring + s * kStageBytes, &map, &full[s], strip * COLS,
               seg * R);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S; ++s) refill(s);
  }
  __syncthreads();
  for (int i = 0;; ++i) {
    const int s = i % S;
    const int t = tick[s];
    if (t < 0) break;
    const int strip = t % strips;
    const int seg = nseg - 1 - t / strips;
    const int col0 = strip * COLS;
    mbar_wait(&full[s], (i / S) & 1);
    const typename P::V* tile =
        reinterpret_cast<const typename P::V*>(ring + s * kStageBytes);
    float o[STEPS][W];
    float run[W] = {};
#pragma unroll
    for (int k = STEPS - 1; k >= 0; --k) {
      float v[W];
      P::unpack(tile[(warp * WROWS + k * RPW + q) * SLOTS + slot], v);
#pragma unroll
      for (int d = 1; d < RPW; d *= 2) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float u = __shfl_down_sync(0xffffffffu, v[w], d * SLOTS);
          if (q + d < RPW) v[w] += u;
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        o[k][w] = v[w] + run[w];
        run[w] += __shfl_sync(0xffffffffu, v[w], slot);
      }
    }
    const int buf = i & 1;
    if (q == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) tot[buf][warp][slot * W + w] = run[w];
    }
    __syncthreads();  // every read of stage s is done
    if (threadIdx.x == 0) refill(s);
    // Word (segment, column of this strip) of the aggregates and inclusive
    // sums.
    auto word = [&](int sg, int col) {
      return (static_cast<size_t>(sg) * strips + strip) * COLS + col;
    };
    float later[W], all[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      later[w] = 0.f;
      all[w] = 0.f;
      for (int u = kWarps - 1; u >= 0; --u) {
        const float x = tot[buf][u][slot * W + w];
        if (u > warp) later[w] += x;
        all[w] += x;
      }
    }
    if (warp == 0 && q == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        publish(aggregates + word(seg, slot * W + w), all[w], epoch);
    }
    // carry(s) = A(s + 1) + ... + A(s + kWindow - 1) + P(s + kWindow);
    // warp k - 1 fetches the k-th term
    if (warp < kWindow && q == 0) {
      const int k = warp + 1;
      const int sg = seg + k;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float in = 0.f;
        if (sg < nseg)
          in = wait_for((k < kWindow ? aggregates : inclusive) +
                            word(sg, slot * W + w), epoch);
        s_in[k][slot * W + w] = in;
      }
    }
    __syncthreads();
    float off[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float carry = 0.f;
      for (int k = kWindow; k >= 1; --k) carry += s_in[k][slot * W + w];
      if (warp == 0 && q == 0 && seg > 0)
        publish(inclusive + word(seg, slot * W + w), carry + all[w], epoch);
      off[w] = carry + later[w];
    }
    const int j = col0 + slot * W;
    if (j < m) {
      const int row0 = seg * R;
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int r = row0 + warp * WROWS + k * RPW + q;
        if (r < n) {
          float a[W];
#pragma unroll
          for (int w = 0; w < W; ++w) a[w] = o[k][w] + off[w];
          store(out, static_cast<size_t>(r) * m + j, j, m, a);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
bool encode_map(CUtensorMap* map, const void* x, int n, int m, int cols,
                int rows, int promote) {
  if ((static_cast<long long>(m) * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return false;
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(x), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                promote ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                        : CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kHeaderBytes = 16;

// A launcher: (x, n, m, promote, scratch, epoch, out, stream), and the
// scratch bytes it needs for (n, m).
using Launch = int (*)(const void*, int, int, int, void*, unsigned, void*,
                       cudaStream_t);
using Scratch = long long (*)(int, int);

template <typename T, int SB, int R, int S>
int launch(const void* x, int n, int m, int promote, void*, unsigned,
           void* out, cudaStream_t st) {
  constexpr int COLS = SB / 4 * Slot<T>::kW;
  CUtensorMap map;
  if (!encode_map<T>(&map, x, n, m, COLS, R, promote))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = S * R * SB;
  auto kernel = rcs_ring<T, SB, R, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (m + COLS - 1) / COLS;
  kernel<<<strips, kThreads, kSmem, st>>>(map, n, m, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

long long no_scratch(int, int) { return 0; }

template <typename T, int SB, int R>
long long chain_scratch(int n, int m) {
  constexpr int COLS = SB / 4 * Slot<T>::kW;
  const long long strips = (m + COLS - 1) / COLS;
  const long long nseg = (n + R - 1) / R;
  return kHeaderBytes + 2 * nseg * strips * COLS * 8;
}

template <typename T, int SB, int R, int S>
int launch_chain(const void* x, int n, int m, int promote, void* scratch,
                 unsigned epoch, void* out, cudaStream_t st) {
  constexpr int COLS = SB / 4 * Slot<T>::kW;
  CUtensorMap map;
  if (!encode_map<T>(&map, x, n, m, COLS, R, promote))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = S * R * SB;
  auto kernel = rcs_ring_chain<T, SB, R, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (m + COLS - 1) / COLS;
  const int nseg = (n + R - 1) / R;
  const long long total = static_cast<long long>(strips) * nseg;
  const int grid = static_cast<int>(
      total < static_cast<long long>(sms) * per_sm ? total : sms * per_sm);
  char* sc = static_cast<char*>(scratch);
  unsigned long long* words =
      reinterpret_cast<unsigned long long*>(sc + kHeaderBytes);
  kernel<<<grid, kThreads, kSmem, st>>>(
      map, n, m, strips, nseg, epoch, reinterpret_cast<unsigned*>(sc), words,
      words + static_cast<size_t>(nseg) * strips * COLS,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The variants compared. "strip": one block per strip (type, strip bytes,
// rows a tile, stages); "chain": the package's tiles through the ring.
struct Variant {
  const char* name;
  Launch fn;
  Scratch scratch;
};
const Variant kVariants[] = {
    {"f32 strip16 R256 S8", launch<float, 16, 256, 8>, no_scratch},
    {"f32 strip32 R256 S4", launch<float, 32, 256, 4>, no_scratch},
    {"f32 strip32 R256 S8", launch<float, 32, 256, 8>, no_scratch},
    {"f32 strip32 R256 S16", launch<float, 32, 256, 16>, no_scratch},
    {"f32 strip64 R256 S8", launch<float, 64, 256, 8>, no_scratch},
    {"f32 strip64 R128 S16", launch<float, 64, 128, 16>, no_scratch},
    {"bf16 strip16 R256 S8", launch<__nv_bfloat16, 16, 256, 8>, no_scratch},
    {"bf16 strip32 R256 S8", launch<__nv_bfloat16, 32, 256, 8>, no_scratch},
    {"bf16 strip32 R256 S16", launch<__nv_bfloat16, 32, 256, 16>,
     no_scratch},
    {"f32 chain128 R256 S4", launch_chain<float, 128, 256, 4>,
     chain_scratch<float, 128, 256>},
    {"f32 chain128 R128 S6", launch_chain<float, 128, 128, 6>,
     chain_scratch<float, 128, 128>},
    {"f32 chain128 R64 S8", launch_chain<float, 128, 64, 8>,
     chain_scratch<float, 128, 64>},
    {"bf16 chain64 R256 S4", launch_chain<__nv_bfloat16, 64, 256, 4>,
     chain_scratch<__nv_bfloat16, 64, 256>},
    {"bf16 chain128 R256 S4", launch_chain<__nv_bfloat16, 128, 256, 4>,
     chain_scratch<__nv_bfloat16, 128, 256>},
    {"bf16 chain128 R128 S6", launch_chain<__nv_bfloat16, 128, 128, 6>,
     chain_scratch<__nv_bfloat16, 128, 128>},
};

}  // namespace

extern "C" {

int ring_variants() { return sizeof(kVariants) / sizeof(kVariants[0]); }

const char* ring_variant_name(int v) { return kVariants[v].name; }

// Bytes of zeroed scratch variant v needs at (n, m); every call leaves it
// valid for the next, given a new nonzero epoch.
long long ring_scratch_bytes(int v, int n, int m) {
  return kVariants[v].scratch(n, m);
}

// out <- suffix sum of x along rows with variant v; promote != 0 asks TMA
// to promote its L2 fills to 256 bytes.
int ring_revcumsum(int v, const void* x, int n, int m, int promote,
                   void* scratch, unsigned epoch, void* out, void* stream) {
  if (v < 0 || v >= ring_variants() || n <= 0 || m <= 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return kVariants[v].fn(x, n, m, promote, scratch, epoch, out,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
