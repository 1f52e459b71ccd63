// Causal grouped-query attention, forward, in one launch: for each (batch
// b, query head h) and each query row t,
//
//   o_t = sum_{s <= t} softmax_s(q_t . k_s / sqrt(hd)) v_s
//
// where query head h reads KV head h / G (G = H / KH). q (B, S, H, hd) and
// k, v (B, S, KH, hd) are bfloat16 read in place through their strides (the
// projections' views); o (B, S, H, hd) bfloat16 is written once. The
// streaming softmax keeps its running max m, sum l and accumulator in
// float32 registers; masked scores are -inf and the output divides by l, as
// the plain version (kernels/ref.py::flash_attention_ref) does.
//
// Replaces no TPU kernel: the JAX package's attention is plain jnp
// (src/repro/models/layers.py::flash_attention), which XLA fuses on the
// TPU. The port's plain version upcasts q, k and v to float32, runs both
// products as float32 GEMMs on CUDA cores over every block of the causal
// square, and writes a float32 score tensor of q_chunk x kv_chunk per (row,
// head) block to device memory and reads it back in six to eight eager
// passes; this kernel keeps scores and probabilities in registers.
//
// What bounds it on an H100: operations. The causal QK^T and PV of
// Nemotron-H's attention layer at 4 x 4,096 tokens, 32 query heads of 128
// and 2 KV heads are 2 H hd (S + 1) FLOPs a token, 550 GFLOP, 0.556 ms at
// the 989 TFLOP/s bfloat16 tensor-core rate; q, k, v and o are 285 MB,
// 0.085 ms at 3.35 TB/s.
//
// Design: one block of 4 warps per (64 query rows, h, b), two blocks on an
// SM; warp w owns rows 16w..16w+15 and keeps their q fragments in
// registers for the whole key loop. K and V stream through shared memory
// in tiles of 64 keys, two buffers, the next tile's cp.async in flight
// while the current one is computed, one block-wide barrier a tile. Both
// products run on mma.sync m16n8k16 bfloat16 tensor cores with float32
// accumulation: q k^T from the bfloat16 operands as they are (exact
// products), then P, the probabilities 2^(s log2(e) / sqrt(hd) - m'),
// rounded to bfloat16 in registers and fed as the A operand of P V
// straight from the score accumulators' layout. The key loop stops at the
// diagonal tile, a warp skips a tile that lies wholly above its rows and
// masks only the tile that crosses them. Blocks of the last (longest) row
// tiles launch first, and the heads of one KV group are neighbours in the
// grid, so a group's K and V are read from L2. Nothing is atomic and no sum
// is split over keys: the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kM = 64;   // query rows a block
constexpr int kN = 64;   // keys a tile
constexpr int kWarps = kM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bfloat16; d float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) rounded to bfloat16, a in the low 16 bits (the lower k or column)
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Tile {
  // padded rows (elements): 16 bytes more than the data, so the 8 rows of
  // an ldmatrix 8 x 8 tile fall on distinct banks
  static constexpr int kLd = HD + 8;
  // the q tile (later the output's staging), then K and V, kStages each
  static constexpr int kSmem = (kM + 2 * kStages * kN) * kLd * 2;
  static_assert(HD % 16 == 0, "head_dim a multiple of 16");
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_kernel(const bf16* __restrict__ q, long long q_bs, long long q_rs,
                  long long q_hs, const bf16* __restrict__ k, long long k_bs,
                  long long k_rs, long long k_hs, const bf16* __restrict__ v,
                  long long v_bs, long long v_rs, long long v_hs,
                  bf16* __restrict__ o, int S, int H, int G,
                  float scale_log2) {
  constexpr int kLd = Tile<HD>::kLd, kChunks = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kM * kLd;              // [kStages][kN][kLd]
  bf16* sv = sk + kStages * kN * kLd;    // [kStages][kN][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * kM;  // longest rows first
  const bf16* qp = q + b * q_bs + h * q_hs;
  const bf16* kp = k + b * k_bs + (h / G) * k_hs;
  const bf16* vp = v + b * v_bs + (h / G) * v_hs;
  const int n_tiles = (min(m0 + kM, S) - 1) / kN + 1;

  for (int i = threadIdx.x; i < kM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = m0 + r < S;
    cp_async16(sq + r * kLd + c * 8, qp + (ok ? m0 + r : 0) * q_rs + c * 8,
               ok);
  }
  auto load_kv = [&](int j) {
    bf16* ks = sk + (j % kStages) * kN * kLd;
    bf16* vs = sv + (j % kStages) * kN * kLd;
    for (int i = threadIdx.x; i < kN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const int key = j * kN + r;
      const bool ok = key < S;
      const long long row = ok ? key : 0;
      cp_async16(ks + r * kLd + c * 8, kp + row * k_rs + c * 8, ok);
      cp_async16(vs + r * kLd + c * 8, vp + row * v_rs + c * 8, ok);
    }
  };
  load_kv(0);
  cp_async_commit();

  // this warp's rows: r0..r0+15 of the tile; a thread holds rows g, g + 8
  const int r0 = warp * 16;
  const int first = m0 + r0, last = first + 15;
  const int row_lo = first + g, row_hi = row_lo + 8;
  const float neg_inf = __int_as_float(0xff800000);
  uint32_t qf[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_lo = neg_inf, m_hi = neg_inf, l_lo = 0.f, l_hi = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed and every warp is done with tile j - 1, whose
    // buffers take tile j + 1 while this one is computed
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], sq + (r0 + (lane & 15)) * kLd + kk * 16 +
                            ((lane >> 4) << 3));
    }
    const int k0 = j * kN;
    if (k0 <= last) {
      const bf16* ks = sk + (j % kStages) * kN * kLd;
      const bf16* vs = sv + (j % kStages) * kN * kLd;
      // s = q k^T over this tile's keys, 16 x kN a warp
      float s[kN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kN / 16; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          kk * 16 + (((lane >> 3) & 1) << 3));
          mma(s[2 * np], qf[kk], kb[0], kb[1]);
          mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
      if (k0 + kN - 1 > first) {  // the tile crosses the diagonal
#pragma unroll
        for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + nt * 8 + 2 * tq + (e & 1);
            if (key > (e < 2 ? row_lo : row_hi)) s[nt][e] = neg_inf;
          }
      }
      // the running max over the quad that shares a row; every row has
      // met key 0 in the first tile, so the max is finite from there on
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, off));
      }
      const float c_lo = exp2_approx((m_lo - mx_lo) * scale_log2);
      const float c_hi = exp2_approx((m_hi - mx_hi) * scale_log2);
      m_lo = mx_lo;
      m_hi = mx_hi;
      l_lo *= c_lo;
      l_hi *= c_hi;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[dt][0] *= c_lo;
        acc[dt][1] *= c_lo;
        acc[dt][2] *= c_hi;
        acc[dt][3] *= c_hi;
      }
      // P in registers, rounded to bfloat16 as the A operand of P V: key
      // step kk holds score tiles 2 kk (keys 0-7) and 2 kk + 1 (keys 8-15)
      const float b_lo = mx_lo * scale_log2, b_hi = mx_hi * scale_log2;
      uint32_t pa[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half;
          const float p0 = exp2_approx(fmaf(s[nt][0], scale_log2, -b_lo));
          const float p1 = exp2_approx(fmaf(s[nt][1], scale_log2, -b_lo));
          const float p2 = exp2_approx(fmaf(s[nt][2], scale_log2, -b_hi));
          const float p3 = exp2_approx(fmaf(s[nt][3], scale_log2, -b_hi));
          l_lo += p0 + p1;
          l_hi += p2 + p3;
          pa[kk][2 * half] = pack(p0, p1);
          pa[kk][2 * half + 1] = pack(p2, p3);
        }
      // acc += P V
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vs + (kk * 16 + (lane & 7) +
                              (((lane >> 3) & 1) << 3)) * kLd +
                            dp * 16 + ((lane >> 4) << 3));
          mma(acc[2 * dp], pa[kk], vb[0], vb[1]);
          mma(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
  }

  // l over the quad, in a fixed order; o = acc / l rounded once, staged
  // over this warp's own rows of the q tile, written in 16-byte pieces
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, off);
    l_hi += __shfl_xor_sync(kFull, l_hi, off);
  }
  bf16* stage = sq + r0 * kLd;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(stage + g * kLd + d) =
        pack(acc[dt][0] / l_lo, acc[dt][1] / l_lo);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + d) =
        pack(acc[dt][2] / l_hi, acc[dt][3] / l_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    const int row = first + r;
    if (row < S) {
      *reinterpret_cast<uint4*>(
          o + ((static_cast<long long>(b) * S + row) * H + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c * 8);
    }
  }
}

template <int HD>
int launch(const bf16* q, long long q_bs, long long q_rs, long long q_hs,
           const bf16* k, long long k_bs, long long k_rs, long long k_hs,
           const bf16* v, long long v_bs, long long v_rs, long long v_hs,
           bf16* o, int batch, int S, int H, int G, cudaStream_t st) {
  auto* kern = flash_attn_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  const dim3 grid(H, batch, (S + kM - 1) / kM);
  kern<<<grid, kThreads, Tile<HD>::kSmem, st>>>(
      q, q_bs, q_rs, q_hs, k, k_bs, k_rs, k_hs, v, v_bs, v_rs, v_hs, o, S, H,
      G, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o (batch, S, H, HD) bfloat16, contiguous, from q (row s of batch b, head
// h at q + b q_bs + s q_rs + h q_hs), k and v (the same with KH heads),
// causal, query head h reading KV head h / (H / KH). Pointers and strides
// 16-byte aligned, each row's HD values contiguous; HD 64 or 128. One
// launch on `stream`, no other device work.
int repro_flash_attn(const void* q, long long q_bs, long long q_rs,
                     long long q_hs, const void* k, long long k_bs,
                     long long k_rs, long long k_hs, const void* v,
                     long long v_bs, long long v_rs, long long v_hs, void* o,
                     int batch, int S, int H, int KH, int HD, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      batch > 65535 || (S + kM - 1) / kM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (HD == 128)
    return launch<128>(qb, q_bs, q_rs, q_hs, kb, k_bs, k_rs, k_hs, vb, v_bs,
                       v_rs, v_hs, ob, batch, S, H, H / KH, st);
  if (HD == 64)
    return launch<64>(qb, q_bs, q_rs, q_hs, kb, k_bs, k_rs, k_hs, vb, v_bs,
                      v_rs, v_hs, ob, batch, S, H, H / KH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
