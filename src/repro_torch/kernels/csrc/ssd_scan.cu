// Chunked SSD (state-space duality) scan of the Mamba2 mixer, with its skip
// term, in one launch. Per (batch b, head h), over chunks of Q tokens:
//
//   L_t     = sum_{u <= t} dt_u A                  (within the chunk)
//   y_t     = sum_{s <= t} (C_t . B_s) exp(L_t - L_s) dt_s x_s      (intra)
//           + exp(L_t) C_t h_in^T                                   (inter)
//           + D x_t                                                 (skip)
//   h_out   = exp(L_Q) h_in + sum_s exp(L_Q - L_s) dt_s x_s B_s^T
//
// x (S, P) and B, C (S, N) are bfloat16 slices of the mixer's conv output
// read in place (row strides given), dt (B, S, H) and A, D (H,) float32; y
// (B, S, H, P) is written once, rounded to bfloat16 after the skip, and the
// (P, N) float32 state h stays on chip from chunk to chunk (written out at
// the end only when asked for). Head h reads B and C of group
// h / (H / G). Every exponent is clamped to [-60, 0] as the eager form
// clamps it; rows past S load as zeros with dt = 0, so they neither decay
// nor feed the state.
//
// Replaces no TPU kernel: the JAX package runs its SSD in plain jnp
// (src/repro/models/ssm.py::_ssd_chunked), which XLA fuses on the TPU. The
// port's eager form (models/ssm.py::_ssd_chunked, _ssd_chunked_grouped, its
// plain version) builds the (Q, Q, H) decay and weight tensors in float32
// in device memory, about a dozen passes over 0.8 GB a layer at the
// mamba2-130m featurize shape; this kernel keeps them in registers.
//
// What bounds it on an H100: both about equally. A layer must read x, B, C
// and dt and write y (0.44 GB at 128 x 512 tokens of mamba2-130m, 132 us at
// 3.35 TB/s); the chunked form's products (C B^T, the masked intra-chunk
// product, the chunk states and the read-out) are ~129 GFLOP there, 130 us
// at the bf16 tensor-core rate.
//
// Design: one block of Q / 16 warps per (b, h), walking the chunks in
// order; the next chunk's x, B, C and dt arrive by cp.async while the
// current one is computed (two buffers). Products run on mma.sync
// m16n8k16 bfloat16 tensor cores with float32 accumulation. C B^T takes
// the bfloat16 operands as they are (exact products). Every float32
// operand of a product (the decay-weighted scores, the dt-scaled x of the
// chunk state, the carried state in the read-out) is split into bfloat16
// hi + lo halves, both multiplied: ~16 bits of mantissa, and never one
// rounding to bfloat16. Warp w owns output rows 16w..16w+15 (C B^T only
// for the causal blocks s <= t, the weights formed in registers) and a
// 16 x (8 kNT) tile of the state, kept in its accumulator registers. The
// state is handed to the read-out through shared memory as its two halves.
// Nothing is atomic: every sum has a fixed order, so bits repeat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kClampLo = -60.f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(u));
  return __bfloat1622float2(v);
}

// (a, b) rounded to bfloat16 (the hi halves) and what they leave, rounded
// (the lo halves), each pair packed with a in the low 16 bits (the lower k
// of an mma operand pair)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ float decay(float v) {
  return expf(fminf(fmaxf(v, kClampLo), 0.f));
}

template <int Q, int P, int N>
struct Shape {
  static constexpr int kWarps = Q / 16;
  static constexpr int kThreads = 32 * kWarps;
  // padded rows (elements): 16 bytes more than the data, so the 8 rows of
  // an ldmatrix 8 x 8 tile fall on distinct banks
  static constexpr int kLdN = N + 8;
  static constexpr int kLdP = P + 8;
  // the state (P, N) over the warps: kMP row tiles of 16, each cut into
  // kColGroups column groups of kNT n-tiles of 8
  static constexpr int kMP = P / 16;
  static constexpr int kColGroups = kWarps / kMP;
  static constexpr int kNT = N / 8 / kColGroups;
  // one buffer: C (Q, N), B (Q, N), x (Q, P), bfloat16
  static constexpr int kBuf = 2 * Q * kLdN + Q * kLdP;
  static constexpr int kSmem =
      (2 * kBuf + 2 * P * kLdN) * 2  // two buffers, the state's halves
      + (2 * Q + 3 * Q + 4) * 4;     // dt x 2, L, exp(L), weights, decay
  static_assert(Q % 16 == 0 && P % 16 == 0 && N % 16 == 0, "16-multiples");
  static_assert(kWarps % kMP == 0 && (N / 8) % kColGroups == 0 &&
                    kNT % 2 == 0,
                "the state's tiles do not divide over the warps");
};

template <int Q, int P, int N>
__global__ void __launch_bounds__(Shape<Q, P, N>::kThreads, 1)
ssd_scan_kernel(const bf16* __restrict__ x, long long x_bs, int x_rs,
                const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                long long bc_bs, int bc_rs, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ D,
                bf16* __restrict__ y, float* __restrict__ state_out, int S,
                int H, int G) {
  using Sh = Shape<Q, P, N>;
  constexpr int kLdN = Sh::kLdN, kLdP = Sh::kLdP, kNT = Sh::kNT;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);
  bf16* s_hi = bufs + 2 * Sh::kBuf;
  bf16* s_lo = s_hi + P * kLdN;
  float* s_dt = reinterpret_cast<float*>(s_lo + P * kLdN);  // [2][Q]
  float* s_cum = s_dt + 2 * Q;
  float* s_ecum = s_cum + Q;
  float* s_w = s_ecum + Q;
  float* s_decay = s_w + Q;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int grp = h / (H / G);
  const bf16* xp = x + b * x_bs + static_cast<long long>(h) * P;
  const bf16* bp = bmat + b * bc_bs + static_cast<long long>(grp) * N;
  const bf16* cp = cmat + b * bc_bs + static_cast<long long>(grp) * N;
  const float* dtp = dt + static_cast<long long>(b) * S * H + h;
  const float a = A[h], dsk = D[h];
  const int nc = (S + Q - 1) / Q;

  auto load = [&](int c, int which) {
    constexpr int kNv = N / 8, kPv = P / 8, kPer = 2 * kNv + kPv;
    bf16* cs = bufs + which * Sh::kBuf;
    bf16* bs = cs + Q * kLdN;
    bf16* xs = bs + Q * kLdN;
    for (int i = threadIdx.x; i < Q * kPer; i += kThreads) {
      const int t = i / kPer, k = i - t * kPer;
      const long long gt = static_cast<long long>(c) * Q + t;
      const bool ok = gt < S;
      const long long row = ok ? gt : 0;
      if (k < kNv) {
        cp_async16(cs + t * kLdN + k * 8, cp + row * bc_rs + k * 8, ok);
      } else if (k < 2 * kNv) {
        const int kb = k - kNv;
        cp_async16(bs + t * kLdN + kb * 8, bp + row * bc_rs + kb * 8, ok);
      } else {
        const int kx = k - 2 * kNv;
        cp_async16(xs + t * kLdP + kx * 8, xp + row * x_rs + kx * 8, ok);
      }
    }
    for (int t = threadIdx.x; t < Q; t += kThreads) {
      const long long gt = static_cast<long long>(c) * Q + t;
      const bool ok = gt < S;
      cp_async4(s_dt + which * Q + t, dtp + (ok ? gt : 0) * H, ok);
    }
    cp_async_commit();
  };

  // this warp's tile of the state: rows d0.., columns n0..
  const int d0 = 16 * (warp % Sh::kMP);
  const int n0 = (warp / Sh::kMP) * kNT * 8;
  float st[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[nt][i] = 0.f;

  const int r0 = 16 * warp;  // this warp's output rows
  const int t0 = r0 + g, t1 = t0 + 8;

  load(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int cur = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's buffer is free
    if (c + 1 < nc) load(c + 1, cur ^ 1);
    const bf16* cs = bufs + cur * Sh::kBuf;
    const bf16* bs = cs + Q * kLdN;
    bf16* xs = const_cast<bf16*>(bs) + Q * kLdN;
    const float* dtc = s_dt + cur * Q;

    // 1. L, exp(L), the state weights exp(L_Q - L_s) dt_s and exp(L_Q)
    if (warp == 0) {
      constexpr int E = (Q + 31) / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        run += i < Q ? dtc[i] * a : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      const float total = __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        if (i < Q) {
          const float l = excl + v[e];
          s_cum[i] = l;
          s_ecum[i] = decay(l);
          s_w[i] = decay(total - l) * dtc[i];
        }
      }
      if (lane == 0) *s_decay = expf(fmaxf(total, kClampLo));
    }
    // 2. the state coming in, as its bfloat16 halves
    if (c > 0) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = d0 + g + 8 * half, n = n0 + nt * 8 + 2 * tq;
          uint32_t hi, lo;
          split2(st[nt][2 * half], st[nt][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + d * kLdN + n) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + d * kLdN + n) = lo;
        }
      }
    }
    __syncthreads();

    // 3. this warp's output rows: the read-out, then the causal blocks
    float yacc[P / 8][4];
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[nt][i] = 0.f;
    {
      uint32_t ca[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        ldsm_x4(ca[kk], cs + (r0 + (lane & 15)) * kLdN + kk * 16 +
                            (lane >> 4) * 8);
      if (c > 0) {
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < P / 16; ++np) {
            const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                kLdN +
                            kk * 16 + (((lane >> 3) & 1) << 3);
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, s_hi + off);
            ldsm_x4(bl, s_lo + off);
            mma(yacc[2 * np], ca[kk], bh[0], bh[1]);
            mma(yacc[2 * np + 1], ca[kk], bh[2], bh[3]);
            mma(yacc[2 * np], ca[kk], bl[0], bl[1]);
            mma(yacc[2 * np + 1], ca[kk], bl[2], bl[3]);
          }
        }
        const float e0 = s_ecum[t0], e1 = s_ecum[t1];
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          yacc[nt][0] *= e0;
          yacc[nt][1] *= e0;
          yacc[nt][2] *= e1;
          yacc[nt][3] *= e1;
        }
      }
      const float l0 = s_cum[t0], l1 = s_cum[t1];
      for (int j = 0; j <= warp; ++j) {  // columns s of block j, s <= t
        float sc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t bb[4];
          ldsm_x4(bb, bs + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                               kLdN +
                          kk * 16 + (((lane >> 3) & 1) << 3));
          mma(sc[0], ca[kk], bb[0], bb[1]);
          mma(sc[1], ca[kk], bb[2], bb[3]);
        }
        // weights (C_t . B_s) exp(L_t - L_s) dt_s on s <= t, as A operands
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int s0 = j * 16 + nt * 8 + 2 * tq, s1 = s0 + 1;
          const float ls0 = s_cum[s0], ls1 = s_cum[s1];
          const float dt0 = dtc[s0], dt1 = dtc[s1];
          const float w00 = s0 <= t0 ? sc[nt][0] * decay(l0 - ls0) * dt0 : 0.f;
          const float w01 = s1 <= t0 ? sc[nt][1] * decay(l0 - ls1) * dt1 : 0.f;
          const float w10 = s0 <= t1 ? sc[nt][2] * decay(l1 - ls0) * dt0 : 0.f;
          const float w11 = s1 <= t1 ? sc[nt][3] * decay(l1 - ls1) * dt1 : 0.f;
          split2(w00, w01, whi[2 * nt], wlo[2 * nt]);
          split2(w10, w11, whi[2 * nt + 1], wlo[2 * nt + 1]);
        }
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t xb[4];
          ldsm_x4_t(xb, xs + (j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                 kLdP +
                            np * 16 + ((lane >> 4) << 3));
          mma(yacc[2 * np], whi, xb[0], xb[1]);
          mma(yacc[2 * np + 1], whi, xb[2], xb[3]);
          mma(yacc[2 * np], wlo, xb[0], xb[1]);
          mma(yacc[2 * np + 1], wlo, xb[2], xb[3]);
        }
      }
    }
    // the skip term, from the chunk's x before the staging overwrites it
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int d = nt * 8 + 2 * tq;
      const float2 x0 =
          unpack(*reinterpret_cast<const uint32_t*>(xs + t0 * kLdP + d));
      const float2 x1 =
          unpack(*reinterpret_cast<const uint32_t*>(xs + t1 * kLdP + d));
      yacc[nt][0] += dsk * x0.x;
      yacc[nt][1] += dsk * x0.y;
      yacc[nt][2] += dsk * x1.x;
      yacc[nt][3] += dsk * x1.y;
    }

    // 4. this warp's tile of the state: h exp(L_Q) + (w x)^T B
    {
      const float dq = *s_decay;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] *= dq;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        uint32_t xa[4];
        ldsm_x4_t(xa, xs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                               kLdP +
                          d0 + (((lane >> 3) & 1) << 3));
        const int sa = kk * 16 + 2 * tq;
        const float w0 = s_w[sa], w1 = s_w[sa + 1];
        const float w2 = s_w[sa + 8], w3 = s_w[sa + 9];
        uint32_t ahi[4], alo[4];
        float2 v = unpack(xa[0]);
        split2(v.x * w0, v.y * w1, ahi[0], alo[0]);
        v = unpack(xa[1]);
        split2(v.x * w0, v.y * w1, ahi[1], alo[1]);
        v = unpack(xa[2]);
        split2(v.x * w2, v.y * w3, ahi[2], alo[2]);
        v = unpack(xa[3]);
        split2(v.x * w2, v.y * w3, ahi[3], alo[3]);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bs + (kk * 16 + (lane & 7) +
                              (((lane >> 3) & 1) << 3)) *
                                 kLdN +
                            n0 + np * 16 + ((lane >> 4) << 3));
          mma(st[2 * np], ahi, bb[0], bb[1]);
          mma(st[2 * np + 1], ahi, bb[2], bb[3]);
          mma(st[2 * np], alo, bb[0], bb[1]);
          mma(st[2 * np + 1], alo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every read of this chunk's x is done

    // 5. y rounded once, staged over this warp's rows of x, written out in
    // 16-byte pieces
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int d = nt * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(xs + t0 * kLdP + d) =
          bits(__floats2bfloat162_rn(yacc[nt][0], yacc[nt][1]));
      *reinterpret_cast<uint32_t*>(xs + t1 * kLdP + d) =
          bits(__floats2bfloat162_rn(yacc[nt][2], yacc[nt][3]));
    }
    __syncwarp();
    constexpr int kPv = P / 8;
    for (int i = lane; i < 16 * kPv; i += 32) {
      const int r = i / kPv, k = i - r * kPv;
      const long long t = static_cast<long long>(c) * Q + r0 + r;
      if (t < S) {
        *reinterpret_cast<uint4*>(
            y + ((static_cast<long long>(b) * S + t) * H + h) * P + k * 8) =
            *reinterpret_cast<const uint4*>(xs + (r0 + r) * kLdP + k * 8);
      }
    }
  }

  if (state_out != nullptr) {
    float* out = state_out + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = d0 + g + 8 * half, n = n0 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(out + d * N + n) =
            make_float2(st[nt][2 * half], st[nt][2 * half + 1]);
      }
    }
  }
}

template <int Q, int P, int N>
int launch(const bf16* x, long long x_bs, int x_rs, const bf16* b,
           const bf16* c, long long bc_bs, int bc_rs, const float* dt,
           const float* A, const float* D, bf16* y, float* state, int batch,
           int S, int H, int G, cudaStream_t st) {
  using Sh = Shape<Q, P, N>;
  auto* kern = ssd_scan_kernel<Q, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<batch * H, Sh::kThreads, Sh::kSmem, st>>>(
      x, x_bs, x_rs, b, c, bc_bs, bc_rs, dt, A, D, y, state, S, H, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (batch, S, H, P) bfloat16 and, when `state` is not null, the final
// state (batch, H, P, N) float32, from x (row r of batch b at x + b x_bs +
// r x_rs, head h's P values at + h P), B and C (the same with bc_bs, bc_rs;
// group g's N values at + g N), dt (batch, S, H) float32 and A, D (H,)
// float32. Pointers and row strides 16-byte aligned; (P, N, Q) one of
// (64, 128, 128), (64, 64, 64) and (16, 16, 16). One launch on `stream`,
// no other device work.
int repro_ssd_scan(const void* x, long long x_bs, int x_rs, const void* b,
                   const void* c, long long bc_bs, int bc_rs, const float* dt,
                   const float* A, const float* D, void* y, float* state,
                   int batch, int S, int H, int G, int P, int N, int Q,
                   void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(b);
  const bf16* cb = static_cast<const bf16*>(c);
  bf16* yb = static_cast<bf16*>(y);
  if (P == 64 && N == 128 && Q == 128)
    return launch<128, 64, 128>(xb, x_bs, x_rs, bb, cb, bc_bs, bc_rs, dt, A,
                                D, yb, state, batch, S, H, G, st);
  if (P == 64 && N == 64 && Q == 64)
    return launch<64, 64, 64>(xb, x_bs, x_rs, bb, cb, bc_bs, bc_rs, dt, A, D,
                              yb, state, batch, S, H, G, st);
  if (P == 16 && N == 16 && Q == 16)
    return launch<16, 16, 16>(xb, x_bs, x_rs, bb, cb, bc_bs, bc_rs, dt, A, D,
                              yb, state, batch, S, H, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
