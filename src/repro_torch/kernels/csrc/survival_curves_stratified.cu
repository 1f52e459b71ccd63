// Batched survival curves with a baseline per request (stratified models):
//
//   S[b, g] = exp(-H0[strata[b], g] * exp(clip(eta[b], -30, 30)))
//
// Replaces the Pallas TPU kernel src/repro/kernels/survival_curves.py::
// _curves_strat_kernel (pallas_call in _survival_curves_strat_jit). There
// the strata vector rides ahead of the grid by scalar prefetch and picks
// which baseline row each grid step copies in, so no (b, g) gathered copy
// of the baselines is ever formed. Here a block loads its row's stratum
// itself and every thread reads H0[strata[b], g] directly: the gather is an
// address, not a tensor.
//
// What bounds it on an H100: bytes. The panel is written once (4 b g
// bytes; 2.1 MB at b = 4,096, g = 128, 0.63 us) for two exps and a multiply
// an element; eta, strata and the (s, g) table (a few KB, held in L2) are
// read once. The layout is survival_curves.cu's: one thread per element, a
// 2-D grid (rows of the batch on x, 128-wide slices of the grid on y),
// neighbouring threads on neighbouring output addresses. Strata are not
// range-checked here; the engine checks them on the host.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
curves_strat_kernel(const float* __restrict__ eta,
                    const float* __restrict__ h0,
                    const int* __restrict__ strata, int g,
                    float* __restrict__ out) {
  const int row = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= g) return;
  const float e = fminf(fmaxf(eta[row], -30.f), 30.f);
  const float h = h0[static_cast<size_t>(strata[row]) * g + col];
  out[static_cast<size_t>(row) * g + col] = expf(-(h * expf(e)));
}

}  // namespace

extern "C" {

// out (b, g) row-major from eta (b,), h0 (s, g) row-major and strata (b,).
int repro_survival_curves_stratified(const float* eta, const float* h0,
                                     const int* strata, int b, int g,
                                     float* out, void* stream) {
  if (b <= 0 || g <= 0 || g > 65535 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (g + kThreads - 1) / kThreads);
  curves_strat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      eta, h0, strata, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
