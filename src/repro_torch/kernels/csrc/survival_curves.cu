// Batched survival curves, the scoring hot path:
//
//   S[b, g] = exp(-H0[g] * exp(clip(eta[b], -30, 30)))
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/survival_curves.py::_curves_kernel (pallas_call in
// _survival_curves_jit), which forms the (b, g) outer product on the MXU and
// fuses the exp so the panel reaches HBM once.
//
// What bounds it on an H100: bytes. The panel is written once (4 b g bytes)
// for two exps and a multiply an element, and eta and H0 are read once.
// One thread per element, a 2-D grid (rows of the batch on x, 128-wide
// slices of the grid on y), neighbouring threads on neighbouring output
// addresses, so every warp store is one 128-byte line and nothing but the
// panel itself touches device memory in bulk.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
curves_kernel(const float* __restrict__ eta, const float* __restrict__ h0,
              int g, float* __restrict__ out) {
  const int row = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= g) return;
  const float e = fminf(fmaxf(eta[row], -30.f), 30.f);
  out[static_cast<size_t>(row) * g + col] = expf(-(expf(e) * h0[col]));
}

}  // namespace

extern "C" {

// out (b, g) row-major from eta (b,) and h0 (g,).
int repro_survival_curves(const float* eta, const float* h0, int b, int g,
                          float* out, void* stream) {
  if (b <= 0 || g <= 0 || g > 65535 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (g + kThreads - 1) / kThreads);
  curves_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      eta, h0, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
