// Batched survival curves, the scoring hot path:
//
//   S[b, g] = exp(-H0[g] * exp(clip(eta[b], -30, 30)))
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/survival_curves.py::_curves_kernel (pallas_call in
// _survival_curves_jit), which forms the (b, g) outer product on the MXU and
// fuses the exp so the panel reaches HBM once.
//
// The kernel is curves.cuh's panel with a single baseline (s = 1, no strata
// read): each lane holds its columns of H0 in registers for every row it
// writes. That header says what bounds it on an H100 (bytes, and at the
// scoring sizes the launch) and how the design answers.
#include <cuda_runtime.h>

#include "curves.cuh"

extern "C" {

// out (b, g) row-major from eta (b,) and h0 (g,), by the launch plan of
// kernels/survival_curves.py::plan (blocks, slab, vec, tail).
int repro_survival_curves(const float* eta, const float* h0, int b, int g,
                          int blocks, int slab, int vec, int tail, float* out,
                          void* stream) {
  return static_cast<int>(repro::curves::launch<false>(
      eta, h0, nullptr, b, g, 1, blocks, slab, vec, tail, 0, out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
