// Batched survival curves with a baseline per request (stratified models):
//
//   S[b, g] = exp(-H0[strata[b], g] * exp(clip(eta[b], -30, 30)))
//
// Replaces the Pallas TPU kernel src/repro/kernels/survival_curves.py::
// _curves_strat_kernel (pallas_call in _survival_curves_strat_jit). There
// the strata vector rides ahead of the grid by scalar prefetch and picks
// which baseline row each grid step copies in, so no (b, g) gathered copy
// of the baselines is ever formed. Here a warp loads its rows' strata with
// their eta in one coalesced load and hands each row's stratum on by a
// shuffle; the gather is an address into the (s, g) table, which a block
// stages in shared memory when it has at most kStagedStrata strata, and
// otherwise reads through the read-only path.
//
// The kernel is curves.cuh's panel with strata; that header says what
// bounds it on an H100 (bytes, and at the scoring sizes the launch) and how
// the design answers. Strata are not range-checked here; the engine checks
// them on the host.
#include <cuda_runtime.h>

#include "curves.cuh"

extern "C" {

// out (b, g) row-major from eta (b,), h0 (s, g) row-major and strata (b,),
// by the launch plan of kernels/survival_curves.py::plan (blocks, slab,
// vec, tail, staged).
int repro_survival_curves_stratified(const float* eta, const float* h0,
                                     const int* strata, int b, int g, int s,
                                     int blocks, int slab, int vec, int tail,
                                     int staged, float* out, void* stream) {
  return static_cast<int>(repro::curves::launch<true>(
      eta, h0, strata, b, g, s, blocks, slab, vec, tail, staged, out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
