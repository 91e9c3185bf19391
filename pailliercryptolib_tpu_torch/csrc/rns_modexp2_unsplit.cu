// K5's tensor-core kernel in the narrow layout's one half (rns_modexp2_tc.cuh,
// LAYOUT 3, tc::Narrow1): all ten warps of a CTA on all 72 rows of a cluster,
// the form before the narrow layout ran two halves out of step.  Compiled
// only to time it beside the library's form and to hold the two equal
// (ops/cuda_rns2.rns_modexp2_unsplit, chip_smoke.py); nothing of the library
// launches it.  Sets of the narrow layout only.  A translation unit of its
// own, so that the two forms build side by side.

#include "rns_modexp2_tc.cuh"

using namespace prns;

extern "C" int rns_modexp2_unsplit_launch(const void* base, const void* wins, const void* rowc,
                                          const void* T1, const void* T2, const void* T1a,
                                          const void* Cin, void* tab, void* out, int G, int B,
                                          int L, int NW, int k, int kb, int W, int f32, int lean,
                                          int shared, int base_grouped, void* stream) {
  return k5::launch_tc<true, true>(base, wins, rowc, T1, T2, T1a, Cin, tab, out, G, B, L, NW, k,
                                   kb, W, f32, lean, shared, base_grouped, stream);
}
