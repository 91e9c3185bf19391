// K5's tensor-core kernel in its indexed form (rns_modexp2_tc.cuh, CT = false):
// the entry a window names is loaded at an address that takes the window, as
// before the select was made independent of secrets.  Compiled only to time
// it beside the library's form (ops/cuda_rns2.rns_modexp2_indexed,
// chip_smoke.py); nothing of the library launches it.  A translation unit of
// its own, so that the two forms build side by side.

#include "rns_modexp2_tc.cuh"

using namespace prns;

extern "C" int rns_modexp2_indexed_launch(const void* base, const void* wins, const void* rowc,
                                          const void* T1, const void* T2, const void* T1a,
                                          const void* Cin, void* tab, void* out, int G, int B,
                                          int L, int NW, int k, int kb, int W, int f32, int lean,
                                          int shared, int base_grouped, void* stream) {
  return k5::launch_tc<false>(base, wins, rowc, T1, T2, T1a, Cin, tab, out, G, B, L, NW, k, kb,
                              W, f32, lean, shared, base_grouped, stream);
}
