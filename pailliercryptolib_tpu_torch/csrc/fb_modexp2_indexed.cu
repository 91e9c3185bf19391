// K2's tensor-core kernel in its indexed form (fb_modexp2_tc.cuh, CT = false):
// the table entry a byte names is loaded at an address that takes the byte,
// as before the gather was made independent of secrets.  Compiled only to
// time it beside the library's one-hot form (ops/cuda_rns2.fb_modexp2_indexed,
// chip_smoke.py); nothing of the library launches it.  A translation unit of
// its own, so that the two forms build side by side.

#include "fb_modexp2_tc.cuh"

using namespace prns;

// tab: [NP][256][k + kb] words (ops/cuda_rns2.fb_indexed_table).
extern "C" int fb_modexp2_indexed_launch(const void* tab, const void* wins, const void* rowc,
                                         const void* T1, const void* T2, const void* T1a,
                                         void* out, int B,
                                         int NP, int mont_out, int k, int kb, int W, int f32,
                                         int lean, void* stream) {
  return k2::launch_tc<false>(tab, wins, rowc, T1, T2, T1a, out, B, NP, mont_out, k, kb, W,
                              f32, lean, stream);
}
