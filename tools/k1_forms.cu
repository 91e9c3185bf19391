// The measurement behind K1's layout (csrc/fb_table2.cu, fb_table2_tc_kernel),
// built and run by tools/k1_forms.py on one GPU: the library's kernel in
// candidate layouts of the tensor-core product (rns_mont_mul_tc.cuh), by
// index:
//
//   0  <4, 1, 320, 1>         the library's K1Narrow   sets of up to 320 lanes
//   2  <4, 9, 320, 3>         tc::Narrow1 (K2; K3, K5 before their two halves)
//   3  <4, 3, 320, 3>
//   4  <8, 1, 320, 1>         a cluster of eight, 40 lanes a CTA
//   1  <8, 3, 640, 3, false>  the library's K1Wide     sets of up to 640 lanes
//   5  <8, 9, 640, 9, false>  tc::Wide (K2, K5)
//   6  <8, 1, 640, 1, false>
//
// in the one form each width takes on the paths: integer Barrett up to 320
// lanes (n^2 of a 2048-bit key), the f32 reduction with the full fold at 640
// (n^2 of a 4096-bit key).
//
// Not part of the library: nothing in the package loads it.

#include "../pailliercryptolib_tpu_torch/csrc/fb_table2.cu"

using K1Narrow3 = tc::Layout<4, 3, 320, 3>;
using K1Cluster8 = tc::Layout<8, 1, 320, 1>;
using K1Wide1 = tc::Layout<8, 1, 640, 1, false>;

// index -> (layout, f32 reduction)
#define K1FORMS_EACH(X) \
  X(0, K1Narrow, false) \
  X(2, tc::Narrow1, false) \
  X(3, K1Narrow3, false) \
  X(4, K1Cluster8, false) \
  X(1, K1Wide, true) \
  X(5, tc::Wide, true) \
  X(6, K1Wide1, true)

extern "C" int k1_forms_launch(int ly, const void* gA, const void* gB, const void* rowc,
                               const void* T1, const void* T2, const void* T1a, void* tabA,
                               void* tabB, int NP, int ntab, int k, int kb, int W,
                               void* stream) {
  const tc::Dims d{k, kb, W, (k + 31) / 32};
  switch (ly) {
#define K1FORMS_CASE(LY, LT, F)                                                            \
  case LY:                                                                                 \
    return (int)fb_table2_tc_run<LT, F, false>(gA, gB, rowc, T1, T2, T1a, tabA, tabB, NP, \
                                               ntab, d, (cudaStream_t)stream);
    K1FORMS_EACH(K1FORMS_CASE)
#undef K1FORMS_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int k1_forms_max_clusters(int ly, int k, int kb, int W) {
  const tc::Dims d{k, kb, W, (k + 31) / 32};
  switch (ly) {
#define K1FORMS_CASE(LY, LT, F) \
  case LY:                      \
    return fb_table2_tc_clusters<LT, F, false>(d);
    K1FORMS_EACH(K1FORMS_CASE)
#undef K1FORMS_CASE
  }
  return -1;
}

// Dynamic shared memory of a CTA of layout ly.
extern "C" int k1_forms_smem_bytes(int ly) {
  switch (ly) {
#define K1FORMS_CASE(LY, LT, F) \
  case LY:                      \
    return LT::SMEM_BYTES;
    K1FORMS_EACH(K1FORMS_CASE)
#undef K1FORMS_CASE
  }
  return -1;
}
