// K1 — fixed-base table build: for every window position i, the 256 powers
// g_i^j (j = 0..255) in RNS Montgomery form, canonical residues.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_fb_table2 /
// _fb_table2_kernel, which walks j as a sequential grid axis with the
// running power in scratch memory.
//
// On this card: thread blocks run in no order, so the j walk is a loop
// inside the block that owns ROWS window positions; the running power lives
// in registers.  Bound by integer issue (255 Montgomery products per
// position, two base extensions each); it runs once per key, on
// NP / ROWS blocks, so it is nowhere near filling the card — acceptable for
// a set-up step.  Output layout [256][NP][k] and [256][NP][k+1], as the
// reference's.  Compiled for every form of a one-system constant set
// (rns_mont_mul.cuh); the table entries are canonical in the f32 flavor too,
// since they are split into 7-bit digits when they are used.

#include "rns_mont_mul.cuh"

using namespace prns;

template <bool F32, bool LEAN>
__global__ void __launch_bounds__(MAX_THREADS)
fb_table2_kernel(const int* __restrict__ gA, const int* __restrict__ gB,
                 const uint32_t* __restrict__ rowc, const int2* __restrict__ T1,
                 const int2* __restrict__ T2, int* __restrict__ tabA,
                 int* __restrict__ tabB, int NP, int ntab, Dims d) {
  __shared__ Scratch<ROWS> s;
  const int j = threadIdx.x;
  const Lane c = load_lane(rowc, d.W, j);
  const int row0 = blockIdx.x * ROWS;
  uint32_t accA[ROWS], accB[ROWS], yA[ROWS], yB[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int row = row0 + r;
    bool ok = row < NP;
    accA[r] = rowc[R_ONEA * d.W + j];
    accB[r] = rowc[R_ONEB * d.W + j];
    yA[r] = (ok && j < d.k) ? (uint32_t)gA[row * d.k + j] : 0u;
    yB[r] = (ok && j < d.kb) ? (uint32_t)gB[row * d.kb + j] : 0u;
  }
  for (int t = 0; t < ntab; ++t) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      int row = row0 + r;
      if (row < NP) {
        if (j < d.k) tabA[((size_t)t * NP + row) * d.k + j] = (int)accA[r];
        if (j < d.kb) tabB[((size_t)t * NP + row) * d.kb + j] = (int)accB[r];
      }
    }
    if (t < ntab - 1)
      mont_mul2<F32, LEAN, ROWS, 1, true>(c, d, s, rowc, T1, T2, accA, accB, yA, yB,
                                                accA, accB);
  }
}

extern "C" int fb_table2_launch(const void* gA, const void* gB, const void* rowc,
                                const void* T1, const void* T2, void* tabA,
                                void* tabB, int NP, int ntab, int k, int kb,
                                int W, int f32, int lean, void* stream) {
  Dims d{k, kb, (k + 3) / 4, W};
  if (!dims_fit(d) || kb + 1 > W) return (int)cudaErrorInvalidValue;
  int blocks = (NP + ROWS - 1) / ROWS;
#define PRNS_LAUNCH(F, LN)                                                          \
  fb_table2_kernel<F, LN><<<blocks, W, 0, (cudaStream_t)stream>>>(              \
      (const int*)gA, (const int*)gB, (const uint32_t*)rowc, (const int2*)T1,       \
      (const int2*)T2, (int*)tabA, (int*)tabB, NP, ntab, d)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
  return (int)cudaGetLastError();
}
