// K2 — fixed-base modexp: base^e from exponent bytes through the per-key
// table: per byte one table row and one RNS Montgomery product into the
// accumulator.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_fb_modexp2 /
// _fb_modexp2_body, which walks the bytes as a sequential grid axis and
// gathers the table row with a one-hot [rows x 256] int8 matrix product
// (the TPU has no gather).
//
// On this card: the byte walk is a loop inside the block that owns ROWS
// batch rows (accumulator in registers), and the gather is a plain indexed
// load from a table stored as one 32-bit word per residue,
// tab[NP][256][k + kb]; the int8 lo/hi planes of the reference are not
// needed.  NOTE: the load address depends on the exponent byte, which is
// secret (the obfuscator r); the reference's one-hot product reads the whole
// table whatever the byte.  A constant-time form is an open decision
// recorded in ROADMAP.md.  Bound by integer issue (NP - 1 Montgomery
// products per row); the gathered rows are ~1.2 KB each and served by L2/HBM
// at a small fraction of the arithmetic time.
//
// Compiled for every form of a one-system constant set (rns_mont_mul.cuh).
// For a 4096-bit key (randbits 2048, k = 637) the table is 256 positions x
// 256 entries x 1275 words = 334 MB: it lives in device memory, and the rows
// a batch gathers no longer fit L2.
//
// mont_out = 1 leaves the accumulator in Montgomery form (<= 3N) and only
// unscales the B lanes; mont_out = 0 multiplies by plain 1 first (<= 2N).

#include "rns_mont_mul.cuh"

using namespace prns;

template <bool F32, bool LEAN>
__global__ void __launch_bounds__(MAX_THREADS)
fb_modexp2_kernel(const int* __restrict__ tab, const uint8_t* __restrict__ wins,
                  const uint32_t* __restrict__ rowc, const int2* __restrict__ T1,
                  const int2* __restrict__ T2, int* __restrict__ out, int B, int NP,
                  int mont_out, Dims d) {
  __shared__ Scratch<ROWS> s;
  const int j = threadIdx.x;
  const Lane c = load_lane(rowc, d.W, j);
  const int row0 = blockIdx.x * ROWS;
  const int Wt = d.k + d.kb;
  const uint32_t poneB = rowc[R_PONEB * d.W + j];
  uint32_t accA[ROWS], accB[ROWS], yA[ROWS], yB[ROWS];
  const int nsteps = mont_out ? NP : NP + 1;
  for (int i = 0; i < nsteps; ++i) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      int row = row0 + r;
      if (i < NP) {
        int w = row < B ? (int)wins[(size_t)row * NP + i] : 0;
        const int* e = tab + ((size_t)i * 256 + w) * Wt;
        yA[r] = j < d.k ? (uint32_t)e[j] : 0u;
        yB[r] = j < d.kb ? (uint32_t)e[d.k + j] : 0u;
      } else {  // leave the Montgomery domain: multiply by (1, w)
        yA[r] = 1u;
        yB[r] = poneB;
      }
    }
    if (i == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { accA[r] = yA[r]; accB[r] = yB[r]; }
    } else {
      mont_mul2<F32, LEAN, ROWS, 1>(c, d, s, rowc, T1, T2, accA, accB, yA, yB,
                                          accA, accB);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int row = row0 + r;
    if (row < B) {
      if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[r];
      if (j < d.kb)
        out[(size_t)row * Wt + d.k + j] = (int)mulmod_b<F32>(c, accB[r], c.winv);
    }
  }
}

extern "C" int fb_modexp2_launch(const void* tab, const void* wins, const void* rowc,
                                 const void* T1, const void* T2, void* out, int B,
                                 int NP, int mont_out, int k, int kb, int W,
                                 int f32, int lean, void* stream) {
  Dims d{k, kb, (k + 3) / 4, W};
  if (!dims_fit(d) || kb + 1 > W) return (int)cudaErrorInvalidValue;
  int blocks = (B + ROWS - 1) / ROWS;
#define PRNS_LAUNCH(F, LN)                                                          \
  fb_modexp2_kernel<F, LN><<<blocks, W, 0, (cudaStream_t)stream>>>(             \
      (const int*)tab, (const uint8_t*)wins, (const uint32_t*)rowc, (const int2*)T1, \
      (const int2*)T2, (int*)out, B, NP, mont_out, d)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
  return (int)cudaGetLastError();
}
