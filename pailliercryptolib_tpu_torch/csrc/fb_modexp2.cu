// K2 — fixed-base modexp: base^e from exponent bytes through the per-key
// table: per byte one table row and one RNS Montgomery product into the
// accumulator.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_fb_modexp2 /
// _fb_modexp2_body, which walks the bytes as a sequential grid axis and
// gathers the table row with a one-hot [rows x 256] int8 matrix product,
// which reads the whole table slice of a step whatever the byte.
//
// On this card: the byte walk is a loop inside the block that owns its batch
// rows (accumulator in registers).  The bytes are those of the DJN obfuscator
// exponent r: whoever learns hs^r learns m from the ciphertext, so the gather
// must not read the table at an address that takes a byte.  The library's
// form (fb_modexp2_tc.cuh, CT = true) is the reference's one-hot product on
// the int8 tensor cores: per step, onehot [rows x 256] . planes [256 x lanes]
// over the 7-bit digit planes of the step's table slice, which every CTA reads
// whole for its lanes, whatever the bytes.  Bound by integer issue (NP - 1
// Montgomery products per row); the one-hot product adds 2 x 256 x 2 planes
// int8 operations a (row, lane) and step, and its planes, 1024 x W bytes a
// step, are served by L2.
//
// Compiled for every form of a one-system constant set (rns_mont_mul.cuh).
// For a 4096-bit key (randbits 2048, k = 637) the planes are 256 positions x
// 2 sides x 2 planes x 256 entries x 640 lanes = 168 MB (the indexed table of
// int32 words was 334 MB): they live in device memory, and a step's slice
// (656 KB) is what L2 serves.
//
// mont_out = 1 leaves the accumulator in Montgomery form (<= 3N) and only
// unscales the B lanes; mont_out = 0 multiplies by plain 1 first (<= 2N).
//
// Three kernels live here.  fb_modexp2_tc_kernel<..., CT = true>, the one the
// wrapper (ops/cuda_rns2.fb_modexp2) launches, runs the walk on the
// tensor-core product of rns_mont_mul_tc.cuh on every one-system set of up to
// 640 lanes: the narrow layout up to 320 (n^2 of keys up to 2048 bits: a
// cluster of four CTAs shares 72 rows, the extension weights in its shared
// memory for the whole launch), the wide one beyond (n^2 of 3072- and
// 4096-bit keys, 480 lanes padded to 512, and 640: a cluster of eight, 72
// rows, the ~1.6 MB of weight fragments read from L2 once an extension, all
// nine m-tiles in flight).  Its indexed form (CT = false,
// fb_modexp2_indexed.cu) and fb_modexp2_kernel, the CUDA-core form below,
// read the entry a byte names from tab[NP][256][k + kb] words at an address
// that takes the byte; they stay compiled only so that the forms can be timed
// side by side (ops/cuda_rns2.fb_modexp2_indexed / fb_modexp2_dp4a,
// chip_smoke.py); nothing of the library launches them.

#include "fb_modexp2_tc.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core form (fb_modexp2_tc.cuh), the one the library launches: the
// one-hot gather (CT = true).

extern "C" int fb_modexp2_tc_launch(const void* tab, const void* wins, const void* rowc,
                                    const void* T1, const void* T2, const void* T1a,
                                    void* out, int B,
                                    int NP, int mont_out, int k, int kb, int W, int f32,
                                    int lean, void* stream) {
  return k2::launch_tc<true>(tab, wins, rowc, T1, T2, T1a, out, B, NP, mont_out, k, kb, W, f32,
                             lean, stream);
}

// How many clusters of the tensor-core K2 (the library's form; the layout and
// form of the set) the card holds at once; -1 if none is compiled for it.
extern "C" int fb_modexp2_tc_max_clusters(int k, int kb, int W, int f32, int lean) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = k2::fb_tc_layout(d);
  if (layout < 0 || (lean && !f32)) return -1;
  int n = -1;
#define PRNS_QUERY(F, LN)                                                                  \
  do {                                                                                     \
    n = layout == 1                                                                        \
            ? tc::max_active_clusters<k2::FbLayout<1>>(k2::fb_modexp2_tc_kernel<1, F, LN, true>, d) \
            : tc::max_active_clusters<k2::FbLayout<0>>(k2::fb_modexp2_tc_kernel<0, F, LN, true>, d); \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_QUERY);
#undef PRNS_QUERY
  return n;
}
