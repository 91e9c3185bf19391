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
//
// Two kernels live here.  fb_modexp2_tc_kernel runs the same walk on the
// tensor-core product of rns_mont_mul_tc.cuh (a cluster of four CTAs shares
// 72 rows; the extension weights stay in shared memory for the whole launch)
// and serves every one-system set of up to 320 lanes (n^2 of keys up to 2048
// bits, either reduction flavor).  fb_modexp2_kernel, the CUDA-core form,
// serves the wider sets (n^2 of 3072- and 4096-bit keys, 480 / 640 lanes); its
// 320-lane instance stays compiled so that the two forms can be timed side by
// side (chip_smoke.py), and nothing of the library launches it there.  The
// wrapper (ops/cuda_rns2.fb_modexp2) picks the form from the constant set.

#include "rns_mont_mul.cuh"
#include "rns_mont_mul_tc.cuh"

using namespace prns;
namespace cg = cooperative_groups;

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
// The tensor-core form: thread (g, t) of warp w owns lanes j0 + 4 nl (nl < NL)
// and rows g + 8 mt of its cluster's 72.  The gathered table row is the same
// indexed load.

template <bool F32, bool LEAN>
__global__ void __cluster_dims__(tc::CLUSTER, 1, 1) __launch_bounds__(tc::MAX_THREADS, 1)
fb_modexp2_tc_kernel(const int* __restrict__ tab, const uint8_t* __restrict__ wins,
                     const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                     const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                     int* __restrict__ out, int B, int NP,
                     int mont_out, tc::Dims d) {
  const tc::Smem s = tc::carve();
  const tc::Place p = tc::place(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  constexpr int MT = tc::MT, NL = tc::NL;
  const int row0 = (blockIdx.x / tc::CLUSTER) * tc::ROWS + p.g;  // + 8 mt
  const int Wt = d.k + d.kb;
  uint32_t accA[NL][MT], accB[NL][MT];
  // operand of step i for (lane nl, row 8 mt + g): the table entry the row's
  // byte selects, or (1, w) to leave the Montgomery domain
  auto operand = [&](int i, int nl, int mt, uint32_t& ya, uint32_t& yb) {
    const int j = p.j0 + 4 * nl, row = row0 + 8 * mt;
    if (i < NP) {
      int w = row < B ? (int)__ldg(&wins[(size_t)row * NP + i]) : 0;
      const int* e = tab + ((size_t)i * 256 + w) * Wt;
      ya = j < d.k ? (uint32_t)__ldg(&e[j]) : 0u;
      yb = j < d.kb ? (uint32_t)__ldg(&e[d.k + j]) : 0u;
    } else {
      ya = 1u;
      yb = tc::lane_const(s, p, R_PONEB, nl);
    }
  };
#pragma unroll
  for (int nl = 0; nl < NL; ++nl)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) operand(0, nl, mt, accA[nl][mt], accB[nl][mt]);
  const int nsteps = mont_out ? NP : NP + 1;
  for (int i = 1; i < nsteps; ++i)
    tc::mont_mul2<F32, LEAN, 1>(s, d, p, rowc, accA, accB,
                                [&](int nl, int mt, uint32_t& ya, uint32_t& yb) {
                                  operand(i, nl, mt, ya, yb);
                                });
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = tc::lane_const(s, p, R_WINV, nl);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int row = row0 + 8 * mt;
      if (row < B) {
        if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[nl][mt];
        if (j < d.kb)
          out[(size_t)row * Wt + d.k + j] = (int)tc::mulmod_b<F32>(s, p, nl, accB[nl][mt], winv);
      }
    }
  }
}

// T1, T2: [4][KC][W/16][32][2] words of B fragments, T1a: [KC][2][32][2], T1's
// alpha columns (ops/cuda_rns2._tc_pack).
extern "C" int fb_modexp2_tc_launch(const void* tab, const void* wins, const void* rowc,
                                    const void* T1, const void* T2, const void* T1a,
                                    void* out, int B,
                                    int NP, int mont_out, int k, int kb, int W, int f32,
                                    int lean, void* stream) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  if (!tc::dims_fit(d, 1) || B <= 0) return (int)cudaErrorInvalidValue;
  const int smem = tc::SMEM_BYTES;
  const int clusters = (B + tc::ROWS - 1) / tc::ROWS;
#define PRNS_LAUNCH(F, LN)                                                              \
  do {                                                                                  \
    cudaError_t err = cudaFuncSetAttribute(                                             \
        fb_modexp2_tc_kernel<F, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (err != cudaSuccess) return (int)err;                                            \
    fb_modexp2_tc_kernel<F, LN><<<clusters * tc::CLUSTER, tc::threads(d), smem,         \
                                  (cudaStream_t)stream>>>(                              \
        (const int*)tab, (const uint8_t*)wins, (const uint32_t*)rowc,                   \
        (const uint32_t*)T1, (const uint32_t*)T2, (const uint32_t*)T1a, (int*)out, B, NP, \
        mont_out, d);                                                                   \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
  return (int)cudaGetLastError();
}
