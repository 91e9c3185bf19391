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
// Two kernels live here.  fb_modexp2_tc_kernel, the one the wrapper
// (ops/cuda_rns2.fb_modexp2) launches, runs the same walk on the tensor-core
// product of rns_mont_mul_tc.cuh on every one-system set of up to 640 lanes:
// the narrow layout up to 320 (n^2 of keys up to 2048 bits: a cluster of four
// CTAs shares 72 rows, the extension weights in its shared memory for the
// whole launch), the wide one beyond (n^2 of 3072- and 4096-bit keys, 480
// lanes padded to 512, and 640: a cluster of eight, 72 rows, the ~1.6 MB of
// weight fragments read from L2 once an extension, all nine m-tiles in
// flight).  What the wide form reads: per step i, each row's entry of
// tab[i] (at 4096 bits 256 x 1275 words = 1.3 MB a step, which L2 holds
// beside the weights, though the whole 334 MB table does not), by the same
// indexed load as the narrow form; the constant-time question above is
// unchanged by it.  fb_modexp2_kernel, the CUDA-core form, stays compiled only
// so that the two can be timed side by side (ops/cuda_rns2.fb_modexp2_dp4a,
// chip_smoke.py); nothing of the library launches it.

#include <type_traits>

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
// indexed load.  One kernel template for two layouts (rns_mont_mul_tc.cuh),
// launched with its cluster size as a launch attribute: LAYOUT 0, narrow
// (sets of up to 320 lanes, a cluster of four, the extension weights in its
// shared memory), 1, wide (up to 640, a cluster of eight, the weights read
// from L2 once an extension).

template <int LAYOUT>
using FbLayout = typename std::conditional<LAYOUT == 1, tc::Wide, tc::Narrow>::type;

template <int LAYOUT, bool F32, bool LEAN>
__global__ void __launch_bounds__(FbLayout<LAYOUT>::MAX_THREADS, 1)
fb_modexp2_tc_kernel(const int* __restrict__ tab, const uint8_t* __restrict__ wins,
                     const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                     const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                     int* __restrict__ out, int B, int NP,
                     int mont_out, tc::Dims d) {
  using TcL = FbLayout<LAYOUT>;
  const tc::Smem<TcL> s = tc::carve<TcL>(d, T1, T2);
  const tc::Place<TcL> p = tc::place<TcL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  constexpr int MT = TcL::MT, NL = TcL::NL;
  const int row0 = (blockIdx.x / TcL::CLUSTER) * TcL::ROWS + p.g;  // + 8 mt
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

// The layout a set takes: narrow, else wide, else -1.
static int fb_tc_layout(const tc::Dims& d) {
  if (tc::dims_fit<tc::Narrow>(d, 1)) return 0;
  if (tc::dims_fit<tc::Wide>(d, 1)) return 1;
  return -1;
}

// T1, T2: [CLUSTER][KC][W/(4 CLUSTER)][32][2] words of B fragments, T1a:
// [KC][2][32][2], T1's alpha columns (ops/cuda_rns2._tc_pack).
extern "C" int fb_modexp2_tc_launch(const void* tab, const void* wins, const void* rowc,
                                    const void* T1, const void* T2, const void* T1a,
                                    void* out, int B,
                                    int NP, int mont_out, int k, int kb, int W, int f32,
                                    int lean, void* stream) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = fb_tc_layout(d);
  if (layout < 0 || B <= 0) return (int)cudaErrorInvalidValue;
#define PRNS_LAUNCH_L(LY, F, LN)                                                          \
  do {                                                                                    \
    using TL = FbLayout<LY>;                                                              \
    cudaError_t err = tc::launch_clusters<TL>(                                            \
        fb_modexp2_tc_kernel<LY, F, LN>, (B + TL::ROWS - 1) / TL::ROWS, d,                \
        (cudaStream_t)stream, (const int*)tab, (const uint8_t*)wins, (const uint32_t*)rowc, \
        (const uint32_t*)T1, (const uint32_t*)T2, (const uint32_t*)T1a, (int*)out, B, NP,   \
        mont_out, d);                                                                     \
    if (err != cudaSuccess) return (int)err;                                              \
  } while (0)
#define PRNS_LAUNCH(F, LN)                  \
  do {                                      \
    if (layout == 1) PRNS_LAUNCH_L(1, F, LN); \
    else PRNS_LAUNCH_L(0, F, LN);           \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
#undef PRNS_LAUNCH_L
  return 0;
}

// How many clusters of the tensor-core K2 (the layout and form of the set)
// the card holds at once; -1 if none is compiled for it.
extern "C" int fb_modexp2_tc_max_clusters(int k, int kb, int W, int f32, int lean) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = fb_tc_layout(d);
  if (layout < 0 || (lean && !f32)) return -1;
  int n = -1;
#define PRNS_QUERY(F, LN)                                                                      \
  do {                                                                                         \
    n = layout == 1 ? tc::max_active_clusters<FbLayout<1>>(fb_modexp2_tc_kernel<1, F, LN>, d) \
                    : tc::max_active_clusters<FbLayout<0>>(fb_modexp2_tc_kernel<0, F, LN>, d); \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_QUERY);
#undef PRNS_QUERY
  return n;
}
