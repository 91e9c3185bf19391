// K1 — fixed-base table build: for every window position i, the 256 powers
// g_i^j (j = 0..255) in RNS Montgomery form, canonical residues.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_fb_table2 /
// _fb_table2_kernel, which walks j as a sequential grid axis with the
// running power in scratch memory.
//
// On this card: thread blocks run in no order, so the j walk is a loop
// inside the block that owns a few window positions; the running power
// lives in registers.  The walk is the reference's chain, acc_0 = one,
// acc_{j+1} = mont(acc_j, g_i): canonical residues do not make a value's
// representative unique (it may lie anywhere below 3N), so a doubling or
// tree schedule would give other tables than pallas_fb_table2's.  The only
// parallelism is the NP window positions, and the kernel is bound by the
// latency of one product times 255, not by throughput; it runs once per key.
// Output layout [256][NP][k] and [256][NP][k+1], as the reference's.
// Compiled for every form of a one-system constant set; the table entries
// are canonical in the f32 flavor too, since K2 splits them into 7-bit
// digits when they are used.
//
// Two kernels live here.  fb_table2_tc_kernel, the one the wrapper
// (ops/cuda_rns2.fb_table2) launches, runs the chain on the tensor-core
// product of rns_mont_mul_tc.cuh (CANON: canonical r_A) in a layout of few
// m-tiles a cluster, so that NP positions spread over many clusters and each
// product is short: K1Narrow / K1Wide below.  fb_table2_kernel, the
// CUDA-core form (NP / 8 blocks on rns_mont_mul.cuh), stays compiled only so
// that the two can be timed side by side (ops/cuda_rns2.fb_table2_dp4a,
// chip_smoke.py).

#include "rns_mont_mul.cuh"
#include "rns_mont_mul_tc.cuh"

using namespace prns;
namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The tensor-core form.  Thread (g, t) of warp w owns lanes j0 + 4 nl of the
// set and window positions g + 8 mt of its cluster's ROWS; the operand g_i
// is read where the product uses it (L1 serves it after the first step).
// The kernel is a template on the parameters of its layout, tc::Layout<C,
// MT, MW, MG, WS>; the library compiles two (the candidates and their times:
// PERF.md, tools/k1_forms.py):

// sets of up to 320 lanes: a cluster of four, the weights in its shared memory
using K1Narrow = tc::Layout<4, 1, 320, 1>;
// up to 640: a cluster of eight, the weights read from L2
using K1Wide = tc::Layout<8, 3, 640, 3, false>;

template <int C, int MT, int MW, int MG, bool WS, bool F32, bool LEAN>
__global__ void __launch_bounds__(4 * MW / C, 1)
fb_table2_tc_kernel(const int* __restrict__ gA, const int* __restrict__ gB,
                    const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                    const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                    int* __restrict__ tabA, int* __restrict__ tabB, int NP, int ntab,
                    tc::Dims d) {
  using TL = tc::Layout<C, MT, MW, MG, WS>;
  constexpr int NL = TL::NL;
  const tc::Smem<TL> s = tc::carve<TL>(d, T1, T2);
  tc::Place<TL> p = tc::place<TL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  const int row0 = (blockIdx.x / C) * TL::ROWS + p.g;  // + 8 mt
  uint32_t accA[NL][MT], accB[NL][MT];
#pragma unroll
  for (int nl = 0; nl < NL; ++nl)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      accA[nl][mt] = tc::lane_const(s, p, R_ONEA, nl);
      accB[nl][mt] = tc::lane_const(s, p, R_ONEB, nl);
    }
  for (int t = 0; t < ntab; ++t) {
#pragma unroll
    for (int nl = 0; nl < NL; ++nl) {
      const int j = p.j0 + 4 * nl;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = row0 + 8 * mt;
        if (row < NP) {
          if (j < d.k) tabA[((size_t)t * NP + row) * d.k + j] = (int)accA[nl][mt];
          if (j < d.kb) tabB[((size_t)t * NP + row) * d.kb + j] = (int)accB[nl][mt];
        }
      }
    }
    if (t + 1 < ntab)
      tc::mont_mul2<F32, LEAN, 1, true>(
          s, d, p, rowc, accA, accB, [&](int nl, int mt, uint32_t& ya, uint32_t& yb) {
            const int j = p.j0 + 4 * nl, row = row0 + 8 * mt;
            const bool ok = row < NP;
            ya = ok && j < d.k ? (uint32_t)__ldg(&gA[(size_t)row * d.k + j]) : 0u;
            yb = ok && j < d.kb ? (uint32_t)__ldg(&gB[(size_t)row * d.kb + j]) : 0u;
          });
  }
}

// The instance of layout L, form (F32, LEAN); one launch of it, and how many
// of its clusters the card holds at once (-1 if the set does not fit L).
template <class L, bool F32, bool LEAN>
static auto fb_table2_tc_instance() {
  static_assert(L::HALVES == 1, "K1's chain runs its rows in one half");
  return fb_table2_tc_kernel<L::CLUSTER, L::MT, L::MAX_W, L::MT_GROUP, L::WT_SMEM, F32, LEAN>;
}

template <class L, bool F32, bool LEAN>
static cudaError_t fb_table2_tc_run(const void* gA, const void* gB, const void* rowc,
                                    const void* T1, const void* T2, const void* T1a,
                                    void* tabA, void* tabB, int NP, int ntab,
                                    const tc::Dims& d, cudaStream_t st) {
  if (!tc::dims_fit<L>(d, 1) || NP <= 0) return cudaErrorInvalidValue;
  return tc::launch_clusters<L>(fb_table2_tc_instance<L, F32, LEAN>(),
                                (NP + L::ROWS - 1) / L::ROWS, d, st, (const int*)gA,
                                (const int*)gB, (const uint32_t*)rowc, (const uint32_t*)T1,
                                (const uint32_t*)T2, (const uint32_t*)T1a, (int*)tabA,
                                (int*)tabB, NP, ntab, d);
}

template <class L, bool F32, bool LEAN>
static int fb_table2_tc_clusters(const tc::Dims& d) {
  return tc::dims_fit<L>(d, 1)
             ? tc::max_active_clusters<L>(fb_table2_tc_instance<L, F32, LEAN>(), d)
             : -1;
}

// gA [NP][k], gB [NP][kb]; T1, T2 [CLUSTER][KC][W/(4 CLUSTER)][32][2] words
// of B fragments, T1a [KC][2][32][2] (ops/cuda_rns2._tc_pack); tabA
// [ntab][NP][k], tabB [ntab][NP][kb].  A set takes K1Narrow if it fits, else
// K1Wide.
extern "C" int fb_table2_tc_launch(const void* gA, const void* gB, const void* rowc,
                                   const void* T1, const void* T2, const void* T1a,
                                   void* tabA, void* tabB, int NP, int ntab, int k, int kb,
                                   int W, int f32, int lean, void* stream) {
  const tc::Dims d{k, kb, W, (k + 31) / 32};
  const bool narrow = tc::dims_fit<K1Narrow>(d, 1);
#define PRNS_LAUNCH(F, LN)                                                                  \
  return (int)(narrow ? fb_table2_tc_run<K1Narrow, F, LN>(gA, gB, rowc, T1, T2, T1a, tabA, \
                                                          tabB, NP, ntab, d,              \
                                                          (cudaStream_t)stream)           \
                      : fb_table2_tc_run<K1Wide, F, LN>(gA, gB, rowc, T1, T2, T1a, tabA,   \
                                                        tabB, NP, ntab, d,                \
                                                        (cudaStream_t)stream))
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int fb_table2_tc_max_clusters(int k, int kb, int W, int f32, int lean) {
  const tc::Dims d{k, kb, W, (k + 31) / 32};
  const bool narrow = tc::dims_fit<K1Narrow>(d, 1);
  if (lean && !f32) return -1;
#define PRNS_QUERY(F, LN)                                                  \
  return narrow ? fb_table2_tc_clusters<K1Narrow, F, LN>(d)                \
                : fb_table2_tc_clusters<K1Wide, F, LN>(d)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_QUERY);
#undef PRNS_QUERY
  return -1;
}
