// K5 — generic RNS windowed modexp base^e mod N over [G, B, L] batches of
// canonical 15-bit limbs: limbs -> residues through the Cin weights, to
// Montgomery form, a 16-entry power table per row, NW 4-bit windows most
// significant first (four squarings and one table product per window),
// leave Montgomery form, unscale the B lanes.  Output [G, B, k + kb]
// residues (A | B | m_r lanes) of a value <= 2N.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_rns_modexp2 with its
// kernels _modexp2_kernel_shared / _shared_stream_kernel (one exponent per
// group, the same for every row) and _modexp2_kernel_var (one exponent per
// row, the table entry chosen by a 16-way select over the whole table).
// Both are variants of this one kernel (template parameter SHARED).  The
// reference's row-streams overlap its matrix and vector units and have no
// counterpart here; the result does not depend on them.
//
// On this card: G is blockIdx.y, which selects the constant set (rowc, T1,
// T2, Cin, windows, table scratch and output all carry a leading group
// axis); each block runs one residue system on its lanes (G = 1 form of the
// device function), in the integer-Barrett flavor (one system over n^2:
// normal-mode encrypt, apply_obfuscator, CT*PT, RAW decrypt) or the
// f32-reciprocal lean flavor (the stacked p^2 / q^2 pair of a grouped CRT
// decrypt, the layout of 3072- and 4096-bit keys), or the f32 flavor with the
// full fold on up to 640 lanes (one system over n^2 of such a key; every
// form of rns_mont_mul.cuh is compiled).  With base_gstride = 0 every group reads the same base rows
// (the CRT decrypt feeds the full n^2-width ciphertext to both groups).
// As in the CRT-folded kernel one row's table is 16 x (k + kb) words
// (38.9 KB over n^2 of a 2048-bit key, 81.6 KB of a 4096-bit key), too large
// for shared memory: it lives in global scratch the wrapper allocates
// ([G][B][16][2][W] words), written and read by the same thread per lane and
// served by L2 (at 2048 rows of a 4096-bit key's n^2 it is 168 MB and L2 no
// longer holds it).  Bound by
// the integer instruction rate: 15 + 5*NW + 1 Montgomery products per row
// (2576 for the exponent n of a 2048-bit key), one loop around one inlined
// product.
//
// Table select.  SHARED: the window indexes the table, the same entry for
// every row of the block; the exponent is n, lambda or a plaintext scalar
// and the address pattern does not depend on the rows' data.  Per-row
// (SHARED = false): each row loads entry w from ITS OWN table, so the load
// ADDRESS depends on that row's window — a window of a plaintext scalar
// (CT*PT) or of an injected obfuscator exponent.  The reference reads all 16
// entries and selects; this kernel does not.  Whether that needs a
// constant-time form is the open decision recorded in ROADMAP.md together
// with the fixed-base kernel's gather.  Windows are 4-bit values; higher
// bits are ignored.
//
// Two kernels live here.  rns_modexp2_tc_kernel is the one the wrapper
// launches: the same chain on the tensor-core product of rns_mont_mul_tc.cuh,
// on every set of up to 640 lanes — the small layout up to 160 lanes (a
// cluster of two CTAs), the narrow one up to 320 (a cluster of four), both
// with the extension weights in the cluster's shared memory for the whole
// launch, the wide one beyond (a cluster of eight, the weights read from L2
// once an extension); 72 rows a cluster — with the per-row table in 16-bit
// residues.
// rns_modexp2_kernel, the CUDA-core form above it, stays compiled only so
// that the two can be timed side by side (chip_smoke.py); nothing of the
// library launches it.

#include <type_traits>

#include "rns_mont_mul.cuh"
#include "rns_mont_mul_tc.cuh"

using namespace prns;
namespace cg = cooperative_groups;

constexpr int MAX_LIN = 576;  // input limbs (548: the n^2-width ciphertext of a 4096-bit key)

template <bool F32, bool LEAN, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS)
rns_modexp2_kernel(const int* __restrict__ base, size_t base_gstride,
                   const int* __restrict__ wins, const uint32_t* __restrict__ rowc,
                   const int2* __restrict__ T1, const int2* __restrict__ T2,
                   const int2* __restrict__ Cin, uint32_t* __restrict__ tab,
                   int* __restrict__ out, int B, int L, int NW, Dims d) {
  __shared__ Scratch<ROWS> s;
  __shared__ uint32_t xl[ROWS * MAX_LIN];
  const int j = threadIdx.x;
  const int W = d.W;
  const int g = blockIdx.y;
  const int Wt = d.k + d.kb;
  // this group's constants, inputs and outputs
  rowc += (size_t)g * NROWS * W;
  T1 += (size_t)g * d.k4 * W;
  T2 += (size_t)g * d.k4 * W;
  Cin += (size_t)g * L * W;
  base += (size_t)g * base_gstride;
  wins += SHARED ? (size_t)g * NW : (size_t)g * B * NW;
  tab += (size_t)g * B * 16 * 2 * W;
  out += (size_t)g * B * Wt;

  const Lane c = load_lane(rowc, W, j);
  const int row0 = blockIdx.x * ROWS;

  for (int idx = j; idx < ROWS * L; idx += blockDim.x) {
    int r = idx / L, l = idx - r * L;
    int row = row0 + r;
    xl[r * MAX_LIN + l] = row < B ? (uint32_t)base[(size_t)row * L + l] : 0u;
  }
  __syncthreads();

  // limbs -> residues: three 7-bit digit planes of the limbs against Cin
  uint32_t accA[ROWS], accB[ROWS], yA[ROWS], yB[ROWS];
  {
    uint32_t sA[ROWS][3], sB[ROWS][3];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int p = 0; p < 3; ++p) { sA[r][p] = 0; sB[r][p] = 0; }
    for (int l = 0; l < L; ++l) {
      int2 cw = __ldg(&Cin[l * W + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        uint32_t x = xl[r * MAX_LIN + l];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t dg = (x >> (DIGIT_BITS * p)) & DIGIT_MASK;
          sA[r][p] += dg * (uint32_t)cw.x;
          sB[r][p] += dg * (uint32_t)cw.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      uint32_t a = red_mu<F32, 3>(sA[r][0], c.mA, c.muA);
      uint32_t b = red_mu<F32, 3>(sB[r][0], c.mB, c.muB);
#pragma unroll
      for (int p = 1; p < 3; ++p) {
        uint32_t va = red_mu<F32, 3>(sA[r][p], c.mA, c.muA);
        uint32_t vb = red_mu<F32, 3>(sB[r][p], c.mB, c.muB);
        a = red_mu<F32, 3>(a + (va << (DIGIT_BITS * p)), c.mA, c.muA);
        b = red_mu<F32, 3>(b + (vb << (DIGIT_BITS * p)), c.mB, c.muB);
      }
      accA[r] = a;
      accB[r] = b;
    }
  }

  const uint32_t oneA = rowc[R_ONEA * W + j], oneB = rowc[R_ONEB * W + j];
  const uint32_t sqA = rowc[R_SQA * W + j], sqB = rowc[R_SQB * W + j];
  const uint32_t poneB = rowc[R_PONEB * W + j];
  // table entry t of row `row`: A side at ((row*16 + t)*2)*W, B side W later
  auto tab_at = [&](int row, int t) {
    return tab + (((size_t)row * 16 + t) * 2) * W + j;
  };

  // steps: 0 to Montgomery form (x * M_A^2); 1..14 table powers 2..15;
  // then NW windows of 4 squarings + 1 table product; last leaves the domain
  const int nsteps = 15 + 5 * NW + 1;
  for (int step = 0; step < nsteps; ++step) {
    int store_t = -1;
    if (step == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { yA[r] = sqA; yB[r] = sqB; }
      store_t = 1;
    } else if (step < 15) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        int row = row0 + r;
        if (row < B) {
          const uint32_t* e = tab_at(row, 1);
          yA[r] = e[0];
          yB[r] = e[W];
        } else { yA[r] = 0; yB[r] = 0; }
      }
      store_t = step + 1;
    } else if (step < nsteps - 1) {
      int wi = (step - 15) / 5, sub = (step - 15) - wi * 5;
      if (step == 15) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { accA[r] = oneA; accB[r] = oneB; }
      }
      if (sub < 4) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { yA[r] = accA[r]; yB[r] = accB[r]; }
      } else {
        const int wshared = SHARED ? (wins[wi] & 15) : 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          int row = row0 + r;
          if (row < B) {
            int w = SHARED ? wshared : (wins[(size_t)row * NW + wi] & 15);
            const uint32_t* e = tab_at(row, w);
            yA[r] = e[0];
            yB[r] = e[W];
          } else { yA[r] = 0; yB[r] = 0; }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { yA[r] = 1u; yB[r] = poneB; }
    }
    mont_mul2<F32, LEAN, ROWS, 1>(c, d, s, rowc, T1, T2, accA, accB, yA, yB,
                                          accA, accB);
    if (store_t >= 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        int row = row0 + r;
        if (row < B) {
          uint32_t* e = tab_at(row, store_t);
          e[0] = accA[r];
          e[W] = accB[r];
          if (store_t == 1) {
            uint32_t* e0 = tab_at(row, 0);
            e0[0] = oneA;
            e0[W] = oneB;
          }
        }
      }
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

// base [G or 1][B][L] (base_grouped = 0: one copy read by every group);
// wins [G][NW] (shared = 1) or [G][B][NW]; rowc [G][NROWS][W]; T1, T2
// [G][k4][W]; Cin [G][L][W]; tab [G][B][16][2][W]; out [G][B][k + kb].
extern "C" int rns_modexp2_launch(const void* base, const void* wins, const void* rowc,
                                  const void* T1, const void* T2, const void* Cin,
                                  void* tab, void* out, int G, int B, int L, int NW,
                                  int k, int kb, int W, int f32, int lean,
                                  int shared, int base_grouped, void* stream) {
  if (L > MAX_LIN || G < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  Dims d{k, kb, (k + 3) / 4, W};
  // one system per block: one redundant lane after the B lanes, and one
  // alpha column after those
  if (!dims_fit(d) || kb + 1 > W) return (int)cudaErrorInvalidValue;
  dim3 grid((B + ROWS - 1) / ROWS, G);
  size_t gstride = base_grouped ? (size_t)B * L : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define PRNS_LAUNCH_S(F, LN, S)                                                    \
  rns_modexp2_kernel<F, LN, S><<<grid, W, 0, st>>>(                            \
      (const int*)base, gstride, (const int*)wins, (const uint32_t*)rowc,          \
      (const int2*)T1, (const int2*)T2, (const int2*)Cin, (uint32_t*)tab,          \
      (int*)out, B, L, NW, d)
#define PRNS_LAUNCH(F, LN)                                                         \
  do {                                                                             \
    if (shared) PRNS_LAUNCH_S(F, LN, true);                                    \
    else PRNS_LAUNCH_S(F, LN, false);                                          \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
#undef PRNS_LAUNCH_S
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core form.  Same steps as above, on a cluster's ROWS rows:
// thread (g, t) of warp w owns lanes j0 + 4 nl (nl < NL) of the set and rows
// g + 8 mt; group blockIdx.y.  Launched with its cluster size as a launch
// attribute (one kernel template for the three layouts).  The power
// table is tab[G][B][16][2][W] of 16-bit residues (r_A < 2m < 2^15, z_B
// canonical).

// LAYOUT 0: narrow, 1: wide, 2: small (rns_mont_mul_tc.cuh)
template <int LAYOUT>
using K5Layout = typename std::conditional<
    LAYOUT == 1, tc::Wide,
    typename std::conditional<LAYOUT == 2, tc::Small, tc::Narrow>::type>::type;

template <int LAYOUT, bool F32, bool LEAN, bool SHARED>
__global__ void __launch_bounds__(K5Layout<LAYOUT>::MAX_THREADS, 1)
rns_modexp2_tc_kernel(const int* __restrict__ base, size_t base_gstride,
                      const int* __restrict__ wins, const uint32_t* __restrict__ rowc,
                      const uint32_t* __restrict__ T1, const uint32_t* __restrict__ T2,
                      const uint32_t* __restrict__ T1a, const int2* __restrict__ Cin,
                      uint16_t* __restrict__ tab, int* __restrict__ out, int B, int L,
                      int NW, tc::Dims d) {
  using TL = K5Layout<LAYOUT>;
  constexpr int MT = TL::MT, NL = TL::NL, MG = TL::MT_GROUP;
  const int W = d.W;
  const int g = blockIdx.y;
  const int Wt = d.k + d.kb;
  // this group's constants, inputs and outputs
  const size_t ww = (size_t)TL::CLUSTER * tc::weight_words<TL>(d);
  rowc += (size_t)g * NROWS * W;
  T1 += g * ww;
  T2 += g * ww;
  T1a += (size_t)g * d.KC * 128;
  Cin += (size_t)g * L * W;
  base += (size_t)g * base_gstride;
  wins += SHARED ? (size_t)g * NW : (size_t)g * B * NW;
  tab += (size_t)g * B * 16 * 2 * W;
  out += (size_t)g * B * Wt;

  const tc::Smem<TL> s = tc::carve<TL>(d, T1, T2);
  const tc::Place<TL> p = tc::place<TL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  const int row0 = (blockIdx.x / TL::CLUSTER) * TL::ROWS + p.g;  // + 8 mt
  auto lc = [&](int row, int nl) { return tc::lane_const(s, p, row, nl); };

  // limbs -> residues: three 7-bit digit planes of the limbs against Cin, one
  // lane and MT_GROUP m-tiles at a time (its accumulators stay few)
  uint32_t accA[NL][MT], accB[NL][MT];
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int m0 = 0; m0 < MT; m0 += MG) {
      uint32_t sA[MG][3], sB[MG][3];
#pragma unroll
      for (int u = 0; u < MG; ++u)
#pragma unroll
        for (int q = 0; q < 3; ++q) { sA[u][q] = 0; sB[u][q] = 0; }
      for (int l = 0; l < L; ++l) {
        int2 cw = __ldg(&Cin[l * W + j]);
#pragma unroll
        for (int u = 0; u < MG; ++u) {
          int row = row0 + 8 * (m0 + u);
          uint32_t x = row < B ? (uint32_t)__ldg(&base[(size_t)row * L + l]) : 0u;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t dg = (x >> (DIGIT_BITS * q)) & DIGIT_MASK;
            sA[u][q] += dg * (uint32_t)cw.x;
            sB[u][q] += dg * (uint32_t)cw.y;
          }
        }
      }
      const uint32_t mA = lc(R_MODSA, nl), muA = lc(R_MUA, nl);
      const uint32_t mB = lc(R_MODSB, nl), muB = lc(R_MUB, nl);
#pragma unroll
      for (int u = 0; u < MG; ++u) {
        uint32_t a = red_mu<F32, 3>(sA[u][0], mA, muA);
        uint32_t b = red_mu<F32, 3>(sB[u][0], mB, muB);
#pragma unroll
        for (int q = 1; q < 3; ++q) {
          uint32_t va = red_mu<F32, 3>(sA[u][q], mA, muA);
          uint32_t vb = red_mu<F32, 3>(sB[u][q], mB, muB);
          a = red_mu<F32, 3>(a + (va << (DIGIT_BITS * q)), mA, muA);
          b = red_mu<F32, 3>(b + (vb << (DIGIT_BITS * q)), mB, muB);
        }
        accA[nl][m0 + u] = a;
        accB[nl][m0 + u] = b;
      }
    }
  }

  // table entry t of row `row`, lane nl: A side at ((row*16 + t)*2)*W + j, B
  // side W later
  auto tab_at = [&](int row, int t, int nl) {
    return tab + (((size_t)row * 16 + t) * 2) * W + p.j0 + 4 * nl;
  };

  // steps: 0 to Montgomery form (x * M_A^2); 1..14 table powers 2..15;
  // then NW windows of 4 squarings + 1 table product; last leaves the domain.
  // The product fetches each operand where it is used (mode of the step).
  enum { Y_SQ, Y_ENTRY1, Y_ACC, Y_WINDOW, Y_ONE };
  const int nsteps = 15 + 5 * NW + 1;
  for (int step = 0; step < nsteps; ++step) {
    int store_t = -1, mode = Y_ONE, wi = 0;
    if (step == 0) {
      mode = Y_SQ;
      store_t = 1;
    } else if (step < 15) {
      mode = Y_ENTRY1;
      store_t = step + 1;
    } else if (step < nsteps - 1) {
      wi = (step - 15) / 5;
      if (step == 15) {
#pragma unroll
        for (int nl = 0; nl < NL; ++nl)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            accA[nl][mt] = lc(R_ONEA, nl);
            accB[nl][mt] = lc(R_ONEB, nl);
          }
      }
      mode = (step - 15) - wi * 5 < 4 ? Y_ACC : Y_WINDOW;
    }
    // every operand but the accumulator is staged in the product's vt slot,
    // its two residues (both below 2^15) packed in one word
    if (mode != Y_ACC) {
      const int wshared = SHARED && mode == Y_WINDOW ? (__ldg(&wins[wi]) & 15) : 0;
#pragma unroll 1
      for (int nl = 0; nl < NL; ++nl)
#pragma unroll 1
        for (int mt = 0; mt < MT; ++mt) {
          const int row = row0 + 8 * mt;
          uint32_t ya = 0u, yb = 0u;
          if (mode == Y_SQ) {
            ya = lc(R_SQA, nl);
            yb = lc(R_SQB, nl);
          } else if (mode == Y_ONE) {
            ya = 1u;
            yb = lc(R_PONEB, nl);
          } else if (row < B) {  // entry 1, or the entry of the window
            const int t = mode == Y_ENTRY1 ? 1
                          : SHARED ? wshared
                                   : (__ldg(&wins[(size_t)row * NW + wi]) & 15);
            const uint16_t* e = tab_at(row, t, nl);
            ya = e[0];
            yb = e[W];
          }
          tc::vt_slot(s, nl, mt) = ya | (yb << 16);
        }
    }
    tc::mont_mul2<F32, LEAN, 1>(
        s, d, p, rowc, accA, accB, [&](int nl, int mt, uint32_t& ya, uint32_t& yb) {
          if (mode == Y_ACC) {
            ya = accA[nl][mt];
            yb = accB[nl][mt];
          } else {
            const uint32_t v = tc::vt_slot(s, nl, mt);
            ya = v & 0xFFFFu;
            yb = v >> 16;
          }
        });
    if (store_t >= 0) {
#pragma unroll
      for (int nl = 0; nl < NL; ++nl)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int row = row0 + 8 * mt;
          if (row < B) {
            uint16_t* e = tab_at(row, store_t, nl);
            e[0] = (uint16_t)accA[nl][mt];
            e[W] = (uint16_t)accB[nl][mt];
            if (store_t == 1) {
              uint16_t* e0 = tab_at(row, 0, nl);
              e0[0] = (uint16_t)lc(R_ONEA, nl);
              e0[W] = (uint16_t)lc(R_ONEB, nl);
            }
          }
        }
    }
  }
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = lc(R_WINV, nl);
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

// The layout a set takes: the first of small, narrow, wide that fits, or -1.
static int k5_tc_layout(const tc::Dims& d) {
  if (tc::dims_fit<tc::Small>(d, 1)) return 2;
  if (tc::dims_fit<tc::Narrow>(d, 1)) return 0;
  if (tc::dims_fit<tc::Wide>(d, 1)) return 1;
  return -1;
}

// base [G or 1][B][L]; wins [G][NW] (shared = 1) or [G][B][NW]; rowc
// [G][NROWS][W]; T1, T2 [G][CLUSTER][KC][W/(4 CLUSTER)][32][2] words of B
// fragments, T1a [G][KC][2][32][2] (ops/cuda_rns2._tc_pack); Cin [G][L][W];
// tab [G][B][16][2][W] uint16; out [G][B][k + kb].
extern "C" int rns_modexp2_tc_launch(const void* base, const void* wins, const void* rowc,
                                     const void* T1, const void* T2, const void* T1a,
                                     const void* Cin, void* tab, void* out, int G, int B,
                                     int L, int NW, int k, int kb, int W, int f32, int lean,
                                     int shared, int base_grouped, void* stream) {
  if (L <= 0 || L > MAX_LIN || G < 1 || G > 65535 || B <= 0) return (int)cudaErrorInvalidValue;
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = k5_tc_layout(d);
  if (layout < 0) return (int)cudaErrorInvalidValue;
  const size_t gstride = base_grouped ? (size_t)B * L : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define PRNS_LAUNCH_S(LY, F, LN, S)                                                        \
  do {                                                                                     \
    using TL = K5Layout<LY>;                                                               \
    const cudaError_t err = tc::launch_clusters<TL>(                                       \
        rns_modexp2_tc_kernel<LY, F, LN, S>, dim3((B + TL::ROWS - 1) / TL::ROWS, G), d, st, \
        (const int*)base, gstride, (const int*)wins, (const uint32_t*)rowc,                \
        (const uint32_t*)T1, (const uint32_t*)T2, (const uint32_t*)T1a, (const int2*)Cin,  \
        (uint16_t*)tab, (int*)out, B, L, NW, d);                                           \
    if (err != cudaSuccess) return (int)err;                                               \
  } while (0)
#define PRNS_LAUNCH_W(F, LN, S)                      \
  do {                                               \
    if (layout == 2) PRNS_LAUNCH_S(2, F, LN, S);     \
    else if (layout == 1) PRNS_LAUNCH_S(1, F, LN, S); \
    else PRNS_LAUNCH_S(0, F, LN, S);                 \
  } while (0)
#define PRNS_LAUNCH(F, LN)                     \
  do {                                         \
    if (shared) PRNS_LAUNCH_W(F, LN, true);    \
    else PRNS_LAUNCH_W(F, LN, false);          \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
#undef PRNS_LAUNCH_W
#undef PRNS_LAUNCH_S
  return (int)cudaGetLastError();
}

// How many clusters of the tensor-core K5 kernel (shared windows, the form
// of the set) fit the card at once, for a set of W lanes; -1 if none is
// compiled for it.
extern "C" int rns_modexp2_tc_max_clusters(int k, int kb, int W, int f32, int lean) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = k5_tc_layout(d);
  if (layout < 0 || (lean && !f32)) return -1;
  int n = -1;
#define PRNS_QUERY_S(LY, F, LN) \
  n = tc::max_active_clusters<K5Layout<LY>>(rns_modexp2_tc_kernel<LY, F, LN, true>, d)
#define PRNS_QUERY(F, LN)                         \
  do {                                            \
    if (layout == 2) PRNS_QUERY_S(2, F, LN);      \
    else if (layout == 1) PRNS_QUERY_S(1, F, LN); \
    else PRNS_QUERY_S(0, F, LN);                  \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_QUERY);
#undef PRNS_QUERY
#undef PRNS_QUERY_S
  return n;
}
