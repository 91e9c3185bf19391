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
// form of rns_mont_mul.cuh is compiled).  With base_gstride = 0 every group
// reads the same base rows (the CRT decrypt feeds the full n^2-width
// ciphertext to both groups).  As in the CRT-folded kernel one row's table
// is too large for shared memory: it lives in global scratch the wrapper
// allocates ([G][B][W][16] words of two 16-bit residues: 20.5 KB over n^2 of a
// 2048-bit key, 41 KB of a 4096-bit key), written and read by the same
// thread per lane and served by L2.  Bound by the integer instruction rate:
// 15 + 5*NW + 1 Montgomery products per row (2576 for the exponent n of a
// 2048-bit key), one loop around one inlined product.
//
// Table select.  The window is a window of lambda (the private key: every
// RAW decrypt on "rns"), of p - 1 and q - 1 (the CRT decrypt of a key wider
// than 2048 bits), of a plaintext scalar (CT*PT) or of an injected obfuscator
// exponent: a secret in every mode.  The reference reads all 16 entries and
// selects (per-row windows) or indexes a table in VMEM, a memory with no cache
// (shared windows).  The kernel (below) reads all 16 entries of
// a row's table at addresses that take no window and keeps one with a mask
// (ct_select.cuh), in every mode: shared, per-row, grouped.  Windows are
// 4-bit values; higher bits are ignored.
//
// rns_modexp2_tc_kernel runs the chain on the tensor-core product of
// rns_mont_mul_tc.cuh, on every set of up to 640 lanes — the small layout up
// to 160 lanes (a cluster of two CTAs), the narrow one up to 320 (a cluster of
// four), both with the extension weights in the cluster's shared memory for
// the whole launch, the wide one beyond (a cluster of eight, the weights read
// from L2 once an extension); 72 rows a cluster — with the per-row table in
// 16-bit residues.
//
// Thread (g, t) of warp v of half h owns lanes j0 + 4 nl (nl < NL) of the set
// and rows g + 8 (mt0 + u) of its cluster's ROWS, u < the half's m-tiles;
// group blockIdx.y.  Launched with its cluster size as a launch attribute
// (one kernel template for the three layouts; the narrow one in two halves
// out of step).  Nothing outside the product synchronises threads, so the
// halves of a CTA stay apart from the first product to the last.  The power
// table is global scratch, tab[G][B][W][16] words, 64 bytes a (row, lane):
// entry t = r_A | z_B << 16 (r_A < 2m < 2^15, z_B canonical; the A half cut
// to 16 bits, since a lane past the A side holds no A residue), a (row,
// lane)'s entries side by side, read whole by ctsel::select16
// (ct_select.cuh) at every window.  No address, branch or register index
// takes a window.  The read cannot be issued ahead of the window's
// squarings: its 64 bytes would have to wait in registers or the vt slots,
// which are the product's.

#include <type_traits>

#include "ct_select.cuh"
#include "rns_mont_mul_tc.cuh"

namespace prns {
namespace k5 {

namespace cg = cooperative_groups;

constexpr int MAX_LIN = 576;  // input limbs (548: the n^2-width ciphertext of a 4096-bit key)

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
                      uint32_t* __restrict__ tab, int* __restrict__ out, int B, int L,
                      int NW, tc::Dims d) {
  using TL = K5Layout<LAYOUT>;
  constexpr int MTH = TL::MTH, NL = TL::NL, MG = TL::MT_GROUP;
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
  tab += (size_t)g * B * 16 * W;
  out += (size_t)g * B * Wt;

  const tc::Smem<TL> s = tc::carve<TL>(d, T1, T2);
  tc::Place<TL> p = tc::place<TL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  // + 8 u: the rows of this thread's m-tile u
  const int row0 = (blockIdx.x / TL::CLUSTER) * TL::ROWS + 8 * tc::mt0(p) + p.g;
  auto lc = [&](int row, int nl) { return tc::lane_const(s, p, row, nl); };

  // limbs -> residues: three 7-bit digit planes of the limbs against Cin, one
  // lane and MT_GROUP m-tiles at a time (its accumulators stay few)
  uint32_t accA[NL][MTH], accB[NL][MTH];
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int m0 = 0; m0 < MTH; m0 += MG) {
      uint32_t sA[MG][3], sB[MG][3];
#pragma unroll
      for (int u = 0; u < MG; ++u)
#pragma unroll
        for (int q = 0; q < 3; ++q) { sA[u][q] = 0; sB[u][q] = 0; }
      for (int l = 0; l < L; ++l) {
        int2 cw = __ldg(&Cin[l * W + j]);
#pragma unroll
        for (int u = 0; u < MG; ++u) {
          if (m0 + u >= MTH) continue;
          int row = row0 + 8 * (m0 + u);
          uint32_t x = row < B && tc::has_mt(p, m0 + u)
                           ? (uint32_t)__ldg(&base[(size_t)row * L + l]) : 0u;
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
        if (m0 + u >= MTH) continue;
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

  // the table of (row, lane nl): its 16 words
  auto tab_row = [&](int row, int nl) {
    const int j = p.j0 + 4 * nl;
    return tab + ((size_t)row * W + j) * 16;
  };
  auto tab_store = [&](int row, int t, int nl, uint32_t a, uint32_t b) {
    tab_row(row, nl)[t] = (a & 0xFFFFu) | (b << 16);  // a lane past the A side holds no A residue
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
          for (int u = 0; u < MTH; ++u) {
            accA[nl][u] = lc(R_ONEA, nl);
            accB[nl][u] = lc(R_ONEB, nl);
          }
      }
      mode = (step - 15) - wi * 5 < 4 ? Y_ACC : Y_WINDOW;
    }
    // every operand but the accumulator is staged in the product's vt slot,
    // its two residues (both below 2^15) packed in one word
    if (mode != Y_ACC) {
      const uint32_t wshared = SHARED && mode == Y_WINDOW ? (__ldg(&wins[wi]) & 15) : 0u;
      uint32_t m[16];
      if (SHARED) ctsel::window_masks(m, wshared, wshared);
#pragma unroll 1
      for (int nl = 0; nl < NL; ++nl)
#pragma unroll 1
        for (int u = 0; u < tc::n_mt(p); ++u) {
          const int row = row0 + 8 * u;
          uint32_t v = 0u;
          if (mode == Y_SQ) {
            v = lc(R_SQA, nl) | (lc(R_SQB, nl) << 16);
          } else if (mode == Y_ONE) {
            v = 1u | (lc(R_PONEB, nl) << 16);
          } else if (row < B && mode == Y_ENTRY1) {
            v = tab_row(row, nl)[1];
          } else if (row < B) {  // the entry of the window
            const uint32_t w =
                SHARED ? wshared : (uint32_t)__ldg(&wins[(size_t)row * NW + wi]) & 15u;
            if (!SHARED) ctsel::window_masks(m, w, w);
            v = ctsel::select16(tab_row(row, nl), m);
          }
          tc::vt_slot(s, p, nl, u) = v;
        }
    }
    tc::mont_mul2<F32, LEAN, 1>(
        s, d, p, rowc, accA, accB, [&](int nl, int u, uint32_t& ya, uint32_t& yb) {
          if (mode == Y_ACC) {
            ya = accA[nl][u];
            yb = accB[nl][u];
          } else {
            const uint32_t v = tc::vt_slot(s, p, nl, u);
            ya = v & 0xFFFFu;
            yb = v >> 16;
          }
        });
    if (store_t >= 0) {
#pragma unroll
      for (int nl = 0; nl < NL; ++nl)
#pragma unroll
        for (int u = 0; u < MTH; ++u) {
          int row = row0 + 8 * u;
          if (row < B && tc::has_mt(p, u)) {
            tab_store(row, store_t, nl, accA[nl][u], accB[nl][u]);
            if (store_t == 1) tab_store(row, 0, nl, lc(R_ONEA, nl), lc(R_ONEB, nl));
          }
        }
    }
  }
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = lc(R_WINV, nl);
#pragma unroll
    for (int u = 0; u < MTH; ++u) {
      int row = row0 + 8 * u;
      if (row < B && tc::has_mt(p, u)) {
        if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[nl][u];
        if (j < d.kb)
          out[(size_t)row * Wt + d.k + j] = (int)tc::mulmod_b<F32>(s, p, nl, accB[nl][u], winv);
      }
    }
  }
  tc::finish(p);
}

// The layout a set takes: the first of small, narrow, wide that fits, or -1.
inline int k5_tc_layout(const tc::Dims& d) {
  if (tc::dims_fit<tc::Small>(d, 1)) return 2;
  if (tc::dims_fit<tc::Narrow>(d, 1)) return 0;
  if (tc::dims_fit<tc::Wide>(d, 1)) return 1;
  return -1;
}

}  // namespace k5
}  // namespace prns

using namespace prns;
using namespace prns::k5;

// base [G or 1][B][L]; wins [G][NW] (shared = 1) or [G][B][NW]; rowc
// [G][NROWS][W]; T1, T2 [G][CLUSTER][KC][W/(4 CLUSTER)][32][2] words of B
// fragments, T1a [G][KC][2][32][2] (ops/cuda_rns2._tc_pack); Cin [G][L][W];
// tab [G][B][16 W] words of scratch; out [G][B][k + kb].
extern "C" int rns_modexp2_tc_launch(const void* base, const void* wins, const void* rowc,
                                     const void* T1, const void* T2, const void* T1a,
                                     const void* Cin, void* tab, void* out, int G, int B, int L,
                                     int NW, int k, int kb, int W, int f32, int lean, int shared,
                                     int base_grouped, void* stream) {
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
        rns_modexp2_tc_kernel<LY, F, LN, S>, dim3((B + TL::ROWS - 1) / TL::ROWS, G), d,    \
        st, (const int*)base, gstride, (const int*)wins, (const uint32_t*)rowc,            \
        (const uint32_t*)T1, (const uint32_t*)T2, (const uint32_t*)T1a, (const int2*)Cin,  \
        (uint32_t*)tab, (int*)out, B, L, NW, d);                                           \
    if (err != cudaSuccess) return (int)err;                                               \
  } while (0)
#define PRNS_LAUNCH_W(F, LN, S)                      \
  do {                                               \
    if (layout == 2) PRNS_LAUNCH_S(2, F, LN, S);      \
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

// How many clusters of the K5 kernel (shared windows, the form of the set) fit
// the card at once, for a set of W lanes; -1 if none is compiled for it.
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
