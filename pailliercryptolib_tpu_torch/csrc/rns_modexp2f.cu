// K3 — CRT decrypt modexp on the full n^2-width ciphertext, both residue
// systems (p^2, q^2) folded side by side on the lane axis: limbs -> residues
// through the Cin weights (which is ct mod p^2 and ct mod q^2), to
// Montgomery form, a 16-entry power table per row, NW 4-bit windows of the
// two shared exponents p-1 and q-1 (four squarings and one table product per
// window, the two exponents merged by lane group), leave Montgomery form,
// unscale the B lanes.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_rns_modexp2f /
// _folded_stream_kernel / _modexp2_body_streams, which keep the 16-entry
// table of a whole batch tile in on-chip scratch memory.
//
// On this card: a block has 227 KB of shared memory and one row's table is
// 16 x (k + kb) words (38.8 KB for a 2048-bit key), so the table lives in a
// global scratch tensor the wrapper allocates and L1 / L2 serve it.  The
// windows are those of p - 1 and q - 1, the private key, the same for every
// row: the pattern of an indexed read would not depend on the ciphertext but
// would depend on the key.  So the library's form reads all 16 entries of a
// row's table at addresses that take no window and keeps the two entries the
// groups' windows name with masks in registers (ct_select.cuh); no address,
// branch or register index takes a window.  Bound by integer issue:
// 15 + 5*NW + 1 Montgomery products per row (1296 for a 2048-bit key).  The
// whole chain is one loop with one inlined product, so the kernel's code
// stays small.  Compiled in the one form the folded layout has (f32
// reduction, lean fold, both systems within 320 lanes): keys wider than 2048
// bits take the grouped layout of the generic kernel instead, as in the
// reference.
//
// Four kernels live here.  rns_modexp2f_tc_kernel<true, 2> is the one the
// wrapper launches: the same chain on the tensor-core product of
// rns_mont_mul_tc.cuh (a cluster of four CTAs shares 72 rows in two halves
// that run the product out of step, the extension weights stay in shared
// memory for the whole launch, the per-row table holds 16-bit residues).
// rns_modexp2f_tc_kernel<true, 1>, the same in one half (the form before the
// split), rns_modexp2f_tc_kernel<false, 2>, its indexed form (the entry a
// window names loaded at an address that takes the window, as before the
// select was made independent of secrets), and rns_modexp2f_kernel, the
// CUDA-core form below (which keeps its indexed select), stay compiled only
// so that the forms can be timed side by side (chip_smoke.py); nothing of the
// library launches them.

#include <type_traits>

#include "ct_select.cuh"
#include "rns_mont_mul.cuh"
#include "rns_mont_mul_tc.cuh"

using namespace prns;
namespace cg = cooperative_groups;

constexpr int MAX_LIN = 288;  // input limbs (274 for a 2048-bit key's n^2)
constexpr int MAX_THREADS_FOLDED = 320;  // both systems side by side: the lean fold's limit

__global__ void __launch_bounds__(MAX_THREADS_FOLDED)
rns_modexp2f_kernel(const int* __restrict__ ct, const int* __restrict__ wins,
                    const uint32_t* __restrict__ rowc, const int2* __restrict__ T1,
                    const int2* __restrict__ T2, const int2* __restrict__ Cin,
                    uint32_t* __restrict__ tab, int* __restrict__ out, int B, int L,
                    int NW, Dims d) {
  __shared__ Scratch<ROWS> s;
  __shared__ uint32_t xl[ROWS * MAX_LIN];
  const int j = threadIdx.x;
  const int W = d.W;
  const Lane c = load_lane(rowc, W, j);
  const int row0 = blockIdx.x * ROWS;

  for (int idx = j; idx < ROWS * L; idx += blockDim.x) {
    int r = idx / L, l = idx - r * L;
    int row = row0 + r;
    xl[r * MAX_LIN + l] = row < B ? (uint32_t)ct[(size_t)row * L + l] : 0u;
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
      uint32_t a = red_mu<true, 3>(sA[r][0], c.mA, c.muA);
      uint32_t b = red_mu<true, 3>(sB[r][0], c.mB, c.muB);
#pragma unroll
      for (int p = 1; p < 3; ++p) {
        uint32_t va = red_mu<true, 3>(sA[r][p], c.mA, c.muA);
        uint32_t vb = red_mu<true, 3>(sB[r][p], c.mB, c.muB);
        a = red_mu<true, 3>(a + (va << (DIGIT_BITS * p)), c.mA, c.muA);
        b = red_mu<true, 3>(b + (vb << (DIGIT_BITS * p)), c.mB, c.muB);
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
        int wA = wins[c.gidA * NW + wi], wB = wins[c.gidB * NW + wi];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          int row = row0 + r;
          if (row < B) {
            yA[r] = tab_at(row, wA)[0];
            yB[r] = tab_at(row, wB)[W];
          } else { yA[r] = 0; yB[r] = 0; }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { yA[r] = 1u; yB[r] = poneB; }
    }
    mont_mul2<true, true, ROWS, 2>(c, d, s, rowc, T1, T2, accA, accB, yA, yB, accA,
                                   accB);
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
  const int Wt = d.k + d.kb;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int row = row0 + r;
    if (row < B) {
      if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[r];
      if (j < d.kb)
        out[(size_t)row * Wt + d.k + j] = (int)mulmod_b<true>(c, accB[r], c.winv);
    }
  }
}

extern "C" int rns_modexp2f_launch(const void* ct, const void* wins, const void* rowc,
                                   const void* T1, const void* T2, const void* Cin,
                                   void* tab, void* out, int B, int L, int NW, int k,
                                   int kb, int W, void* stream) {
  if (L > MAX_LIN) return (int)cudaErrorInvalidValue;
  Dims d{k, kb, (k + 3) / 4, W};
  if (!dims_fit(d, MAX_THREADS_FOLDED) || kb + 2 > W) return (int)cudaErrorInvalidValue;
  int blocks = (B + ROWS - 1) / ROWS;
  rns_modexp2f_kernel<<<blocks, W, 0, (cudaStream_t)stream>>>(
      (const int*)ct, (const int*)wins, (const uint32_t*)rowc, (const int2*)T1,
      (const int2*)T2, (const int2*)Cin, (uint32_t*)tab, (int*)out, B, L, NW, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core form.  Same steps as above, on a cluster's 72 rows: thread
// (g, t) of warp v of half h owns lanes j0 + 4 nl (nl < NL) of the folded set
// and rows g + 8 (mt0 + u), u < the half's m-tiles; nothing outside the
// product synchronises threads.  The power table is global scratch, 64 bytes a (row, lane) (16-bit
// residues: r_A < 2m < 2^15 under the f32 reduction, z_B canonical), 42 MB at
// batch 2048 instead of 84:
//   CT = true   tab[B][W][16] words, entry t = r_A | z_B << 16: a (row,
//               lane)'s entries side by side, read whole at every window by
//               ctsel::select16, whose masks keep the A residue of the entry of
//               the lane's A group's window and the B residue of its B group's.
//   CT = false  tab[B][16][2][W] uint16 (the indexed form, for timing).

// HALVES 2: the narrow layout, the library's; 1: the same in one half
template <int HALVES>
using K3Layout = typename std::conditional<HALVES == 2, tc::Narrow, tc::Narrow1>::type;
using TcL = K3Layout<2>;

static_assert(K3Layout<1>::CLUSTER == 4 && K3Layout<2>::CLUSTER == 4, "clusters of four");

template <bool CT, int HALVES>
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(K3Layout<HALVES>::MAX_THREADS, 1)
rns_modexp2f_tc_kernel(const int* __restrict__ ct, const int* __restrict__ wins,
                       const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                       const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                       const int2* __restrict__ Cin, uint32_t* __restrict__ tab,
                       int* __restrict__ out, int B, int L,
                       int NW, tc::Dims d) {
  using TL = K3Layout<HALVES>;
  constexpr int TC_MTH = TL::MTH, TC_NL = TL::NL, MG = TL::MT_GROUP;
  const tc::Smem<TL> s = tc::carve<TL>(d, T1, T2);
  tc::Place<TL> p = tc::place<TL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state<2>(s, d, p, rowc, T1, T2, T1a);
  const int W = d.W;
  // + 8 u: the rows of this thread's m-tile u
  const int row0 = (blockIdx.x / TL::CLUSTER) * TL::ROWS + 8 * tc::mt0(p) + p.g;
  // per-lane constants are read from shared memory where they are used,
  // which keeps them out of the registers of the product
  auto lc = [&](int row, int nl) { return tc::lane_const(s, p, row, nl); };

  // limbs -> residues: three 7-bit digit planes of the limbs against Cin, one
  // lane and MT_GROUP m-tiles at a time (its accumulators stay few)
  uint32_t accA[TC_NL][TC_MTH], accB[TC_NL][TC_MTH];
#pragma unroll
  for (int nl = 0; nl < TC_NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int m0 = 0; m0 < TC_MTH; m0 += MG) {
      uint32_t sA[MG][3], sB[MG][3];
#pragma unroll
      for (int u = 0; u < MG; ++u)
#pragma unroll
        for (int q = 0; q < 3; ++q) { sA[u][q] = 0; sB[u][q] = 0; }
      for (int l = 0; l < L; ++l) {
        int2 cw = __ldg(&Cin[l * W + j]);
#pragma unroll
        for (int u = 0; u < MG; ++u) {
          if (m0 + u >= TC_MTH) continue;
          int row = row0 + 8 * (m0 + u);
          uint32_t x = row < B && tc::has_mt(p, m0 + u)
                           ? (uint32_t)__ldg(&ct[(size_t)row * L + l]) : 0u;
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
        if (m0 + u >= TC_MTH) continue;
        uint32_t a = red_mu<true, 3>(sA[u][0], mA, muA);
        uint32_t b = red_mu<true, 3>(sB[u][0], mB, muB);
#pragma unroll
        for (int q = 1; q < 3; ++q) {
          uint32_t va = red_mu<true, 3>(sA[u][q], mA, muA);
          uint32_t vb = red_mu<true, 3>(sB[u][q], mB, muB);
          a = red_mu<true, 3>(a + (va << (DIGIT_BITS * q)), mA, muA);
          b = red_mu<true, 3>(b + (vb << (DIGIT_BITS * q)), mB, muB);
        }
        accA[nl][m0 + u] = a;
        accB[nl][m0 + u] = b;
      }
    }
  }

  // the table of (row, lane nl): CT, its 16 words; indexed, entry 0's A residue
  auto tab_row = [&](int row, int nl) {
    const int j = p.j0 + 4 * nl;
    return CT ? tab + ((size_t)row * W + j) * 16
              : reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(tab) +
                                            (size_t)row * 16 * 2 * W + j);
  };
  // the A residue of entry ta and the B residue of entry tb of (row, lane nl),
  // packed; ta, tb public (or the indexed form's windows)
  auto tab_load = [&](int row, int ta, int tb, int nl) -> uint32_t {
    if (CT) {
      const uint32_t* e = tab_row(row, nl);
      return (e[ta] & 0xFFFFu) | (e[tb] & 0xFFFF0000u);
    }
    const uint16_t* e = reinterpret_cast<const uint16_t*>(tab_row(row, nl));
    return (uint32_t)e[ta * 2 * W] | ((uint32_t)e[tb * 2 * W + W] << 16);
  };
  auto tab_store = [&](int row, int t, int nl, uint32_t a, uint32_t b) {
    if (CT) {
      tab_row(row, nl)[t] = (a & 0xFFFFu) | (b << 16);  // a lane past the A side holds no A residue
    } else {
      uint16_t* e = reinterpret_cast<uint16_t*>(tab_row(row, nl)) + t * 2 * W;
      e[0] = (uint16_t)a;
      e[W] = (uint16_t)b;
    }
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
        for (int nl = 0; nl < TC_NL; ++nl)
#pragma unroll
          for (int u = 0; u < TC_MTH; ++u) {
            accA[nl][u] = lc(R_ONEA, nl);
            accB[nl][u] = lc(R_ONEB, nl);
          }
      }
      mode = (step - 15) - wi * 5 < 4 ? Y_ACC : Y_WINDOW;
    }
    // every operand but the accumulator is staged in the product's vt slot,
    // its two residues (both below 2^15) packed in one word
    if (mode != Y_ACC) {
#pragma unroll 1
      for (int nl = 0; nl < TC_NL; ++nl) {
        // the windows of this lane's two groups (A side, B side)
        uint32_t wa = 0u, wb = 0u;
        uint32_t m[16];
        if (mode == Y_WINDOW) {
          wa = (uint32_t)__ldg(&wins[lc(R_GIDA, nl) * NW + wi]) & 15u;
          wb = (uint32_t)__ldg(&wins[lc(R_GIDB, nl) * NW + wi]) & 15u;
          if (CT) ctsel::window_masks(m, wa, wb);
        }
#pragma unroll 1
        for (int u = 0; u < tc::n_mt(p); ++u) {
          const int row = row0 + 8 * u;
          uint32_t v = 0u;
          if (mode == Y_SQ) {
            v = lc(R_SQA, nl) | (lc(R_SQB, nl) << 16);
          } else if (mode == Y_ONE) {
            v = 1u | (lc(R_PONEB, nl) << 16);
          } else if (row < B && mode == Y_ENTRY1) {
            v = tab_load(row, 1, 1, nl);
          } else if (row < B) {  // the entries of the two groups' windows
            v = CT ? ctsel::select16(tab_row(row, nl), m) : tab_load(row, (int)wa, (int)wb, nl);
          }
          tc::vt_slot(s, p, nl, u) = v;
        }
      }
    }
    tc::mont_mul2<true, true, 2>(
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
      for (int nl = 0; nl < TC_NL; ++nl)
#pragma unroll
        for (int u = 0; u < TC_MTH; ++u) {
          int row = row0 + 8 * u;
          if (row < B && tc::has_mt(p, u)) {
            tab_store(row, store_t, nl, accA[nl][u], accB[nl][u]);
            if (store_t == 1) tab_store(row, 0, nl, lc(R_ONEA, nl), lc(R_ONEB, nl));
          }
        }
    }
  }
  const int Wt = d.k + d.kb;
#pragma unroll
  for (int nl = 0; nl < TC_NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = lc(R_WINV, nl);
#pragma unroll
    for (int u = 0; u < TC_MTH; ++u) {
      int row = row0 + 8 * u;
      if (row < B && tc::has_mt(p, u)) {
        if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[nl][u];
        if (j < d.kb)
          out[(size_t)row * Wt + d.k + j] = (int)tc::mulmod_b<true>(s, p, nl, accB[nl][u], winv);
      }
    }
  }
  tc::finish(p);
}

template <bool CT, int HALVES = 2>
static int k3_tc_launch(const void* ct, const void* wins, const void* rowc, const void* T1,
                        const void* T2, const void* T1a, const void* Cin, void* tab, void* out,
                        int B, int L, int NW, int k, int kb, int W, void* stream) {
  if (L > MAX_LIN || B <= 0) return (int)cudaErrorInvalidValue;
  using TL = K3Layout<HALVES>;
  tc::Dims d{k, kb, W, (k + 31) / 32};
  if (!tc::dims_fit<TL>(d, 2)) return (int)cudaErrorInvalidValue;
  const int smem = TL::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rns_modexp2f_tc_kernel<CT, HALVES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (B + TL::ROWS - 1) / TL::ROWS;
  rns_modexp2f_tc_kernel<CT, HALVES><<<clusters * TL::CLUSTER, tc::threads<TL>(d), smem,
                                       (cudaStream_t)stream>>>(
      (const int*)ct, (const int*)wins, (const uint32_t*)rowc, (const uint32_t*)T1,
      (const uint32_t*)T2, (const uint32_t*)T1a, (const int2*)Cin, (uint32_t*)tab, (int*)out,
      B, L, NW, d);
  return (int)cudaGetLastError();
}

// T1, T2: [4][KC][W/16][32][2] words of B fragments, T1a: [KC][2][32][2], T1's
// alpha columns (ops/cuda_rns2._tc_pack); tab: [B][16 W] words of scratch.
// The library's form; rns_modexp2f_indexed_launch the indexed one and
// rns_modexp2f_unsplit_launch the one-half one (timing only).
extern "C" int rns_modexp2f_tc_launch(const void* ct, const void* wins, const void* rowc,
                                      const void* T1, const void* T2, const void* T1a,
                                      const void* Cin,
                                      void* tab, void* out, int B, int L, int NW, int k,
                                      int kb, int W, void* stream) {
  return k3_tc_launch<true>(ct, wins, rowc, T1, T2, T1a, Cin, tab, out, B, L, NW, k, kb, W,
                            stream);
}

extern "C" int rns_modexp2f_unsplit_launch(const void* ct, const void* wins, const void* rowc,
                                           const void* T1, const void* T2, const void* T1a,
                                           const void* Cin,
                                           void* tab, void* out, int B, int L, int NW, int k,
                                           int kb, int W, void* stream) {
  return k3_tc_launch<true, 1>(ct, wins, rowc, T1, T2, T1a, Cin, tab, out, B, L, NW, k, kb, W,
                               stream);
}

extern "C" int rns_modexp2f_indexed_launch(const void* ct, const void* wins, const void* rowc,
                                           const void* T1, const void* T2, const void* T1a,
                                           const void* Cin,
                                           void* tab, void* out, int B, int L, int NW, int k,
                                           int kb, int W, void* stream) {
  return k3_tc_launch<false>(ct, wins, rowc, T1, T2, T1a, Cin, tab, out, B, L, NW, k, kb, W,
                             stream);
}

// Dynamic shared memory of a tensor-core launch of the narrow (0), wide (1),
// small (2) or one-half narrow (3) layout (laid out for its widest set), and
// how many clusters of the K3 kernel fit the card at once.
extern "C" int rns_tc_smem_bytes(int layout) {
  return layout == 3   ? tc::Narrow1::SMEM_BYTES
         : layout == 2 ? tc::Small::SMEM_BYTES
         : layout == 1 ? tc::Wide::SMEM_BYTES : tc::Narrow::SMEM_BYTES;
}

extern "C" int rns_modexp2f_tc_max_clusters(int k, int kb, int W) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  return tc::dims_fit<TcL>(d, 2) ? tc::max_active_clusters<TcL>(rns_modexp2f_tc_kernel<true, 2>, d)
                                 : -1;
}
