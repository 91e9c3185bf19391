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
// global scratch tensor the wrapper allocates ([B][16][2][W] words) and L2
// serves it; each table row is read as one coalesced line per side.  The
// select is by the key's exponent windows, the same for every row (as in
// the reference), so the access pattern does not depend on the ciphertext.
// Bound by integer issue: 15 + 5*NW + 1 Montgomery products per row
// (1296 for a 2048-bit key).  The whole chain is one loop with one inlined
// product, so the kernel's code stays small.  Compiled in the one form the
// folded layout has (f32 reduction, lean fold, both systems within 320
// lanes): keys wider than 2048 bits take the grouped layout of the generic
// kernel instead, as in the reference.
//
// Two kernels live here.  rns_modexp2f_tc_kernel is the one the wrapper
// launches: the same chain on the tensor-core product of rns_mont_mul_tc.cuh
// (a cluster of four CTAs shares 72 rows, the extension weights stay in
// shared memory for the whole launch, the per-row table holds 16-bit
// residues).  rns_modexp2f_kernel, the CUDA-core form above, stays compiled
// only so that the two can be timed side by side (chip_smoke.py); nothing of
// the library launches it.

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
// (g, t) of warp w owns lanes j0 + 4 nl (nl < NL) of the folded set and rows
// g + 8 mt.  The power table is tab[B][16][2][W] of 16-bit residues (r_A < 2m
// < 2^15 under the f32 reduction, z_B canonical): 42 MB at batch 2048
// instead of 84.

using TcL = tc::Narrow;
constexpr int TC_MT = TcL::MT;
constexpr int TC_NL = TcL::NL;
static_assert(TC_MT % 3 == 0, "the residue conversion takes three m-tiles at a time");

__global__ void __cluster_dims__(TcL::CLUSTER, 1, 1) __launch_bounds__(TcL::MAX_THREADS, 1)
rns_modexp2f_tc_kernel(const int* __restrict__ ct, const int* __restrict__ wins,
                       const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                       const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                       const int2* __restrict__ Cin, uint16_t* __restrict__ tab,
                       int* __restrict__ out, int B, int L,
                       int NW, tc::Dims d) {
  const tc::Smem<TcL> s = tc::carve<TcL>(d, T1, T2);
  const tc::Place<TcL> p = tc::place<TcL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  const int W = d.W;
  const int row0 = (blockIdx.x / TcL::CLUSTER) * TcL::ROWS + p.g;  // + 8 mt
  // per-lane constants are read from shared memory where they are used,
  // which keeps them out of the registers of the product
  auto lc = [&](int row, int nl) { return tc::lane_const(s, p, row, nl); };

  // limbs -> residues: three 7-bit digit planes of the limbs against Cin, one
  // lane and three m-tiles at a time (its accumulators stay few)
  uint32_t accA[TC_NL][TC_MT], accB[TC_NL][TC_MT];
#pragma unroll
  for (int nl = 0; nl < TC_NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int m0 = 0; m0 < TC_MT; m0 += 3) {
      uint32_t sA[3][3], sB[3][3];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int q = 0; q < 3; ++q) { sA[u][q] = 0; sB[u][q] = 0; }
      for (int l = 0; l < L; ++l) {
        int2 cw = __ldg(&Cin[l * W + j]);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          int row = row0 + 8 * (m0 + u);
          uint32_t x = row < B ? (uint32_t)__ldg(&ct[(size_t)row * L + l]) : 0u;
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
      for (int u = 0; u < 3; ++u) {
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
        for (int nl = 0; nl < TC_NL; ++nl)
#pragma unroll
          for (int mt = 0; mt < TC_MT; ++mt) {
            accA[nl][mt] = lc(R_ONEA, nl);
            accB[nl][mt] = lc(R_ONEB, nl);
          }
      }
      mode = (step - 15) - wi * 5 < 4 ? Y_ACC : Y_WINDOW;
    }
    // every operand but the accumulator is staged in the product's vt slot,
    // its two residues (both below 2^15) packed in one word
    if (mode != Y_ACC) {
#pragma unroll 1
      for (int nl = 0; nl < TC_NL; ++nl)
#pragma unroll 1
        for (int mt = 0; mt < TC_MT; ++mt) {
          const int row = row0 + 8 * mt;
          uint32_t ya = 0u, yb = 0u;
          if (mode == Y_SQ) {
            ya = lc(R_SQA, nl);
            yb = lc(R_SQB, nl);
          } else if (mode == Y_ONE) {
            ya = 1u;
            yb = lc(R_PONEB, nl);
          } else if (row < B && mode == Y_ENTRY1) {
            const uint16_t* e = tab_at(row, 1, nl);
            ya = e[0];
            yb = e[W];
          } else if (row < B) {  // the entries of the two groups' windows
            ya = tab_at(row, __ldg(&wins[lc(R_GIDA, nl) * NW + wi]), nl)[0];
            yb = tab_at(row, __ldg(&wins[lc(R_GIDB, nl) * NW + wi]), nl)[W];
          }
          tc::vt_slot(s, nl, mt) = ya | (yb << 16);
        }
    }
    tc::mont_mul2<true, true, 2>(
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
      for (int nl = 0; nl < TC_NL; ++nl)
#pragma unroll
        for (int mt = 0; mt < TC_MT; ++mt) {
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
  const int Wt = d.k + d.kb;
#pragma unroll
  for (int nl = 0; nl < TC_NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = lc(R_WINV, nl);
#pragma unroll
    for (int mt = 0; mt < TC_MT; ++mt) {
      int row = row0 + 8 * mt;
      if (row < B) {
        if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[nl][mt];
        if (j < d.kb)
          out[(size_t)row * Wt + d.k + j] = (int)tc::mulmod_b<true>(s, p, nl, accB[nl][mt], winv);
      }
    }
  }
}

// T1, T2: [4][KC][W/16][32][2] words of B fragments, T1a: [KC][2][32][2], T1's
// alpha columns (ops/cuda_rns2._tc_pack);
// tab: [B][16][2][W] uint16 scratch.
extern "C" int rns_modexp2f_tc_launch(const void* ct, const void* wins, const void* rowc,
                                      const void* T1, const void* T2, const void* T1a,
                                      const void* Cin,
                                      void* tab, void* out, int B, int L, int NW, int k,
                                      int kb, int W, void* stream) {
  if (L > MAX_LIN || B <= 0) return (int)cudaErrorInvalidValue;
  tc::Dims d{k, kb, W, (k + 31) / 32};
  if (!tc::dims_fit<TcL>(d, 2)) return (int)cudaErrorInvalidValue;
  const int smem = TcL::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rns_modexp2f_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (B + TcL::ROWS - 1) / TcL::ROWS;
  rns_modexp2f_tc_kernel<<<clusters * TcL::CLUSTER, tc::threads<TcL>(d), smem,
                           (cudaStream_t)stream>>>(
      (const int*)ct, (const int*)wins, (const uint32_t*)rowc, (const uint32_t*)T1,
      (const uint32_t*)T2, (const uint32_t*)T1a, (const int2*)Cin, (uint16_t*)tab, (int*)out,
      B, L, NW, d);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a tensor-core launch of the narrow (0), wide (1)
// or small (2) layout (laid out for its widest set), and how many clusters of
// the K3 kernel fit the card at once.
extern "C" int rns_tc_smem_bytes(int layout) {
  return layout == 2 ? tc::Small::SMEM_BYTES
         : layout == 1 ? tc::Wide::SMEM_BYTES : tc::Narrow::SMEM_BYTES;
}

extern "C" int rns_modexp2f_tc_max_clusters(int k, int kb, int W) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  return tc::dims_fit<TcL>(d, 2) ? tc::max_active_clusters<TcL>(rns_modexp2f_tc_kernel, d) : -1;
}
