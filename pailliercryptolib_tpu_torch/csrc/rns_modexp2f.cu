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

#include "rns_mont_mul.cuh"

using namespace prns;

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
