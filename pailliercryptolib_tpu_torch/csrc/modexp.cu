// K6 — grouped windowed modexp base^e mod n on 15-bit limbs: to Montgomery
// form, a 16-entry power table, NW 4-bit windows most significant first
// (4 squarings, a 16-way select and one product each), leave Montgomery
// form, carry resolve, conditional subtract.  Output canonical, < n.
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_modexp /
// _modexp_kernel, the kernel behind the public modexp API and every modexp
// of the CIOS backend (DJN and normal-mode obfuscators, CT*PT, both halves
// of the CRT decrypt as groups 0 and 1, the RAW decrypt).
//
// On this card: one warp works on one row, its digits spread over the lanes
// (cios_mont_mul.cuh); operands stay [G][B][L], blockIdx.y is the group,
// rows beyond B are masked.  Base and windows are read through their
// strides: a stride of 0 shares one base (the DJN hs) or one exponent (n,
// p-1 / q-1, lambda, a scalar plaintext) with the whole batch, no copies.
// Bound by integer instruction throughput: 16 + 5 * NW products a row of L^2
// limb steps each, about 10 instructions a step, nothing but the select
// touches memory.
//
// The power table (16 * L words a row; 35 KB at L = 547) does not fit in
// shared memory for more than a few rows, so it lives in global scratch the
// wrapper allocates, laid out [row][entry][register][lane] so that every
// access is one coalesced 128-byte line a register; the L2 serves it.
// THE SELECT READS ALL 16 ENTRIES and keeps the one whose index equals the
// window, as the reference's _select_pow does: the addresses do not depend
// on the exponent, which is the secret r of a row in DJN encryption.  Its
// cost, 16 * LPT loads a window, is small beside the 5 * L * LPT * 10
// instructions of the window's products.

#include "cios_mont_mul.cuh"

namespace cios {

constexpr int TABLE = 16;

template <int LPT>
__global__ void __launch_bounds__(THREADS)
modexp_kernel(const int* __restrict__ base, long long base_gs, long long base_bs,
              const int* __restrict__ wins, long long win_gs, long long win_bs,
              const int* __restrict__ n, const int* __restrict__ n0inv,
              const int* __restrict__ r2, const int* __restrict__ one,
              int* __restrict__ out, uint32_t* __restrict__ table, int B, int L,
              int NW) {
  __shared__ uint32_t sa_all[WARPS][32 * LPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;  // the whole warp leaves: no block-wide barrier below
  uint32_t* sa = sa_all[warp];
  const uint32_t n0 = (uint32_t)n0inv[g];
  const size_t grow = (size_t)g * B + row;
  // entry t, register j of this lane: tab[(t * LPT + j) * 32]
  uint32_t* tab = table + grow * (size_t)(TABLE * LPT * 32) + lane;
  const int* w = wins + g * win_gs + row * win_bs;

  uint32_t nn[LPT], acc[LPT], bb[LPT], am[LPT];
  load_digits<LPT>(n + (size_t)g * L, L, lane, nn);

  // to Montgomery form, and the power table a^0 .. a^15
  load_digits<LPT>(base + g * base_gs + row * base_bs, L, lane, acc);
  load_digits<LPT>(r2 + (size_t)g * L, L, lane, bb);
  stage<LPT>(sa, lane, acc);
  mont_mul<LPT>(sa, bb, nn, n0, L, lane, am);
  load_digits<LPT>(one + (size_t)g * L, L, lane, bb);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    tab[(0 * LPT + j) * 32] = bb[j];
    tab[(1 * LPT + j) * 32] = am[j];
    acc[j] = am[j];
  }
#pragma unroll 1
  for (int t = 2; t < TABLE; ++t) {
    stage<LPT>(sa, lane, acc);
    mont_mul<LPT>(sa, am, nn, n0, L, lane, bb);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      acc[j] = bb[j];
      tab[(t * LPT + j) * 32] = bb[j];
    }
  }

  // left-to-right fixed-window loop; acc starts as the Montgomery form of 1
  load_digits<LPT>(one + (size_t)g * L, L, lane, acc);
#pragma unroll 1
  for (int k = 0; k < NW; ++k) {
    const uint32_t wk = (uint32_t)w[k];
#pragma unroll 1
    for (int s = 0; s < 5; ++s) {
      if (s < 4) {  // a squaring
#pragma unroll
        for (int j = 0; j < LPT; ++j) bb[j] = acc[j];
      } else {  // the product with the selected power
#pragma unroll
        for (int j = 0; j < LPT; ++j) bb[j] = 0;
#pragma unroll 1
        for (int t = 0; t < TABLE; ++t) {
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            const uint32_t v = tab[(t * LPT + j) * 32];
            bb[j] = wk == (uint32_t)t ? v : bb[j];
          }
        }
      }
      stage<LPT>(sa, lane, acc);
      mont_mul<LPT>(sa, bb, nn, n0, L, lane, am);
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[j] = am[j];
    }
  }

  // leave Montgomery form (a product with plain 1), canonical, < n
#pragma unroll
  for (int j = 0; j < LPT; ++j) bb[j] = (lane == 0 && j == 0) ? 1u : 0u;
  stage<LPT>(sa, lane, acc);
  mont_mul<LPT>(sa, bb, nn, n0, L, lane, am);
  canonicalize<LPT>(am, lane);
  cond_sub<LPT>(am, nn, lane);
  store_digits<LPT>(out + grow * L, L, lane, am);
}

}  // namespace cios

// Words of table scratch a launch at (G, B, L) needs; 0 if L is not served.
extern "C" long long modexp_table_words(int G, int B, int L) {
  const int lpt = cios::lpt_for(L);
  return (long long)G * B * cios::TABLE * lpt * 32;
}

extern "C" int modexp_launch(const void* base, long long base_gs, long long base_bs,
                             const void* wins, long long win_gs, long long win_bs,
                             const void* n, const void* n0inv, const void* r2,
                             const void* one, void* out, void* table, int G, int B,
                             int L, int NW, void* stream) {
  using namespace cios;
  const int lpt = lpt_for(L);
  if (lpt == 0 || G < 1 || B < 1 || NW < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((B + WARPS - 1) / WARPS, G);
#define CALL(N)                                                               \
  modexp_kernel<N><<<grid, THREADS, 0, (cudaStream_t)stream>>>(               \
      (const int*)base, base_gs, base_bs, (const int*)wins, win_gs, win_bs,   \
      (const int*)n, (const int*)n0inv, (const int*)r2, (const int*)one,      \
      (int*)out, (uint32_t*)table, B, L, NW)
  CIOS_DISPATCH_LPT(lpt, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
