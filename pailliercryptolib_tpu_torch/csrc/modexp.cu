// K6 — grouped windowed modexp base^e mod n: to Montgomery form, a 16-entry
// power table, NW 4-bit windows most significant first (4 squarings, a
// 16-way select and one product each), leave Montgomery form, conditional
// subtract.  Takes and returns 15-bit limbs; output canonical, < n.
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_modexp /
// _modexp_kernel, the kernel behind the public modexp API and every modexp
// of the CIOS backend (DJN and normal-mode obfuscators, CT*PT, both halves
// of the CRT decrypt as groups 0 and 1, the RAW decrypt).
//
// modexp32_kernel converts the operands into 32-bit words in the kernel and
// multiplies on them (cios_mont_mul32.cuh), L32^2 word steps a product
// instead of the L^2 limb steps of the port's first, 15-bit form (removed;
// PERF.md has its times).  The interface's constants are the 15-bit ones
// (r2 = R15^2 mod n, one = R15 mod n, R15 = 2^(15 L)); a row derives the
// 32-bit ones in its prologue: n0inv32 by Newton's iteration from n's low
// word, and with d = 32 L32 - 15 L, R32 mod n as `one` doubled d times mod n
// and R32^2 mod n as r2 doubled 2d times mod n (at most 99 doublings,
// against 16 + 5 NW products).
//
// On this card: ROW_LANES = 16 lanes work on one row (two rows a warp), its
// words spread over them; operands stay [G][B][L], blockIdx.y is the group,
// rows beyond B are masked.  Base and windows are read through their
// strides: a stride of 0 shares one base (the DJN hs) or one exponent (n,
// p-1 / q-1, lambda, a scalar plaintext) with the whole batch, no copies.
// Bound by the integer multiply pipe: 16 + 5 * NW products a row of L32^2
// word steps of four 32 x 32 products each; nothing but the select touches
// memory.
//
// The power table (16 * ROW_LANES * W words a row: 9 KB at L32 = 129, 17 KB
// at 257) lives in global scratch the wrapper allocates, laid out
// [row][entry][register][lane] so that every access is one coalesced line
// a register; the L2 serves it.  (In shared memory, the 16 rows an SM holds
// at batch 2048 would take 272 KB at 257 words, more than an SM has; 147 KB
// at 129 words would fit, untried.)  THE SELECT READS ALL 16 ENTRIES and keeps the
// one whose index equals the window, as the reference's _select_pow does:
// the addresses do not depend on the exponent, which is the secret r of a
// row in DJN encryption.  Its cost, 16 * W loads a window, is small beside
// the window's 5 * L32 word steps.

#include "cios_mont_mul32.cuh"

namespace cios32 {

constexpr int TABLE = 16;

template <int TPI, int W>
__global__ void __launch_bounds__(THREADS)
modexp32_kernel(const int* __restrict__ base, long long base_gs, long long base_bs,
                const int* __restrict__ wins, long long win_gs, long long win_bs,
                const int* __restrict__ n, const int* __restrict__ r2,
                const int* __restrict__ one, int* __restrict__ out,
                uint32_t* __restrict__ table, int B, int L, int NW) {
  constexpr int ROWS = THREADS / TPI;
  __shared__ uint32_t sa_all[ROWS][TPI * W];
  const int lane = threadIdx.x & 31, gl = threadIdx.x % TPI;
  const int r = threadIdx.x / TPI;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  // a warp whose rows all lie beyond B leaves whole; a row beyond B in a
  // warp that stays works on row B - 1 and stores nothing
  if (row0 + (threadIdx.x & ~31) / TPI >= B) return;
  const bool live = row0 + r < B;
  const int row = live ? row0 + r : B - 1;
  const int L32 = words_for(L);
  uint32_t* sa = sa_all[r];
  // entry t, register j of this lane: tab[(t * W + j) * TPI]
  uint32_t* tab = table + (((size_t)g * gridDim.x * ROWS + row0 + r) * TABLE * W) * TPI + gl;
  const int* w = wins + g * win_gs + row * win_bs;

  uint32_t nn[W], acc[W], bb[W], am[W];
  limbs_to_words<TPI, W>(n + (size_t)g * L, L, lane, gl, nn);
  const uint32_t n0 = neg_inv32(__shfl_sync(FULL, nn[0], 0, TPI));
  const int d = 32 * L32 - 15 * L;

  // to Montgomery form: base * (R15^2 * 2^(2d) = R32^2) * R32^-1
  limbs_to_words<TPI, W>(r2 + (size_t)g * L, L, lane, gl, bb);
#pragma unroll 1
  for (int k = 0; k < 2 * d; ++k) dbl_mod<TPI, W>(bb, nn, lane, gl);
  limbs_to_words<TPI, W>(base + g * base_gs + row * base_bs, L, lane, gl, acc);
  stage<TPI, W>(sa, gl, acc);
  mont_mul<TPI, W>(sa, bb, nn, n0, L32, lane, gl, am);
  // the power table a^0 .. a^15; a^0 = R32 mod n = (R15 mod n) * 2^d mod n
  limbs_to_words<TPI, W>(one + (size_t)g * L, L, lane, gl, bb);
#pragma unroll 1
  for (int k = 0; k < d; ++k) dbl_mod<TPI, W>(bb, nn, lane, gl);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    tab[(0 * W + j) * TPI] = bb[j];
    tab[(1 * W + j) * TPI] = am[j];
    acc[j] = am[j];
  }
#pragma unroll 1
  for (int t = 2; t < TABLE; ++t) {
    stage<TPI, W>(sa, gl, acc);
    mont_mul<TPI, W>(sa, am, nn, n0, L32, lane, gl, acc);
#pragma unroll
    for (int j = 0; j < W; ++j) tab[(t * W + j) * TPI] = acc[j];
  }

  // left-to-right fixed-window loop; acc starts as the Montgomery form of 1
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = bb[j];
#pragma unroll 1
  for (int k = 0; k < NW; ++k) {
    const uint32_t wk = (uint32_t)w[k];
#pragma unroll 1
    for (int s = 0; s < 5; ++s) {
      if (s < 4) {  // a squaring
#pragma unroll
        for (int j = 0; j < W; ++j) bb[j] = acc[j];
      } else {  // the product with the selected power
#pragma unroll
        for (int j = 0; j < W; ++j) bb[j] = 0;
#pragma unroll 1
        for (int t = 0; t < TABLE; ++t) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const uint32_t v = tab[(t * W + j) * TPI];
            bb[j] = wk == (uint32_t)t ? v : bb[j];
          }
        }
      }
      stage<TPI, W>(sa, gl, acc);
      mont_mul<TPI, W>(sa, bb, nn, n0, L32, lane, gl, am);
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = am[j];
    }
  }

  // leave Montgomery form (a product with plain 1), < n, back to 15-bit limbs
#pragma unroll
  for (int j = 0; j < W; ++j) bb[j] = (gl == 0 && j == 0) ? 1u : 0u;
  stage<TPI, W>(sa, gl, acc);
  mont_mul<TPI, W>(sa, bb, nn, n0, L32, lane, gl, am);
  cond_sub<TPI, W>(am, nn, lane, gl);
  stage<TPI, W>(sa, gl, am);
  if (live) words_to_limbs<TPI, W>(sa, L, gl, out + ((size_t)g * B + row) * L);
}

// Rows of table scratch a launch at B rows takes (whole blocks).
inline long long padded_rows(int B) {
  constexpr int ROWS = THREADS / ROW_LANES;
  return (long long)(B + ROWS - 1) / ROWS * ROWS;
}

}  // namespace cios32

// Words of table scratch a launch at (G, B, L) needs; 0 if L is not served.
extern "C" long long modexp_table_words(int G, int B, int L) {
  using namespace cios32;
  return (long long)G * padded_rows(B) * TABLE * w_for(L) * ROW_LANES;
}

extern "C" int modexp_launch(const void* base, long long base_gs, long long base_bs,
                             const void* wins, long long win_gs, long long win_bs,
                             const void* n, const void* r2, const void* one, void* out,
                             void* table, int G, int B, int L, int NW, void* stream) {
  using namespace cios32;
  const int w = w_for(L);
  if (w == 0 || G < 1 || B < 1 || NW < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(padded_rows(B) / (THREADS / ROW_LANES)), G);
#define CALL(W)                                                                   \
  modexp32_kernel<ROW_LANES, W><<<grid, THREADS, 0, (cudaStream_t)stream>>>(      \
      (const int*)base, base_gs, base_bs, (const int*)wins, win_gs, win_bs,       \
      (const int*)n, (const int*)r2, (const int*)one, (int*)out, (uint32_t*)table, \
      B, L, NW)
  CIOS32_DISPATCH_W(w, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
