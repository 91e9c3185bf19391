// K7 — grouped raw Montgomery product a*b*R15^{-1} mod n, R15 = 2^(15 L).
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_mont_raw /
// _mont_raw_kernel (through _binary_pallas).  Its one user is the CIOS CRT
// decrypt, which folds the high half of a ciphertext into both residue
// systems with it (x_hi * R^2 * R^{-1} = x_hi * R mod p^2, q^2).
//
// mont_raw32_kernel multiplies on 32-bit words (cios_mont_mul32.cuh, K6's
// device functions), L32 = ceil((15 L + 2) / 32) words, L32^2 word steps
// instead of the L^2 limb steps of the port's first, 15-bit form (removed;
// PERF.md has its times), ROW_LANES = 16 lanes a row.  With R32 = 2^(32 L32) = R15 * 2^d, d = 32 L32 - 15 L, the kernel
// reads a into words already multiplied by 2^d (a shift of the digits' bit
// positions in the radix conversion), so that ONE product gives the
// function: mont32(a 2^d, b) = a b 2^d / R32 = a b R15^{-1} mod n, with no
// constant to derive (the other way, mont32(a, b) then d doublings mod n,
// is timed by tools/k47_forms.py).  A conditional subtract and the way back
// to limbs follow: the output is the CANONICAL value, below n with digits
// below 2^15.  That meets the reference's contract (a value < 2n congruent
// to a*b*R^{-1}, digits <= 2^15; tests/test_pallas_kernels.py) and the input
// contract of its user, bigint.mod_fold_combine (< 2m, digits <= 2^15).
//
// Bounds, from mont_mul's (any shared operand below R32, register operand b
// with b + n < R32, result below a*b/R32 + n): a is a value below R15 (its
// digits may be redundant, up to 2^15), so a 2^d fits the L32 words; b is
// below R15 < R32 / 4, and the result is below a b / R15 + n, below 2n
// where a b < R15 n — the reference's own condition, which its caller meets
// (x_hi < R15 times r2 < n).
//
// Bound by the integer multiply pipe: one product of L32^2 word steps of
// four 32 x 32 products a row; the row reads and writes are 3 * L words.
// Operands stay [G][B][L], blockIdx.y is the group, b is read through its
// strides (a stride of 0 shares one row with the whole batch or group), rows
// beyond B are masked.

#include "cios_mont_mul32.cuh"

namespace cios32 {

template <int TPI, int W>
__global__ void __launch_bounds__(THREADS)
mont_raw32_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
                  long long b_bs, const int* __restrict__ n, int* __restrict__ out, int B,
                  int L) {
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
  const size_t at = ((size_t)g * B + row) * L;

  uint32_t nn[W], x[W], y[W];
  limbs_to_words<TPI, W>(n + (size_t)g * L, L, lane, gl, nn);
  const uint32_t n0 = neg_inv32(__shfl_sync(FULL, nn[0], 0, TPI));
  limbs_to_words<TPI, W>(a + at, L, lane, gl, x, 32 * L32 - 15 * L);
  limbs_to_words<TPI, W>(b + g * b_gs + row * b_bs, L, lane, gl, y);
  stage<TPI, W>(sa, gl, x);
  mont_mul<TPI, W>(sa, y, nn, n0, L32, lane, gl, x);  // a b R15^-1 mod n, < 2n
  cond_sub<TPI, W>(x, nn, lane, gl);
  stage<TPI, W>(sa, gl, x);
  if (live) words_to_limbs<TPI, W>(sa, L, gl, out + at);
}

}  // namespace cios32

extern "C" int mont_raw_launch(const void* a, const void* b, long long b_gs,
                               long long b_bs, const void* n, void* out, int G, int B,
                               int L, void* stream) {
  using namespace cios32;
  const int w = w_for(L);
  if (w == 0 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = THREADS / ROW_LANES;
  dim3 grid((B + ROWS - 1) / ROWS, G);
#define CALL(W)                                                                 \
  mont_raw32_kernel<ROW_LANES, W><<<grid, THREADS, 0, (cudaStream_t)stream>>>(        \
      (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n, (int*)out, B, L)
  CIOS32_DISPATCH_W(w, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

