// K4 — grouped modular product a*b mod n, canonical 15-bit limbs out.
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_mod_mul /
// _mod_mul_kernel (through _binary_pallas), with its device functions
// _mont_mul, _canonicalize and _cond_sub.  The reference transposes to a
// limb-major layout to put the batch on the TPU's lane axis; that is a lane
// layout device and is not carried over: operands stay [G][B][L].
//
// On this card: the kernel serves two widths.  The decrypt tails call it at
// the width of p and n (L = 69, 137 for a 2048-bit key), the CIOS backend at
// the width of n^2 (L = 274, up to 547) for every encrypt, CT+CT and
// obfuscation.
//
// mod_mul32_kernel multiplies on 32-bit words (cios_mont_mul32.cuh, K6's
// device functions): L32 = ceil((15 L + 2) / 32) words, L32^2 word steps a
// product instead of the L^2 limb steps of the port's first, 15-bit form
// (removed; PERF.md has its times), ROW_LANES = 16 lanes a row.  The interface's constants are
// the 15-bit ones (r2 = R15^2 mod n, R15 = 2^(15 L)); with R32 = 2^(32 L32)
// = R15 * 2^d, d = 32 L32 - 15 L (2..33), the kernel needs no 32-bit
// constant: it reads a and b into words already multiplied by 2^d (a shift
// of the digits' bit positions in the radix conversion), and
//   x1 = mont32(a 2^d, r2) = a 2^d R15^2 / R32     = a R15 mod n, < 2n
//   x2 = mont32(b 2^d, x1) = b 2^d a R15 / R32     = a b mod n,   < 3n
// then two conditional subtracts and the way back to canonical limbs.  So a
// row's prologue is the radix conversion alone: deriving R32^2 mod n from r2
// would take 2d dependent doublings mod n (42 at L = 69, as long as the two
// products; tools/k47_forms.py times both).  n0inv32 comes from n's low word
// by Newton's iteration; the interface's n0inv is the 15-bit one and unused.
//
// Bounds, from mont_mul's (any shared operand below R32, register operand b
// with b + n < R32, result below a*b/R32 + n): a and b are values below R15
// (every caller: ops/paillier_ops.py decrypt_crt_rns_op and hensel_post_stage
// pass canonical limbs of values below 2^(15 L) — mul_low's low half, a
// difference mod q, the CIOS pipelines' canonical ciphertexts and modexp
// outputs — and `mod_mul` says so), so a 2^d and b 2^d lie below R32 and fit
// the L32 words; x1's register operand r2 < n, x2's is x1 < 2n, so the
// accumulator stays below 3n < R32, and x2 < R32 2n / R32 + n = 3n.
//
// Bound by the integer multiply pipe: two products of L32^2 word steps of
// four 32 x 32 products each a row; the row reads and writes are 3 * L
// words.  b is read through its strides (0 shares one row); rows beyond B
// are masked.

#include "cios_mont_mul32.cuh"

namespace cios32 {

template <int TPI, int W>
__global__ void __launch_bounds__(THREADS)
mod_mul32_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
                 long long b_bs, const int* __restrict__ n, const int* __restrict__ r2,
                 int* __restrict__ out, int B, int L) {
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
  const int d = 32 * L32 - 15 * L;
  uint32_t* sa = sa_all[r];
  const size_t at = ((size_t)g * B + row) * L;

  uint32_t nn[W], x[W], y[W];
  limbs_to_words<TPI, W>(n + (size_t)g * L, L, lane, gl, nn);
  const uint32_t n0 = neg_inv32(__shfl_sync(FULL, nn[0], 0, TPI));
  limbs_to_words<TPI, W>(r2 + (size_t)g * L, L, lane, gl, y);
  limbs_to_words<TPI, W>(a + at, L, lane, gl, x, d);
  stage<TPI, W>(sa, gl, x);
  mont_mul<TPI, W>(sa, y, nn, n0, L32, lane, gl, x);  // a R15 mod n, < 2n
  limbs_to_words<TPI, W>(b + g * b_gs + row * b_bs, L, lane, gl, y, d);
  stage<TPI, W>(sa, gl, y);
  mont_mul<TPI, W>(sa, x, nn, n0, L32, lane, gl, y);  // a b mod n, < 3n
  cond_sub<TPI, W>(y, nn, lane, gl);
  cond_sub<TPI, W>(y, nn, lane, gl);
  stage<TPI, W>(sa, gl, y);
  if (live) words_to_limbs<TPI, W>(sa, L, gl, out + ((size_t)g * B + row) * L);
}

}  // namespace cios32

extern "C" int mod_mul_launch(const void* a, const void* b, long long b_gs,
                              long long b_bs, const void* n, const void* r2, void* out,
                              int G, int B, int L, void* stream) {
  using namespace cios32;
  const int w = w_for(L);
  if (w == 0 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  constexpr int ROWS = THREADS / ROW_LANES;
  dim3 grid((B + ROWS - 1) / ROWS, G);
#define CALL(W)                                                                 \
  mod_mul32_kernel<ROW_LANES, W><<<grid, THREADS, 0, (cudaStream_t)stream>>>(        \
      (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n, (const int*)r2,  \
      (int*)out, B, L)
  CIOS32_DISPATCH_W(w, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
