// K4 — grouped modular product a*b mod n on 15-bit limbs, canonical output:
// two redundant-digit CIOS Montgomery products (through R^2), a carry
// resolve and one conditional subtract.
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
// obfuscation.  One warp works on one row with the digits spread over its
// lanes (cios_mont_mul.cuh, shared with K6 and K7), so the row's digits stay
// in registers at every width; b is read through its strides (0 shares one
// row).  Bound by integer instruction throughput: 2 * L^2 limb steps a row;
// the row reads and writes are 3 * L words.  The output is canonical and
// fully reduced, so it does not depend on the digit schedule.

#include "cios_mont_mul.cuh"

namespace cios {

template <int LPT>
__global__ void __launch_bounds__(THREADS)
mod_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
               long long b_bs, const int* __restrict__ n,
               const int* __restrict__ n0inv, const int* __restrict__ r2,
               int* __restrict__ out, int B, int L) {
  __shared__ uint32_t sa_all[WARPS][32 * LPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;  // the whole warp leaves: no block-wide barrier below
  uint32_t* sa = sa_all[warp];
  const uint32_t n0 = (uint32_t)n0inv[g];
  const size_t at = ((size_t)g * B + row) * L;
  uint32_t nn[LPT], x[LPT], y[LPT], acc[LPT];
  load_digits<LPT>(n + (size_t)g * L, L, lane, nn);
  load_digits<LPT>(a + at, L, lane, x);
  load_digits<LPT>(r2 + (size_t)g * L, L, lane, y);
  stage<LPT>(sa, lane, x);
  mont_mul<LPT>(sa, y, nn, n0, L, lane, acc);  // a * R mod n
  load_digits<LPT>(b + g * b_gs + row * b_bs, L, lane, y);
  stage<LPT>(sa, lane, acc);
  mont_mul<LPT>(sa, y, nn, n0, L, lane, x);    // a * b mod n, value < 2n
  canonicalize<LPT>(x, lane);
  cond_sub<LPT>(x, nn, lane);
  store_digits<LPT>(out + at, L, lane, x);
}

}  // namespace cios

extern "C" int mod_mul_launch(const void* a, const void* b, long long b_gs,
                              long long b_bs, const void* n, const void* n0inv,
                              const void* r2, void* out, int G, int B, int L,
                              void* stream) {
  using namespace cios;
  const int lpt = lpt_for(L);
  if (lpt == 0 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((B + WARPS - 1) / WARPS, G);
#define CALL(N)                                                              \
  mod_mul_kernel<N><<<grid, THREADS, 0, (cudaStream_t)stream>>>(             \
      (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n,               \
      (const int*)n0inv, (const int*)r2, (int*)out, B, L)
  CIOS_DISPATCH_LPT(lpt, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
