// K7 — grouped raw Montgomery product a*b*R^{-1} mod n on 15-bit limbs:
// redundant digits <= 2^15, value < 2n, no final subtract.
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_mont_raw /
// _mont_raw_kernel (through _binary_pallas).  Its one user is the CIOS CRT
// decrypt, which folds the high half of a ciphertext into both residue
// systems with it (x_hi * R^2 * R^{-1} = x_hi * R mod p^2, q^2).
//
// On this card: one warp a row, the digits spread over its lanes
// (cios_mont_mul.cuh); operands stay [G][B][L], blockIdx.y is the group, b
// is read through its strides (a stride of 0 shares one row with the whole
// batch or group), rows beyond B are masked.  One product a row: bound by
// integer instruction throughput, L^2 limb steps of about 10 instructions;
// the row reads and writes are 3 * L words.  The digit schedule is the
// reference's, so the output equals ops/montgomery.mont_mul digit for digit.

#include "cios_mont_mul.cuh"

namespace cios {

template <int LPT>
__global__ void __launch_bounds__(THREADS)
mont_raw_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
                long long b_bs, const int* __restrict__ n,
                const int* __restrict__ n0inv, int* __restrict__ out, int B, int L) {
  __shared__ uint32_t sa_all[WARPS][32 * LPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;  // the whole warp leaves: no block-wide barrier below
  uint32_t* sa = sa_all[warp];
  const size_t at = ((size_t)g * B + row) * L;
  uint32_t nn[LPT], x[LPT], y[LPT], acc[LPT];
  load_digits<LPT>(n + (size_t)g * L, L, lane, nn);
  load_digits<LPT>(a + at, L, lane, x);
  load_digits<LPT>(b + g * b_gs + row * b_bs, L, lane, y);
  stage<LPT>(sa, lane, x);
  mont_mul<LPT>(sa, y, nn, (uint32_t)n0inv[g], L, lane, acc);
  store_digits<LPT>(out + at, L, lane, acc);
}

}  // namespace cios

extern "C" int mont_raw_launch(const void* a, const void* b, long long b_gs,
                               long long b_bs, const void* n, const void* n0inv,
                               void* out, int G, int B, int L, void* stream) {
  using namespace cios;
  const int lpt = lpt_for(L);
  if (lpt == 0 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((B + WARPS - 1) / WARPS, G);
#define CALL(N)                                                               \
  mont_raw_kernel<N><<<grid, THREADS, 0, (cudaStream_t)stream>>>(             \
      (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n,                \
      (const int*)n0inv, (int*)out, B, L)
  CIOS_DISPATCH_LPT(lpt, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
