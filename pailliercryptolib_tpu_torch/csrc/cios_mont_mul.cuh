// Shared device functions of the port's first, 15-bit forms of the CIOS
// kernels (K4 mod_mul.cu, K6 modexp.cu, K7 mont_raw.cu; since the 32-bit
// forms of cios_mont_mul32.cuh replaced them, reached only through the
// *15_launch functions, to time the two forms in turns): the redundant-digit
// Montgomery product a*b*R^{-1} mod n on 15-bit limbs, the carry resolve and
// the conditional subtract.
//
// Replaces: the JAX package's ops/pallas_modexp.py _mont_mul, _carry_round,
// _canonicalize and _cond_sub, the device functions under its three kernels.
// The reference lays the limbs on the sublane axis and 128 batch rows on the
// lane axis and walks the limbs with pltpu.roll; that is a lane layout
// device and is not carried over.
//
// On this card: ONE WARP WORKS ON ONE ROW.  A product costs L^2 limb steps
// (L = 274 for n^2 of a 2048-bit key, up to 547), so one thread a row would
// leave the card at a few thousand threads; instead the L+1 accumulator
// digits are spread over the 32 lanes of a warp, LPT consecutive digits in
// the registers of each lane (digit l lives in lane l / LPT, register
// l % LPT; 32 * LPT >= L + 1).  One CIOS step is then elementwise over the
// lanes, plus
//   * a_i, read by every lane from a copy of a in shared memory (a broadcast
//     read, no bank conflict),
//   * digit 0 of the accumulator, broadcast from lane 0 by one shuffle (m_i
//     is computed redundantly in every lane), and
//   * the shift down by one digit: inside a lane it is a renaming of
//     registers, across lanes one shuffle of the lane's lowest digit.
// The digit schedule is the reference's (carries deferred: a digit gains
// about 2^17 a step and stays below 2^27 at L = 547; two carry rounds at the
// end), so the raw product equals ops/montgomery.mont_mul digit for digit.
// The carry resolve and the conditional subtract are sequential over L in
// the reference; here each lane resolves its own digits and the carries
// between lanes come from one ballot each (generate / propagate masks and a
// 64-bit add), so they cost O(LPT) and no loop over L.
//
// Bound by integer instruction throughput: about 10 instructions per limb
// step, no memory traffic inside a product.  Everything is uint32_t: m_i
// relies on 32-bit wrap-around.  All 32 lanes of a warp run every function
// here together.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cios {

constexpr int LIMB_BITS = 15;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;             // rows a thread block works on
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_LPT = 18;          // 32 * 18 = 576 >= 547 + 1
constexpr int MAX_L = 547;           // n^2 of a 4096-bit key

// Digits [lane*LPT, lane*LPT + LPT) of a row of L words into registers,
// zeros beyond L.
template <int LPT>
__device__ __forceinline__ void load_digits(const int* __restrict__ src, int L,
                                            int lane, uint32_t (&x)[LPT]) {
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = lane * LPT + j;
    x[j] = l < L ? (uint32_t)src[l] : 0u;
  }
}

template <int LPT>
__device__ __forceinline__ void store_digits(int* __restrict__ dst, int L, int lane,
                                             const uint32_t (&x)[LPT]) {
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int l = lane * LPT + j;
    if (l < L) dst[l] = (int)x[j];
  }
}

// Copy a row's digits from registers to the warp's shared-memory row, where
// mont_mul reads a_i from.  The barriers order it against the reads of the
// product before and the reads of the product after.
template <int LPT>
__device__ __forceinline__ void stage(uint32_t* sa, int lane, const uint32_t (&x)[LPT]) {
  __syncwarp();
#pragma unroll
  for (int j = 0; j < LPT; ++j) sa[lane * LPT + j] = x[j];
  __syncwarp();
}

// acc <- a*b*R^{-1} mod n, R = 2^(15 L): digits <= 2^15, value < 2n, digit L
// and above zero.  a is read from shared memory (sa[0..L)), b and n from
// registers (zeros beyond L).  acc must not alias b.
template <int LPT>
__device__ __forceinline__ void mont_mul(const uint32_t* sa, const uint32_t (&b)[LPT],
                                         const uint32_t (&n)[LPT], uint32_t n0inv,
                                         int L, int lane, uint32_t (&acc)[LPT]) {
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = 0;
  const uint32_t b0 = __shfl_sync(FULL, b[0], 0);
#pragma unroll 2
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = sa[i];
    const uint32_t acc0 = __shfl_sync(FULL, acc[0], 0);
    const uint32_t mi = ((acc0 + ai * b0) * n0inv) & LIMB_MASK;
    uint32_t lo[LPT], hi[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t p1 = ai * b[j], p2 = mi * n[j];
      lo[j] = (p1 & LIMB_MASK) + (p2 & LIMB_MASK);
      hi[j] = (p1 >> LIMB_BITS) + (p2 >> LIMB_BITS);
    }
    // lo enters column l, hi column l+1; then everything moves down one
    // digit (column 0 is resolved: its low 15 bits are zero by choice of mi)
    const uint32_t u0 = acc[0] + lo[0];
    uint32_t from_next = __shfl_down_sync(FULL, u0, 1);
    if (lane == 31) from_next = 0;
#pragma unroll
    for (int j = 0; j + 1 < LPT; ++j) acc[j] = acc[j + 1] + lo[j + 1] + hi[j];
    acc[LPT - 1] = from_next + hi[LPT - 1];
    if (lane == 0) acc[0] += u0 >> LIMB_BITS;
  }
  // two redundant carry rounds: digits <= 2^15
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    uint32_t carry = __shfl_up_sync(FULL, acc[LPT - 1] >> LIMB_BITS, 1);
    if (lane == 0) carry = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const uint32_t v = acc[j];
      acc[j] = (v & LIMB_MASK) + carry;
      carry = v >> LIMB_BITS;
    }
  }
}

// Carries (or borrows) into every lane from the lanes' generate / propagate
// flags: bit t of the result enters lane t, bit 32 leaves the top lane.
// c_{t+1} = g_t | (p_t & c_t) is the carry chain of the addition U + V with
// U = G | P and V = G.
__device__ __forceinline__ uint64_t lane_carries(bool g, bool p) {
  const uint64_t G = __ballot_sync(FULL, g);
  const uint64_t U = G | (uint64_t)__ballot_sync(FULL, p);
  return (U + G) ^ U ^ G;
}

// Full carry propagation: digits <= 2^15 -> canonical digits < 2^15.
template <int LPT>
__device__ __forceinline__ void canonicalize(uint32_t (&x)[LPT], int lane) {
  uint32_t c = 0;
  bool all_ones = true;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const uint32_t t = x[j] + c;
    x[j] = t & LIMB_MASK;
    c = t >> LIMB_BITS;
    all_ones = all_ones && x[j] == LIMB_MASK;
  }
  c = (uint32_t)(lane_carries(c != 0, all_ones) >> lane) & 1u;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const uint32_t t = x[j] + c;
    x[j] = t & LIMB_MASK;
    c = t >> LIMB_BITS;
  }
}

// x <- x - n if x >= n, else x; canonical digits.
template <int LPT>
__device__ __forceinline__ void cond_sub(uint32_t (&x)[LPT], const uint32_t (&n)[LPT],
                                         int lane) {
  uint32_t d[LPT];
  uint32_t borrow = 0;
  bool all_zero = true;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const uint32_t sub = n[j] + borrow;
    borrow = x[j] < sub ? 1u : 0u;
    d[j] = (x[j] - sub) & LIMB_MASK;
    all_zero = all_zero && d[j] == 0;
  }
  const uint64_t borrows = lane_carries(borrow != 0, all_zero);
  uint32_t c = (uint32_t)(borrows >> lane) & 1u;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const uint32_t t = d[j] - c;
    c = d[j] < c ? 1u : 0u;
    d[j] = t & LIMB_MASK;
  }
  if (((borrows >> 32) & 1u) == 0) {  // no borrow out of the top: x >= n
#pragma unroll
    for (int j = 0; j < LPT; ++j) x[j] = d[j];
  }
}

// Smallest compiled digits-per-lane count that holds L + 1 digits, or 0.
inline int lpt_for(int L) {
  if (L < 1 || L > MAX_L) return 0;
  const int need = (L + 1 + 31) / 32;
  const int have[] = {1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 14, 16, 18};
  for (int v : have)
    if (v >= need) return v;
  return 0;
}

// Run `CALL(LPT)` for the compiled LPT that lpt_for chose.
#define CIOS_DISPATCH_LPT(lpt, CALL) \
  switch (lpt) {                     \
    case 1: CALL(1); break;          \
    case 2: CALL(2); break;          \
    case 3: CALL(3); break;          \
    case 4: CALL(4); break;          \
    case 5: CALL(5); break;          \
    case 6: CALL(6); break;          \
    case 8: CALL(8); break;          \
    case 9: CALL(9); break;          \
    case 10: CALL(10); break;        \
    case 12: CALL(12); break;        \
    case 14: CALL(14); break;        \
    case 16: CALL(16); break;        \
    case 18: CALL(18); break;        \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace cios
