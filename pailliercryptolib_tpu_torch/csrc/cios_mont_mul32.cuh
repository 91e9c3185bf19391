// Device functions of the CIOS kernels on 32-bit words (K4 mod_mul.cu, K6
// modexp.cu, K7 mont_raw.cu): the Montgomery product a*b*R^{-1} mod n with
// R = 2^(32 L32), the lazy carries between lanes and their resolve, the
// conditional subtract, the doubling mod n that derives K6's 32-bit
// Montgomery constants, and the radix conversions between the interface's
// 15-bit limbs and 32-bit words (the way in optionally times 2^shift).
//
// Replaces: the JAX package's ops/pallas_modexp.py _mont_mul,
// _carry_round, _canonicalize and _cond_sub.  The reference runs 15-bit
// limbs because the TPU's vector unit has no 32 x 32 -> 64 multiply; Hopper
// has one (IMAD.WIDE.U32), so a product here is L32^2 word steps instead of
// L^2 limb steps: L32 = ceil((15 L + 2) / 32), 129 words against 274 limbs
// for n^2 of a 2048-bit key, 257 against 547 at the widest operand.
//
// Layout: TPI lanes work on one row (TPI divides 32: a warp holds 32 / TPI
// rows), W consecutive words in the registers of each lane (word w lives in
// lane w / W of the row's group, register w % W; TPI * W >= L32).  The
// product keeps the accumulator as one 64-bit column a word, carries not
// yet moved up.  One CIOS step i is, in every lane,
//   * a_i, read by every lane from a copy of a in shared memory,
//   * the low word of column 0 broadcast from the group's lane 0 (m_i is
//     computed redundantly in every lane from it and b_0),
//   * for each of the lane's W words two 32 x 32 -> 64 products (a_i b_j,
//     m_i n_j): their low words enter column j, their high words column
//     j + 1 — no carry runs along the lane, so the W words are independent,
//   * the shift by one word: column 0 moves to the lane below by two
//     shuffles (in lane 0 its low word is zero by the choice of m_i and its
//     high word a carry into column 1), the lane's top high words and the
//     column from above make its new top column.
// A column gains less than 2^34 a step and lives at most L32 steps, so it
// stays below 2^43.  The columns are resolved once a product: a carry along
// each lane, the lanes' carry-outs added one lane up, and the carries that
// ripple across lanes from one ballot (generate / propagate masks and a
// 64-bit add), so a product has no loop over the lanes.  In the kernel it
// runs as fast as a form with a carry chain along the lane at 65 and 129
// words (PERF.md, K6 findings), and the words of a lane are independent.
//
// Bounds (a < R, b + n < R, 4n < R): the accumulator stays below b + n < R
// inside a product and below a*b/R + n at its end (below 2n where a*b < R n),
// so L32 words hold it and the top lane's carry-out is zero.  Bound by the
// integer multiply pipe: four 32 x 32 products (two IMAD.WIDE.U32) a word
// step, and no memory traffic but the broadcast read of a_i.  All lanes of a
// warp run every function here together.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cios32 {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_L32 = 257;  // ceil((15 * 547 + 2) / 32): n^2 of a 4096-bit key

constexpr int MAX_L = 547;    // limbs the kernels take: n^2 of a 4096-bit key
constexpr int THREADS = 128;  // threads a block of every 32-bit kernel

// Words of the 32-bit form for an operand of L 15-bit limbs: 4n < R32 for
// every n < 2^(15 L).
__host__ __device__ constexpr int words_for(int L) { return (15 * L + 2 + 31) / 32; }

// Lanes on a row of every 32-bit kernel: 16 (two rows a warp) measured 10%
// faster than 32 and 13% faster than 8 in K6 at n^2 of a 2048-bit key, 13% /
// 18% at 547 limbs (tools/k6_forms.py): more words a lane give each step more
// independent work, fewer leave too few warps to hide the step's serial
// broadcast -> m_i -> shuffle.  K4 and K7, one or two products a row, measured
// it fastest or within 5% of 8 lanes at every path shape (tools/k47_forms.py;
// PERF.md).
constexpr int ROW_LANES = 16;
constexpr int MAX_W = (MAX_L32 + ROW_LANES - 1) / ROW_LANES;  // words a lane

// Smallest compiled words-a-lane count that holds L32 words, or 0.
inline int w_for(int L) {
  if (L < 1 || L > MAX_L) return 0;
  const int w = (words_for(L) + ROW_LANES - 1) / ROW_LANES;
  return w <= MAX_W ? w : 0;
}

// Run `CALL(W)` for the compiled words-a-lane count w (1..MAX_W); return
// cudaErrorInvalidValue for any other.
#define CIOS32_DISPATCH_W(w, CALL)                   \
  switch (w) {                                       \
    case 1: CALL(1); break;                          \
    case 2: CALL(2); break;                          \
    case 3: CALL(3); break;                          \
    case 4: CALL(4); break;                          \
    case 5: CALL(5); break;                          \
    case 6: CALL(6); break;                          \
    case 7: CALL(7); break;                          \
    case 8: CALL(8); break;                          \
    case 9: CALL(9); break;                          \
    case 10: CALL(10); break;                        \
    case 11: CALL(11); break;                        \
    case 12: CALL(12); break;                        \
    case 13: CALL(13); break;                        \
    case 14: CALL(14); break;                        \
    case 15: CALL(15); break;                        \
    case 16: CALL(16); break;                        \
    case 17: CALL(17); break;                        \
    default: return (int)cudaErrorInvalidValue;      \
  }

// Carries into the lanes of every group of TPI lanes from the lanes'
// generate / propagate flags, c_{t+1} = g_t | (p_t & c_t), computed as the
// carries of U + G with U = G | P.  The groups' bits are spread one bit
// apart (group k at bit k * (TPI + 1)), so that no carry crosses into the
// next group; bit k * (TPI + 1) + t enters lane t of group k, bit
// k * (TPI + 1) + TPI leaves the group's top lane.
template <int TPI>
__device__ __forceinline__ uint64_t lane_carries(bool g, bool p) {
  const uint32_t G = __ballot_sync(FULL, g), P = __ballot_sync(FULL, p);
  constexpr uint32_t MASK = TPI == 32 ? FULL : (1u << TPI) - 1;
  uint64_t Gs = 0, Ps = 0;
#pragma unroll
  for (int k = 0; k < 32 / TPI; ++k) {
    Gs |= (uint64_t)((G >> (k * TPI)) & MASK) << (k * (TPI + 1));
    Ps |= (uint64_t)((P >> (k * TPI)) & MASK) << (k * (TPI + 1));
  }
  const uint64_t U = Gs | Ps;
  return (U + Gs) ^ U ^ Gs;
}

// Bit of lane_carries' result that enters lane gl of this lane's group, and
// the one that leaves the group.
template <int TPI>
__device__ __forceinline__ int carry_bit(int lane, int gl) {
  return (lane / TPI) * (TPI + 1) + gl;
}

// Every lane's pending carry `cy` (the value at its position W, i.e. at
// word 0 of the lane above) added in: canonical words.  A carry out of the
// group's top lane is dropped (zero for every value below R).
template <int TPI, int W>
__device__ __forceinline__ void resolve(uint32_t (&x)[W], uint32_t cy, int lane, int gl) {
  uint32_t c = __shfl_up_sync(FULL, cy, 1, TPI);
  if (gl == 0) c = 0;
  bool ones = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = (uint64_t)x[j] + c;
    x[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
    ones = ones && x[j] == FULL;
  }
  c = (uint32_t)(lane_carries<TPI>(c != 0, ones) >> carry_bit<TPI>(lane, gl)) & 1u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = (uint64_t)x[j] + c;
    x[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

// Copy a row's words from registers to its shared-memory row, where
// mont_mul reads a_i from.  The barriers order it against the reads of the
// product before and after.
template <int TPI, int W>
__device__ __forceinline__ void stage(uint32_t* sa, int gl, const uint32_t (&x)[W]) {
  __syncwarp();
#pragma unroll
  for (int j = 0; j < W; ++j) sa[gl * W + j] = x[j];
  __syncwarp();
}

// out <- a*b*R^{-1} mod n: canonical words of a value < a*b/R + n (< 2n
// given a*b < R n; a < R, b + n < R, 4n < R).  a is read from shared memory
// (sa[0..L32)), b and n from registers (zeros beyond L32); n0inv = -n^{-1}
// mod 2^32.  out must not alias b.
template <int TPI, int W>
__device__ __forceinline__ void mont_mul(const uint32_t* sa, const uint32_t (&b)[W],
                                         const uint32_t (&n)[W], uint32_t n0inv, int L32,
                                         int lane, int gl, uint32_t (&out)[W]) {
  uint64_t col[W];  // column j: weight 2^(32 j) within the lane, carries not yet moved up
#pragma unroll
  for (int j = 0; j < W; ++j) col[j] = 0;
  const uint32_t b0 = __shfl_sync(FULL, b[0], 0, TPI);
  // two steps a loop trip up to 9 words a lane; beyond, one (fewer
  // registers, and 15% faster at 17 words: PERF.md, K6 findings)
  constexpr int UNROLL = W <= 9 ? 2 : 1;
#pragma unroll UNROLL
  for (int i = 0; i < L32; ++i) {
    const uint32_t ai = sa[i];
    const uint32_t c0 = __shfl_sync(FULL, (uint32_t)col[0], 0, TPI);
    const uint32_t mi = (c0 + ai * b0) * n0inv;
    uint32_t h1 = 0, h2 = 0;  // high words of the products one word down
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t p1 = (uint64_t)ai * b[j], p2 = (uint64_t)mi * n[j];
      col[j] += (uint64_t)(uint32_t)p1 + (uint32_t)p2 + h1 + h2;
      h1 = (uint32_t)(p1 >> 32);
      h2 = (uint32_t)(p2 >> 32);
    }
    // the shift by one word: column 0 moves to the lane below (its low word
    // is zero in lane 0 by the choice of m_i, the rest a carry into column 1)
    const uint64_t low = col[0];
    uint32_t dlo = __shfl_down_sync(FULL, (uint32_t)low, 1, TPI);
    uint32_t dhi = __shfl_down_sync(FULL, (uint32_t)(low >> 32), 1, TPI);
    if (gl == TPI - 1) dlo = dhi = 0;
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) col[j] = col[j + 1];
    col[W - 1] = (uint64_t)h1 + h2 + (((uint64_t)dhi << 32) | dlo);
    if (gl == 0) col[0] += low >> 32;
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = col[j] + c;
    out[j] = (uint32_t)t;
    c = t >> 32;
  }
  resolve<TPI, W>(out, (uint32_t)c, lane, gl);
}

// x <- x - n if x >= n, else x; canonical words.
template <int TPI, int W>
__device__ __forceinline__ void cond_sub(uint32_t (&x)[W], const uint32_t (&n)[W], int lane,
                                         int gl) {
  uint32_t d[W];
  uint32_t borrow = 0;
  bool zero = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = (uint64_t)x[j] - n[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
    zero = zero && d[j] == 0;
  }
  const uint64_t borrows = lane_carries<TPI>(borrow != 0, zero);
  uint32_t c = (uint32_t)(borrows >> carry_bit<TPI>(lane, gl)) & 1u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t t = (uint64_t)d[j] - c;
    d[j] = (uint32_t)t;
    c = (uint32_t)(t >> 63);
  }
  if (((borrows >> carry_bit<TPI>(lane, TPI)) & 1u) == 0) {  // no borrow out: x >= n
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = d[j];
  }
}

// x <- 2x mod n, for x < n (2x < R: no bit leaves the top lane).
template <int TPI, int W>
__device__ __forceinline__ void dbl_mod(uint32_t (&x)[W], const uint32_t (&n)[W], int lane,
                                        int gl) {
  uint32_t in = __shfl_up_sync(FULL, x[W - 1] >> 31, 1, TPI);
  if (gl == 0) in = 0;
#pragma unroll
  for (int j = W - 1; j > 0; --j) x[j] = __funnelshift_l(x[j - 1], x[j], 1);
  x[0] = (x[0] << 1) | in;
  cond_sub<TPI, W>(x, n, lane, gl);
}

// -n^{-1} mod 2^32 for odd n0 (Newton: each step doubles the correct bits,
// 3 -> 6 -> 12 -> 24 -> 48).
__device__ __forceinline__ uint32_t neg_inv32(uint32_t n0) {
  uint32_t x = n0;  // n0 * n0 = 1 mod 8
#pragma unroll
  for (int k = 0; k < 4; ++k) x *= 2u - n0 * x;
  return 0u - x;
}

// Words [gl W, gl W + W) of the value of L 15-bit digits src[0..L) times
// 2^shift (digits below 2^32 each; redundant digits such as 2^15 allowed;
// 0 <= shift <= 33): a carrying addition.  Word w sums the low part of every
// digit that starts in it (bit 15 l + shift in [32 w, 32 w + 32)) and the
// high part of every digit that starts in the word below and reaches into
// it, at most five digits (the loop over them unrolled, so that their loads
// need not wait on each other); the carries between words run along the
// lane, and between lanes through resolve.  The value times 2^shift must be below 2^(32 TPI W).
template <int TPI, int W>
__device__ __forceinline__ void limbs_to_words(const int* __restrict__ src, int L, int lane,
                                               int gl, uint32_t (&x)[W], int shift = 0) {
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int w = gl * W + j;
    uint64_t s = carry;
    // floor((32 w - 32 - shift) / 15) + 1 and floor((32 w + 31 - shift) / 15),
    // the numerators made positive first
    const int lo = max(0, (32 * w - 32 - shift + 75) / 15 - 4);
    const int hi = min(L - 1, (32 * w + 31 - shift + 75) / 15 - 5);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int l = lo + k;
      if (l <= hi) {
        const uint64_t d = (uint32_t)src[l];
        const int sh = 15 * l + shift - 32 * w;
        s += sh >= 0 ? (d << sh) & FULL : d >> -sh;
      }
    }
    x[j] = (uint32_t)s;
    carry = s >> 32;
  }
  resolve<TPI, W>(x, (uint32_t)carry, lane, gl);
}

// Canonical 15-bit limbs dst[0..L) of the row's canonical words staged in
// shared memory (sa[0..TPI W)); the value must be below 2^(15 L).
template <int TPI, int W>
__device__ __forceinline__ void words_to_limbs(const uint32_t* sa, int L, int gl,
                                               int* __restrict__ dst) {
  for (int l = gl; l < L; l += TPI) {
    const int bit = 15 * l, w = bit >> 5, sh = bit & 31;
    uint32_t v = sa[w] >> sh;
    if (sh > 17 && w + 1 < TPI * W) v |= sa[w + 1] << (32 - sh);
    dst[l] = (int)(v & 0x7fffu);
  }
}

}  // namespace cios32
