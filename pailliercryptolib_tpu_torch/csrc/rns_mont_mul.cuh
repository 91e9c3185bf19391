// Shared pieces of the RNS Montgomery product for Hopper (sm_90a): the
// constants of the digit split, the rows of the packed per-lane constant
// table, the fused reduction, the fold of a base extension's digit-plane
// sums, and the dispatch on the form of a constant set.  The product itself
// is rns_mont_mul_tc.cuh, which every RNS kernel of the library runs (K1 in
// fb_table2.cu, K2 fb_modexp2.cu, K3 rns_modexp2f.cu, K5 rns_modexp2.cu).
//
// Replaces: the JAX package's ops/pallas_rns2.py device functions _red_mu
// and the fold of _mm_terms.
//
// Every integer they produce is bit-equal to the plain PyTorch version
// (ops/cuda_rns2.red_mu, _fold): the f32-reciprocal reduction is int->float
// round-to-nearest, one multiply, truncate.
//
// The form of a constant set is fixed at compile time by two parameters,
// chosen by the launchers from the set itself (never from the key size):
//   F32   false: integer Barrett reduction with the 4m/2m/m chain, canonical
//         r_A — sets whose moduli all lie above 2^13 (n^2 of keys up to
//         ~2900 bits);  true: f32-reciprocal reduction, r_A left redundant
//         (< 2m) unless CANON asks for the third layer — the CRT decrypt
//         sets, and every "wide-pool" set (a modulus below 2^13: n^2 of
//         3072- and 4096-bit keys), for which the integer flavor's error
//         bound does not hold.
//   LEAN  (F32 only) the mid plane of the 2^14-radix fold stays unsplit; the
//         folded value then stays below 2^31 only while the contraction
//         length is <= 320.  Longer contractions (k = 465 / 637 for n^2 of
//         3072- / 4096-bit keys) take the full fold under the f32 reduction.

#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace prns {

constexpr int MOD_BITS = 14;
constexpr uint32_t MASK14 = (1u << MOD_BITS) - 1;
constexpr int DIGIT_BITS = 7;
constexpr uint32_t DIGIT_MASK = (1u << DIGIT_BITS) - 1;

// Rows of the packed per-lane constant table rowc[NROWS][W] (built by
// ops/cuda_rns2._kernel_pack; W = the lanes of the set).
enum RowId {
  R_MODSA = 0, R_MUA, R_SIG0, R_SIG1, R_PADA, R_MBMODA, R_C28A, R_C21A, R_GIDA,
  R_MODSB, R_MUB, R_C0, R_C1, R_CALPHA, R_C28B, R_C21B, R_GIDB, R_WINV,
  R_SQA, R_SQB, R_ONEA, R_ONEB, R_PONEB,
  R_MR, R_MUR, R_TWOMR,   // columns 0..G-1: per-group redundant modulus
  NROWS
};

// Run CALL(F32, LEAN) for the compiled form that matches the runtime flags
// f32 / lean; the lean fold without the f32 reduction is no form and returns
// cudaErrorInvalidValue from the enclosing launcher.
#define PRNS_DISPATCH_FORM(f32, lean, CALL)                        \
  do {                                                             \
    if (!(f32)) {                                                  \
      if (lean) return (int)cudaErrorInvalidValue;                 \
      CALL(false, false);                                          \
    } else if (lean) {                                             \
      CALL(true, true);                                            \
    } else {                                                       \
      CALL(true, false);                                           \
    }                                                              \
  } while (0)

// Fused reduction v -> v mod m (LAYERS = 3) or a representative < 2m
// (LAYERS = 2).  mu is floor(2^28/m) (integer flavor) or the bit pattern of
// the float (1 - 2^-20)/m (f32 flavor).
template <bool F32, int LAYERS>
__device__ __forceinline__ uint32_t red_mu(uint32_t v, uint32_t m, uint32_t mu) {
  uint32_t r;
  if (F32) {
    float p = __fmul_rn(__int2float_rn((int)v), __uint_as_float(mu));
    uint32_t q = (uint32_t)__float2int_rz(p);
    r = v - q * m;
  } else {
    uint32_t q = ((v >> MOD_BITS) * mu) >> MOD_BITS;
    r = v - q * m;
    uint32_t m4 = m << 2, m2 = m << 1;
    if (r >= m4) r -= m4;
    if (r >= m2) r -= m2;
  }
  if (LAYERS >= 3) {
    if (r >= m) r -= m;
  }
  return r;
}

// 2^14-radix fold of the digit-plane sums of a base extension.
template <bool LEAN>
__device__ __forceinline__ uint32_t fold_terms(int ll, int mid, int hh,
                                               uint32_t c28, uint32_t c21) {
  uint32_t llu = (uint32_t)ll, midu = (uint32_t)mid, hhu = (uint32_t)hh;
  if (LEAN) {  // mid plane unsplit (f32 reduction takes v < 2^31)
    return llu + (midu << DIGIT_BITS) + ((hhu & MASK14) << MOD_BITS) +
           (hhu >> MOD_BITS) * c28;
  }
  return (hhu >> MOD_BITS) * c28 + ((hhu & MASK14) << MOD_BITS) +
         (midu >> MOD_BITS) * c21 + ((midu & MASK14) << DIGIT_BITS) + llu;
}

}  // namespace prns
