// Fused-reduction RNS Montgomery multiply for Hopper (sm_90a): the device
// function shared by the fixed-base table, fixed-base modexp, CRT-folded
// modexp and generic modexp kernels.
//
// Replaces: the JAX package's ops/pallas_rns2.py device functions _red_mu,
// _mm_terms, _make_mont_mul2, _group_bcast and _limbs_to_res2.
//
// What it computes: for R batch rows held by one thread block, the
// Bajard-Imbert product x*y*M_A^{-1} mod N on (A-side, scaled-B-side)
// residue pairs, with exactly three fused reductions (sigma, z_B, r_A) and
// two base extensions.  Every integer it produces is bit-equal to the plain
// PyTorch version (ops/cuda_rns2.mont_mul2_plain): the digit-plane sums
// ll/mid/hh are formed separately and folded with the same constants, the
// Kawamura alpha estimate adds its three float terms in the same order
// with round-to-nearest intrinsics (no FMA contraction), and the
// f32-reciprocal reduction is int->float round-to-nearest, one multiply,
// truncate.
//
// What bounds it on this card: integer issue rate.  A base extension is a
// [R, k] x [k, ~k] product of 7-bit digit planes, four plane products per
// extension; there is no gather or wide memory stream.  Design: one thread
// per residue lane / matrix column, the R rows of the block in registers;
// the left operand's digits are packed four to a word in shared memory
// ([k/4][R], read as 16-byte broadcasts) and the weight planes four
// contraction rows to a word in global memory ([k/4][W] of int2 = lo, hi),
// so one 8-byte coalesced load feeds 4*R dp4a instructions.  The weights
// (~0.4 MB for a 2048-bit key) stay in L2.  The tensor-core form of the
// product is rns_mont_mul_tc.cuh (K3, K5, and K2 up to 320 lanes); K1 and K2
// beyond 320 lanes run this one, and K3 / K5 / K2 keep it for timing.
//
// The form of a constant set is fixed at compile time by three parameters,
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
// Every instance is compiled for blocks of up to MAX_THREADS = 640 lanes, one
// thread a lane, and launched with as many threads as the set has lanes (320
// for n^2 of a 2048-bit key, 640 of a 4096-bit key).  Independent of the form
// is the number G of residue systems that lie side
// by side on the lane axis of one block: G = 2 is the folded layout of the
// CRT decrypt kernel (group-scoped alpha / alpha' columns, selected per
// lane by its group id), G = 1 one system per block.  The generic modexp
// kernel runs stacked ("grouped") constant sets as G = 1 blocks, one
// constant set per blockIdx.y.

#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace prns {

constexpr int MOD_BITS = 14;
constexpr uint32_t MASK14 = (1u << MOD_BITS) - 1;
constexpr int DIGIT_BITS = 7;
constexpr uint32_t DIGIT_MASK = (1u << DIGIT_BITS) - 1;
constexpr int MAX_THREADS = 640;       // lanes per block (__launch_bounds__, digit scratch)
constexpr int ROWS = 8;                // batch rows per block

// Rows of the packed per-lane constant table rowc[NROWS][W] (built by
// ops/cuda_rns2._kernel_pack; W = blockDim.x).
enum RowId {
  R_MODSA = 0, R_MUA, R_SIG0, R_SIG1, R_PADA, R_MBMODA, R_C28A, R_C21A, R_GIDA,
  R_MODSB, R_MUB, R_C0, R_C1, R_CALPHA, R_C28B, R_C21B, R_GIDB, R_WINV,
  R_SQA, R_SQB, R_ONEA, R_ONEB, R_PONEB,
  R_MR, R_MUR, R_TWOMR,   // columns 0..G-1: per-group redundant modulus
  NROWS
};

struct Dims {
  int k;    // A lanes (both groups when folded)
  int kb;   // B lanes including the G redundant lanes
  int k4;   // ceil(k / 4): packed contraction length
  int W;    // row stride of rowc / T1 / T2 (= blockDim.x)
};

// What the kernels' fixed-size shared arrays and __launch_bounds__ assume;
// every launcher refuses dimensions outside it instead of launching.
inline bool dims_fit(const Dims& d, int max_threads = MAX_THREADS) {
  return d.W > 0 && d.W <= max_threads && d.k4 * 4 <= d.W && d.k <= d.W &&
         d.kb <= d.W;
}

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

struct Lane {
  uint32_t mA, muA, sig0, sig1, padA, mbA, c28A, c21A, gidA;
  uint32_t mB, muB, c0, c1, cAlpha, c28B, c21B, gidB, winv;
};

__device__ __forceinline__ Lane load_lane(const uint32_t* rowc, int W, int j) {
  Lane c;
  c.mA = rowc[R_MODSA * W + j];   c.muA = rowc[R_MUA * W + j];
  c.sig0 = rowc[R_SIG0 * W + j];  c.sig1 = rowc[R_SIG1 * W + j];
  c.padA = rowc[R_PADA * W + j];  c.mbA = rowc[R_MBMODA * W + j];
  c.c28A = rowc[R_C28A * W + j];  c.c21A = rowc[R_C21A * W + j];
  c.gidA = rowc[R_GIDA * W + j];
  c.mB = rowc[R_MODSB * W + j];   c.muB = rowc[R_MUB * W + j];
  c.c0 = rowc[R_C0 * W + j];      c.c1 = rowc[R_C1 * W + j];
  c.cAlpha = rowc[R_CALPHA * W + j];
  c.c28B = rowc[R_C28B * W + j];  c.c21B = rowc[R_C21B * W + j];
  c.gidB = rowc[R_GIDB * W + j];  c.winv = rowc[R_WINV * W + j];
  return c;
}

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

template <int R>
struct alignas(16) Scratch {
  uint32_t dlo[MAX_THREADS / 4 * R];   // [k4][R] low 7-bit digits, 4 lanes a word
  uint32_t dhi[MAX_THREADS / 4 * R];   // [k4][R] high digits
  uint32_t alpha[2 * R];      // [G][R] Kawamura alpha
  uint32_t zmr[2 * R];        // [G][R] z on the redundant lanes
  uint32_t alpha2[2 * R];     // [G][R] Shenoy alpha'
};

// Write lane j's 14-bit value of row r as two digit bytes.
template <int R>
__device__ __forceinline__ void put_digits(Scratch<R>& s, int j, int r,
                                           uint32_t v) {
  int off = (((j >> 2) * R + r) << 2) + (j & 3);
  reinterpret_cast<uint8_t*>(s.dlo)[off] = (uint8_t)(v & DIGIT_MASK);
  reinterpret_cast<uint8_t*>(s.dhi)[off] = (uint8_t)(v >> DIGIT_BITS);
}

// Column j of digits(s) @ T for the R rows: the three plane sums.
template <int R>
__device__ __forceinline__ void plane_matvec(const Scratch<R>& s,
                                             const int2* __restrict__ T,
                                             const Dims& d, int j, int (&ll)[R],
                                             int (&mid)[R], int (&hh)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) { ll[r] = 0; mid[r] = 0; hh[r] = 0; }
  const uint4* plo = reinterpret_cast<const uint4*>(s.dlo);
  const uint4* phi = reinterpret_cast<const uint4*>(s.dhi);
  for (int i4 = 0; i4 < d.k4; ++i4) {
    int2 t = __ldg(&T[i4 * d.W + j]);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      uint4 lo = plo[i4 * (R / 4) + q];
      uint4 hi = phi[i4 * (R / 4) + q];
      const int lo4[4] = {(int)lo.x, (int)lo.y, (int)lo.z, (int)lo.w};
      const int hi4[4] = {(int)hi.x, (int)hi.y, (int)hi.z, (int)hi.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = q * 4 + e;
        ll[r] = __dp4a(lo4[e], t.x, ll[r]);
        mid[r] = __dp4a(lo4[e], t.y, mid[r]);
        mid[r] = __dp4a(hi4[e], t.x, mid[r]);
        hh[r] = __dp4a(hi4[e], t.y, hh[r]);
      }
    }
  }
}

// (rA, zB) = mont_mul((xA, xB), (yA, yB)) for the block's R rows.  Thread j
// holds A lane j (valid for j < k) and B lane j (valid for j < kb) of every
// row; outputs may alias inputs.  All threads of the block must call it.
// CANON asks for canonical r_A under the f32 flavor too (the fixed-base
// table build: its entries feed 7-bit digit planes).  EXT = false leaves the
// plane products out (ll = mid = hh = 0): only the probe that times the part
// of a product linear in k (csrc/probes.cu) uses it.
template <bool F32, bool LEAN, int R, int G, bool CANON = false, bool EXT = true>
__device__ __forceinline__ void mont_mul2(
    const Lane& c, const Dims& d, Scratch<R>& s,
    const uint32_t* __restrict__ rowc,
    const int2* __restrict__ T1, const int2* __restrict__ T2,
    const uint32_t (&xA)[R], const uint32_t (&xB)[R], const uint32_t (&yA)[R],
    const uint32_t (&yB)[R], uint32_t (&rA)[R], uint32_t (&zB)[R]) {
  static_assert(F32 || !LEAN, "the lean fold needs the f32 reduction");
  constexpr int RA_LAYERS = (F32 && !CANON) ? 2 : 3;
  const int j = threadIdx.x;
  const int kpad = d.k4 * 4;
  uint32_t vB[R];
  int ll[R], mid[R], hh[R];

  // sigma = (x_A y_A) * (-N^{-1} (M_A/a_i)^{-1}) mod a_i, canonical: its
  // 7-bit digits feed the A -> B extension
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t uA = xA[r] * yA[r];
    uint32_t sg = red_mu<F32, 3>((uA >> MOD_BITS) * c.sig1 + (uA & MASK14) * c.sig0,
                                 c.mA, c.muA);
    if (j < kpad) put_digits(s, j, r, j < d.k ? sg : 0u);
    uint32_t uB = xB[r] * yB[r];
    vB[r] = (uB >> MOD_BITS) * c.c1 + (uB & MASK14) * c.c0;
  }
  __syncthreads();

  // A -> B+m_r extension (N*M_A^{-1}*w folded into the weights); the last G
  // columns carry the Kawamura alpha sums
  if (EXT) {
    plane_matvec(s, T1, d, j, ll, mid, hh);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) { ll[r] = 0; mid[r] = 0; hh[r] = 0; }
  }
  if (j >= d.kb && j < d.kb + G) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float af = __fadd_rn(
          __fadd_rn(__int2float_rn(ll[r]),
                    __fmul_rn(__int2float_rn(mid[r]), 128.0f)),
          __fmul_rn(__int2float_rn(hh[r]), 16384.0f));
      af = __fmul_rn(af, 1.0f / 67108864.0f);  // 2^-26
      float fl = fmaxf(floorf(__fsub_rn(af, 0.0625f)), 0.0f);
      s.alpha[(j - d.kb) * R + r] = (uint32_t)__float2int_rz(fl);
    }
  }
  __syncthreads();

  // z_B = (s + q_hat N) M_A^{-1} w mod b, all terms in one reduction
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t tB = fold_terms<LEAN>(ll[r], mid[r], hh[r], c.c28B, c.c21B);
    uint32_t a = s.alpha[c.gidB * R + r];
    uint32_t z = red_mu<F32, 3>(vB[r] + tB + a * c.cAlpha, c.mB, c.muB);
    zB[r] = z;
    if (j < kpad) put_digits(s, j, r, j < d.k ? z : 0u);
    if (j >= d.k && j < d.kb) s.zmr[(j - d.k) * R + r] = z;
  }
  __syncthreads();

  // exact Shenoy extension back to base A: z_B is the weight vector; the
  // trailing G columns are the redundant residues (M_B^{-1}-scaled)
  if (EXT) {
    plane_matvec(s, T2, d, j, ll, mid, hh);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) { ll[r] = 0; mid[r] = 0; hh[r] = 0; }
  }
  uint32_t tA[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    tA[r] = fold_terms<LEAN>(ll[r], mid[r], hh[r], c.c28A, c.c21A);
  if (j >= d.k && j < d.k + G) {
    int g = j - d.k;
    uint32_t mr = rowc[R_MR * d.W + g], mur = rowc[R_MUR * d.W + g];
    uint32_t twomr = rowc[R_TWOMR * d.W + g];
#pragma unroll
    for (int r = 0; r < R; ++r)
      s.alpha2[g * R + r] =
          red_mu<F32, 3>(tA[r] + twomr - s.zmr[g * R + r], mr, mur);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t a2 = s.alpha2[c.gidA * R + r];
    rA[r] = red_mu<F32, RA_LAYERS>(tA[r] + c.padA - a2 * c.mbA, c.mA, c.muA);
  }
}

// (x * y) mod m on the B lanes, canonical (the z -> r unscale by w^{-1}).
template <bool F32>
__device__ __forceinline__ uint32_t mulmod_b(const Lane& c, uint32_t x, uint32_t y) {
  return red_mu<F32, 3>(x * y, c.mB, c.muB);
}

}  // namespace prns
