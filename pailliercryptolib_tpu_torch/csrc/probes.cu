// P1-P4 — instruction-rate probes: what one dependent chain of a primitive,
// a Barrett chain in two layouts, and a small exact int8 product cost on
// this card.  They are measurements for the design of the RNS kernels (which
// axis runs along threadIdx.x, what a multiply costs beside an add, dp4a
// against the int8 tensor core), not functions of the library.
//
// Replaces: the JAX package's benchmarks/probe_layout.py (chain_kernel),
// benchmarks/probe_ops.py (make_kernel and its eleven steps),
// benchmarks/probe_i8mm.py (kernel_i8, kernel_f32) and
// benchmarks/probe_vpu_ops.py (_mk and its seven ops).  Each kernel here
// computes what the Pallas kernel body computes, on the probe's own shapes,
// and is held bit-equal to a plain PyTorch version (ops/cuda_probes.py).
//
// What bounds them: the chains are bound by the rate at which the card starts
// the one instruction they repeat (every step depends on the one before, so
// a warp starts a step only when the last has finished, and the card fills
// the gap with other warps); the products by the dp4a / mma.sync rate, at a size (2.96 M
// multiply-adds) where a launch costs as much as the arithmetic.  Design of
// P1, the lagged chains and the first chain form: one element a thread, the
// chain in a register, the operand loaded once (P2 / P4's library form, E
// elements a thread, is in probe_chain.cu).
// An empty asm statement after every step keeps the compiler's front end from
// replacing a chain by its closed form or hoisting it; it emits no
// instruction.  It does not bind ptxas, which still does with a chain what
// the hardware's instructions allow: two dependent adds become one
// three-input IADD3, x ^ c ^ c is x, shifts by constants merge, and powers of
// a constant multiplier are folded.  The reference's add / xor / shift /
// multiply-by-constant chains therefore measure the code as compiled, not one
// instruction a step (chip_smoke.py marks the rates above what the card can
// start), and no source of the same function can change that: the fold is
// what the function allows.  The rate of IADD3, LOP3 and SHF themselves comes
// from the lagged chains below (lag_chain_kernel), whose step takes earlier
// values of the chain as its other operands, so that no two steps merge.  The
// chains that matter most for the kernels (multiply, compare-and-subtract,
// conversions, the float ops, the Barrett step) cannot be folded either.
// The chains' primitives are in probe_ops.cuh.

//
// P5 has no counterpart in the reference: one RNS Montgomery product alone,
// `iters` squarings x <- x * x on the CRT-folded constant set of K3, in the
// CUDA-core form (rns_mont_mul.cuh, 8 rows a block) and in the tensor-core
// form (rns_mont_mul_tc.cuh, 72 rows a cluster of four CTAs: in K3's narrow
// layout's two halves out of step, and in its one half, the form before the
// split), each with and without its base extensions (EXT): the time without
// them is the part of a product linear in k (the three fused reductions, the
// digit scatter, the barriers), the difference the extensions' share.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "probe_ops.cuh"
#include "rns_mont_mul.cuh"
#include "rns_mont_mul_tc.cuh"

namespace probes {

constexpr int THREADS = 256;

// -- P1: r <- Barrett(r * r), constants by column or by row -------------------

template <bool BYROW>
__global__ void __launch_bounds__(THREADS)
barrett_chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ m,
                     const uint32_t* __restrict__ mu, uint32_t* __restrict__ out,
                     long long n, int R, int C, int iters) {
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  int ci = BYROW ? (int)((idx / C) % R) : (int)(idx % C);
  const uint32_t mm = m[ci], mmu = mu[ci];
  uint32_t r = x[idx];
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
    uint32_t v = r * r;
    uint32_t q = ((v >> 14) * mmu) >> 14;
    r = v - q * mm;
    if (r >= (mm << 1)) r -= (mm << 1);
    if (r >= mm) r -= mm;
    asm volatile("" : "+r"(r));
  }
  out[idx] = r;
}

// -- P2, P4: one primitive, `iters` dependent steps, the first form --------------

// x, out [n] words (uint32 or the bits of float32); operand c [cmod] words,
// element idx takes c[idx % cmod] (cmod = row length: one constant a column;
// cmod = n: a second array).  One element a thread, 16 steps a loop: kept
// for timing only (cuda_probes.op_chain_e1), beside the form the library
// launches, chain_kernel<OP, E> of probe_chain.cu (E elements a thread).
template <int OP>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ c,
             uint32_t* __restrict__ out, long long n, long long cmod, int iters) {
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  const uint32_t cv = c[idx % cmod];
  uint32_t v = x[idx];
#pragma unroll 16  // the loop's own add, compare and branch once in 16 steps
  for (int i = 0; i < iters; ++i) {
    v = step<OP>(v, cv);
    asm volatile("" : "+r"(v));
  }
  out[idx] = v;
}

// -- lagged chains: one unfoldable instruction a step ----------------------------
//
// State s_n, s_{n-1}, s_{n-2}, s_{n-3}, started from (x, c, ~x, x + c); a step
// computes s_{n+1} from earlier values of the chain itself:
//   LAG_ADD   s_n + s_{n-1}                               add.u32
//   LAG_LOP3  (s_n & s_{n-1}) | (~s_n & s_{n-3})          lop3.b32, table 0xCA
//   LAG_SHF   (s_{n-1} : s_n) >> (s_{n-2} & 31), low word shf.r.wrap.b32
// Each step is one PTX instruction in an asm statement, which the compiler's
// front end passes on as it stands (written in C++ it rewrote the bit-select
// recurrence into fewer instructions).  Two consecutive
// LAG_LOP3 steps read four different registers, more than one LOP3 takes,
// and two LAG_ADD steps need their intermediate value again, so ptxas has
// nothing to merge; which unit an add goes to (IADD3, or IMAD with a
// multiplier of one) is its choice.  Unrolled by 12, a multiple of every
// state length, so the rotation of the state costs no move.

enum LagOp { LAG_ADD = 0, LAG_LOP3, LAG_SHF, NUM_LAG_OPS };

template <int OP>
__global__ void __launch_bounds__(THREADS)
lag_chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ c,
                 uint32_t* __restrict__ out, long long n, long long cmod, int iters) {
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  uint32_t a = x[idx], b = c[idx % cmod];
  uint32_t d = ~a, e = a + b;
#pragma unroll 12
  for (int i = 0; i < iters; ++i) {
    uint32_t t;
    if (OP == LAG_ADD)
      asm volatile("add.u32 %0, %1, %2;" : "=r"(t) : "r"(a), "r"(b));
    else if (OP == LAG_LOP3)
      asm volatile("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(t) : "r"(a), "r"(b), "r"(e));
    else
      asm volatile("shf.r.wrap.b32 %0, %1, %2, %3;" : "=r"(t) : "r"(a), "r"(b), "r"(d));
    e = d; d = b; b = a; a = t;
  }
  out[idx] = a;
}

// -- P3: exact product [M, K] x [K, N] of values below 128 ---------------------
//
// x is [M][Kp] int8 row-major, tT is the right operand transposed, [N][Kp]
// int8 (Kp: K padded with zeros to a multiple of 32), so that both operands
// are read four (dp4a) or sixteen (mma) contraction steps to a load.  The
// product is accumulated `reps` times (out = reps * x @ t), which gives the
// timing a length the launch does not hide.

__global__ void __launch_bounds__(THREADS)
i8mm_dp4a_kernel(const int* __restrict__ x, const int* __restrict__ tT,
                 int* __restrict__ out, int M, int N, int Kp, int reps) {
  int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= M * N) return;
  int m = idx / N, n = idx - m * N;
  const int K4 = Kp / 4;
  const int* xr = x + (size_t)m * K4;
  const int* tr = tT + (size_t)n * K4;
  int acc = 0;
  for (int rep = 0; rep < reps; ++rep) {
    for (int k4 = 0; k4 < K4; ++k4) acc = __dp4a(xr[k4], tr[k4], acc);
    asm volatile("" : "+r"(acc));
  }
  out[idx] = acc;
}

// One warp an output tile of 16 x 8, the contraction in steps of 32 through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  Fragments (PTX ISA,
// "Matrix Fragments for mma.m16n8k32", g = lane / 4, t = lane % 4):
//   A regs 0..3: rows g, g+8, g, g+8; bytes k = 4t..4t+3 (regs 0, 1) and
//                16+4t.. (regs 2, 3)
//   B regs 0..1: column g; bytes k = 4t.. and 16+4t..
//   C regs 0..3: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
__global__ void __launch_bounds__(THREADS)
i8mm_mma_kernel(const int* __restrict__ x, const int* __restrict__ tT,
                int* __restrict__ out, int M, int N, int Kp, int reps) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_n = N / 8;
  if (warp >= (M / 16) * tiles_n) return;
  const int m0 = (warp / tiles_n) * 16, n0 = (warp % tiles_n) * 8;
  const int g = lane >> 2, t = lane & 3;
  const int K4 = Kp / 4;
  const int* xa = x + (size_t)(m0 + g) * K4 + t;
  const int* xb = x + (size_t)(m0 + g + 8) * K4 + t;
  const int* tb = tT + (size_t)(n0 + g) * K4 + t;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int rep = 0; rep < reps; ++rep) {
    for (int k0 = 0; k0 < K4; k0 += 8) {  // 8 words = 32 contraction steps
      int a0 = xa[k0], a1 = xb[k0], a2 = xa[k0 + 4], a3 = xb[k0 + 4];
      int b0 = tb[k0], b1 = tb[k0 + 4];
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  int* o0 = out + (size_t)(m0 + g) * N + n0 + 2 * t;
  int* o1 = out + (size_t)(m0 + g + 8) * N + n0 + 2 * t;
  o0[0] = c0; o0[1] = c1;
  o1[0] = c2; o1[1] = c3;
}

// The same product in float32: x [M][K], t [K][N] row-major, fused
// multiply-adds (every partial sum is an integer below 2^24, hence exact in
// any order).  f32mm_kernel is the port's first body, one output a thread
// with x and t read from global memory, kept to time the two in turns.
__global__ void __launch_bounds__(THREADS)
f32mm_kernel(const float* __restrict__ x, const float* __restrict__ t,
             float* __restrict__ out, int M, int N, int K, int reps) {
  int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= M * N) return;
  int m = idx / N, n = idx - m * N;
  float acc = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    for (int k = 0; k < K; ++k) acc = __fmaf_rn(x[(size_t)m * K + k], t[(size_t)k * N + n], acc);
    asm volatile("" : "+f"(acc));
  }
  out[idx] = acc;
}

// The tiled body.  A block computes a 16 x 16 tile of the output (8 x 10
// blocks at P3's 128 x 152 x 152, so that 80 SMs work): its 16 rows of x
// and 16 columns of t, all K of them, are read into shared memory once; 64
// threads hold 2 x 2 outputs each in registers (four independent chains) and
// the block's two halves of 64 threads take one half of K each (split-K: the
// halves' sums are exact integers, added in shared memory at the end).  The
// problem is a few microseconds of latency, not of arithmetic: with the
// split a thread runs K / 2 steps of four independent fused multiply-adds,
// where the first body ran K dependent ones behind two loads from global
// memory.  Every multiply-add is __fmaf_rn on the CUDA cores: no tensor
// cores, no TF32 (a different function for general float32 inputs).
constexpr int F32_TILE = 16, F32_THREADS = 128, F32_MAX_K = 256;

__global__ void __launch_bounds__(F32_THREADS)
f32mm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ t,
                   float* __restrict__ out, int M, int N, int K, int reps) {
  __shared__ float xs[F32_TILE][F32_MAX_K + 1];  // [row][k], padded: rows on distinct banks
  __shared__ __align__(16) float ts[F32_MAX_K][F32_TILE];  // [k][column]
  __shared__ float red[F32_THREADS / 2][4];
  const int m0 = blockIdx.y * F32_TILE, n0 = blockIdx.x * F32_TILE;
  for (int i = threadIdx.x; i < F32_TILE * K; i += F32_THREADS) {
    const int r = i / K, k = i - r * K;  // x: rows of K floats, contiguous
    xs[r][k] = m0 + r < M ? x[(size_t)(m0 + r) * K + k] : 0.0f;
    const int kk = i / F32_TILE, c = i - kk * F32_TILE;  // t: 16 columns a row
    ts[kk][c] = n0 + c < N ? t[(size_t)kk * N + n0 + c] : 0.0f;
  }
  __syncthreads();
  const int half = threadIdx.x / (F32_THREADS / 2), h = threadIdx.x % (F32_THREADS / 2);
  const int r = (h / 8) * 2, c = (h % 8) * 2;
  const int k_lo = half * (K / 2), k_hi = half ? K : K / 2;
  float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) {
      const float x0 = xs[r][k], x1 = xs[r + 1][k];
      const float2 tk = *reinterpret_cast<const float2*>(&ts[k][c]);
      a00 = __fmaf_rn(x0, tk.x, a00);
      a01 = __fmaf_rn(x0, tk.y, a01);
      a10 = __fmaf_rn(x1, tk.x, a10);
      a11 = __fmaf_rn(x1, tk.y, a11);
    }
    asm volatile("" : "+f"(a00), "+f"(a01), "+f"(a10), "+f"(a11));
  }
  if (half) {
    red[h][0] = a00; red[h][1] = a01; red[h][2] = a10; red[h][3] = a11;
  }
  __syncthreads();
  if (half) return;
  const float v[4] = {__fadd_rn(a00, red[h][0]), __fadd_rn(a01, red[h][1]),
                      __fadd_rn(a10, red[h][2]), __fadd_rn(a11, red[h][3])};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + r + q / 2, n = n0 + c + q % 2;
    if (m < M && n < N) out[(size_t)m * N + n] = v[q];
  }
}

// -- P5: iters products x <- x * x on the folded set (G = 2, f32, lean) -------
//
// x, out: [B][k + kb] words, the A lanes then the scaled B lanes.

template <bool EXT>
__global__ void __launch_bounds__(prns::MAX_THREADS)
mont_chain_kernel(const uint32_t* __restrict__ rowc, const int2* __restrict__ T1,
                  const int2* __restrict__ T2, const uint32_t* __restrict__ x,
                  uint32_t* __restrict__ out, int B, int iters, prns::Dims d) {
  using namespace prns;
  __shared__ Scratch<ROWS> s;
  const int j = threadIdx.x, Wt = d.k + d.kb;
  const Lane c = load_lane(rowc, d.W, j);
  const int row0 = blockIdx.x * ROWS;
  uint32_t a[ROWS], b[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int row = row0 + r;
    a[r] = row < B && j < d.k ? x[(size_t)row * Wt + j] : 0u;
    b[r] = row < B && j < d.kb ? x[(size_t)row * Wt + d.k + j] : 0u;
  }
  for (int it = 0; it < iters; ++it)
    mont_mul2<true, true, ROWS, 2, false, EXT>(c, d, s, rowc, T1, T2, a, b, a, b, a, b);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int row = row0 + r;
    if (row < B) {
      if (j < d.k) out[(size_t)row * Wt + j] = a[r];
      if (j < d.kb) out[(size_t)row * Wt + d.k + j] = b[r];
    }
  }
}

// HALVES 2: the narrow layout, the library's (two halves out of step); 1: the
// same in one half, the form before the split
template <int HALVES>
using ProbeLayout =
    typename std::conditional<HALVES == 2, prns::tc::Narrow, prns::tc::Narrow1>::type;
static_assert(ProbeLayout<1>::CLUSTER == 4 && ProbeLayout<2>::CLUSTER == 4, "clusters of four");

template <int HALVES, bool EXT>
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(ProbeLayout<HALVES>::MAX_THREADS, 1)
mont_chain_tc_kernel(const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                     const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                     const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int B,
                     int iters, prns::tc::Dims d) {
  using namespace prns;
  using TL = ProbeLayout<HALVES>;
  const tc::Smem<TL> s = tc::carve<TL>(d, T1, T2);
  tc::Place<TL> p = tc::place<TL>(d, cooperative_groups::this_cluster().block_rank());
  tc::load_chip_state<2>(s, d, p, rowc, T1, T2, T1a);
  const int Wt = d.k + d.kb;
  const int row0 = (blockIdx.x / TL::CLUSTER) * TL::ROWS + 8 * tc::mt0(p) + p.g;
  uint32_t a[TL::NL][TL::MTH], b[TL::NL][TL::MTH];
#pragma unroll
  for (int nl = 0; nl < TL::NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int u = 0; u < TL::MTH; ++u) {
      int row = row0 + 8 * u;
      const bool ok = row < B && tc::has_mt(p, u);
      a[nl][u] = ok && j < d.k ? x[(size_t)row * Wt + j] : 0u;
      b[nl][u] = ok && j < d.kb ? x[(size_t)row * Wt + d.k + j] : 0u;
    }
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
    tc::mont_mul2<true, true, 2, false, EXT>(
        s, d, p, rowc, a, b, [&](int nl, int u, uint32_t& ya, uint32_t& yb) {
          ya = a[nl][u];
          yb = b[nl][u];
        });
#pragma unroll
  for (int nl = 0; nl < TL::NL; ++nl) {
    const int j = p.j0 + 4 * nl;
#pragma unroll
    for (int u = 0; u < TL::MTH; ++u) {
      int row = row0 + 8 * u;
      if (row < B && tc::has_mt(p, u)) {
        if (j < d.k) out[(size_t)row * Wt + j] = a[nl][u];
        if (j < d.kb) out[(size_t)row * Wt + d.k + j] = b[nl][u];
      }
    }
  }
  tc::finish(p);
}

}  // namespace probes

using namespace probes;

static inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

// x, out [n = batch * R * C] uint32; m, mu [C] (byrow = 0) or [R] (byrow = 1).
extern "C" int probe_barrett_chain_launch(const void* x, const void* m, const void* mu,
                                          void* out, long long n, int R, int C,
                                          int byrow, int iters, void* stream) {
  if (n <= 0 || R <= 0 || C <= 0 || n % ((long long)R * C) || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (byrow)
    barrett_chain_kernel<true><<<blocks_for(n), THREADS, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)m, (const uint32_t*)mu, (uint32_t*)out, n,
        R, C, iters);
  else
    barrett_chain_kernel<false><<<blocks_for(n), THREADS, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)m, (const uint32_t*)mu, (uint32_t*)out, n,
        R, C, iters);
  return (int)cudaGetLastError();
}

extern "C" int probe_chain_e1_launch(const void* x, const void* c, void* out, long long n,
                                     long long cmod, int op, int iters, void* stream) {
  if (n <= 0 || cmod <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PROBE_CASE(OP)                                                              \
  case OP:                                                                          \
    chain_kernel<OP><<<blocks_for(n), THREADS, 0, st>>>(                            \
        (const uint32_t*)x, (const uint32_t*)c, (uint32_t*)out, n, cmod, iters);    \
    break
  switch (op) {
    PROBE_CASE(OP_ADD); PROBE_CASE(OP_XOR); PROBE_CASE(OP_SHIFT); PROBE_CASE(OP_MUL);
    PROBE_CASE(OP_MUL_CONST); PROBE_CASE(OP_MUL_SELF); PROBE_CASE(OP_WHERE_SUB);
    PROBE_CASE(OP_CVT_ROUNDTRIP); PROBE_CASE(OP_FMUL); PROBE_CASE(OP_MUL_I32);
    PROBE_CASE(OP_MUL_MASK12); PROBE_CASE(OP_SHIFT_ADD); PROBE_CASE(OP_MUL_ADD);
    PROBE_CASE(OP_FMUL_ADD);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
  return (int)cudaGetLastError();
}

extern "C" int probe_lag_chain_launch(const void* x, const void* c, void* out,
                                      long long n, long long cmod, int op, int iters,
                                      void* stream) {
  if (n <= 0 || cmod <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PROBE_CASE(OP)                                                              \
  case OP:                                                                          \
    lag_chain_kernel<OP><<<blocks_for(n), THREADS, 0, st>>>(                        \
        (const uint32_t*)x, (const uint32_t*)c, (uint32_t*)out, n, cmod, iters);    \
    break
  switch (op) {
    PROBE_CASE(LAG_ADD); PROBE_CASE(LAG_LOP3); PROBE_CASE(LAG_SHF);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
  return (int)cudaGetLastError();
}

// body 0: dp4a, 1: mma.sync (M % 16 == 0, N % 8 == 0).  x [M][Kp], tT [N][Kp]
// int8 with Kp % 32 == 0; out [M][N] int32.
extern "C" int probe_i8mm_launch(const void* x, const void* tT, void* out, int M, int N,
                                 int Kp, int body, int reps, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % 32 || reps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 0) {
    i8mm_dp4a_kernel<<<blocks_for((long long)M * N), THREADS, 0, st>>>(
        (const int*)x, (const int*)tT, (int*)out, M, N, Kp, reps);
  } else if (body == 1) {
    if (M % 16 || N % 8) return (int)cudaErrorInvalidValue;
    long long warps = (long long)(M / 16) * (N / 8);
    i8mm_mma_kernel<<<blocks_for(warps * 32), THREADS, 0, st>>>(
        (const int*)x, (const int*)tT, (int*)out, M, N, Kp, reps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// body 0: one output a thread (the first body), 1: tiled (K <= F32_MAX_K).
extern "C" int probe_f32mm_launch(const void* x, const void* t, void* out, int M, int N,
                                  int K, int body, int reps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 0) {
    f32mm_kernel<<<blocks_for((long long)M * N), THREADS, 0, st>>>(
        (const float*)x, (const float*)t, (float*)out, M, N, K, reps);
  } else if (body == 1) {
    if (K > F32_MAX_K) return (int)cudaErrorInvalidValue;
    dim3 grid((N + F32_TILE - 1) / F32_TILE, (M + F32_TILE - 1) / F32_TILE);
    f32mm_tiled_kernel<<<grid, F32_THREADS, 0, st>>>((const float*)x, (const float*)t,
                                                     (float*)out, M, N, K, reps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// form 0: CUDA-core product (T1, T2 as ops/cuda_rns2._pack_planes; T1a
// unused), 1: tensor-core product (T1, T2, T1a as ops/cuda_rns2._tc_pack) in
// the narrow layout's two halves, 2: the same in one half.
extern "C" int probe_mont_chain_launch(const void* rowc, const void* T1, const void* T2,
                                       const void* T1a, const void* x, void* out, int B,
                                       int iters, int k,
                                       int kb, int W, int form, int ext, void* stream) {
  if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 0) {
    prns::Dims d{k, kb, (k + 3) / 4, W};
    if (!prns::dims_fit(d, 320) || kb + 2 > W) return (int)cudaErrorInvalidValue;
    const int blocks = (B + prns::ROWS - 1) / prns::ROWS;
#define PROBE_LAUNCH(E)                                                               \
  mont_chain_kernel<E><<<blocks, W, 0, st>>>((const uint32_t*)rowc, (const int2*)T1, \
                                             (const int2*)T2, (const uint32_t*)x,    \
                                             (uint32_t*)out, B, iters, d)
    if (ext) PROBE_LAUNCH(true); else PROBE_LAUNCH(false);
#undef PROBE_LAUNCH
  } else if (form == 1 || form == 2) {
#define PROBE_LAUNCH(H, E)                                                               \
  do {                                                                                   \
    using TL = ProbeLayout<H>;                                                           \
    prns::tc::Dims d{k, kb, W, (k + 31) / 32};                                           \
    if (!prns::tc::dims_fit<TL>(d, 2)) return (int)cudaErrorInvalidValue;                \
    const int grid = (B + TL::ROWS - 1) / TL::ROWS * TL::CLUSTER;                        \
    cudaError_t err = cudaFuncSetAttribute(mont_chain_tc_kernel<H, E>,                   \
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                           TL::SMEM_BYTES);                              \
    if (err != cudaSuccess) return (int)err;                                             \
    mont_chain_tc_kernel<H, E><<<grid, prns::tc::threads<TL>(d), TL::SMEM_BYTES, st>>>(  \
        (const uint32_t*)rowc, (const uint32_t*)T1, (const uint32_t*)T2,                 \
        (const uint32_t*)T1a, (const uint32_t*)x, (uint32_t*)out, B, iters, d);          \
  } while (0)
    if (form == 1) {
      if (ext) PROBE_LAUNCH(2, true); else PROBE_LAUNCH(2, false);
    } else {
      if (ext) PROBE_LAUNCH(1, true); else PROBE_LAUNCH(1, false);
    }
#undef PROBE_LAUNCH
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
