// The measurements behind K6's design choices (csrc/modexp.cu,
// csrc/cios_mont_mul32.cuh), built and run by tools/k6_forms.py on one GPU:
//
//  * forms_modexp_launch: the library's modexp32_kernel at 8, 16 or 32 lanes
//    a row (the kernel is a template on it; the library compiles 16);
//  * forms_chain_launch: one chain of P Montgomery squarings a row in three
//    forms of the 32-bit product: the library's (one 64-bit column a word,
//    mont_mul), a carry chain along the lane, and PTX mad.cc carry chains.
//
// Not part of the library: nothing in the package loads it.

#include "../pailliercryptolib_tpu_torch/csrc/modexp.cu"

namespace k6forms {

using namespace cios32;

// t1 = a_i b_j + acc_j + c1, t2 = m_i n_j + lo(t1) + c2, acc_{j-1} = lo(t2):
// two carry chains along the lane's words, the shift folded in.
template <int TPI, int W>
__device__ __forceinline__ void mont_mul_chain(const uint32_t* sa, const uint32_t (&b)[W],
                                               const uint32_t (&n)[W], uint32_t n0inv, int L32,
                                               int lane, int gl, uint32_t (&acc)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  uint32_t cy = 0;
  const uint32_t b0 = __shfl_sync(FULL, b[0], 0, TPI);
#pragma unroll 2
  for (int i = 0; i < L32; ++i) {
    const uint32_t ai = sa[i];
    const uint32_t acc0 = __shfl_sync(FULL, acc[0], 0, TPI);
    const uint32_t mi = (acc0 + ai * b0) * n0inv;
    uint64_t t1 = (uint64_t)ai * b[0] + acc[0];
    uint64_t t2 = (uint64_t)mi * n[0] + (uint32_t)t1;
    const uint32_t low = (uint32_t)t2;
    uint32_t c1 = (uint32_t)(t1 >> 32), c2 = (uint32_t)(t2 >> 32);
#pragma unroll
    for (int j = 1; j < W; ++j) {
      t1 = (uint64_t)ai * b[j] + acc[j] + c1;
      t2 = (uint64_t)mi * n[j] + (uint32_t)t1 + c2;
      acc[j - 1] = (uint32_t)t2;
      c1 = (uint32_t)(t1 >> 32);
      c2 = (uint32_t)(t2 >> 32);
    }
    uint32_t above = __shfl_down_sync(FULL, low, 1, TPI);
    if (gl == TPI - 1) above = 0;
    const uint64_t top = (uint64_t)c1 + c2 + cy + above;
    acc[W - 1] = (uint32_t)top;
    cy = (uint32_t)(top >> 32);
  }
  resolve<TPI, W>(acc, cy, lane, gl);
}

// The same sums as four PTX passes of mad.lo.cc / madc.hi.cc (lo and hi
// words of a_i b, then of m_i n), the shift by register moves.
template <int TPI, int W>
__device__ __forceinline__ void mont_mul_ptx(const uint32_t* sa, const uint32_t (&b)[W],
                                             const uint32_t (&n)[W], uint32_t n0inv, int L32,
                                             int lane, int gl, uint32_t (&acc)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  uint32_t cy = 0;
  const uint32_t b0 = __shfl_sync(FULL, b[0], 0, TPI);
#pragma unroll 2
  for (int i = 0; i < L32; ++i) {
    const uint32_t ai = sa[i];
    const uint32_t acc0 = __shfl_sync(FULL, acc[0], 0, TPI);
    const uint32_t mi = (acc0 + ai * b0) * n0inv;
    uint32_t top, top2;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc[0]) : "r"(ai), "r"(b[0]));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc[j]) : "r"(ai), "r"(b[j]));
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(top));
    if (W > 1) {
      asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc[1]) : "r"(ai), "r"(b[0]));
#pragma unroll
      for (int j = 1; j + 1 < W; ++j)
        asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc[j + 1]) : "r"(ai), "r"(b[j]));
      asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(top) : "r"(ai), "r"(b[W - 1]));
    } else {
      asm volatile("mad.hi.u32 %0, %1, %2, %0;" : "+r"(top) : "r"(ai), "r"(b[0]));
    }
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc[0]) : "r"(mi), "r"(n[0]));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc[j]) : "r"(mi), "r"(n[j]));
    asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(top));
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(top2));
    const uint32_t low = acc[0];
    if (W > 1) {
      asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc[1]) : "r"(mi), "r"(n[0]));
#pragma unroll
      for (int j = 1; j + 1 < W; ++j)
        asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc[j + 1]) : "r"(mi), "r"(n[j]));
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(top) : "r"(mi), "r"(n[W - 1]));
    } else {
      asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(top) : "r"(mi), "r"(n[0]));
    }
    asm volatile("addc.u32 %0, %0, 0;" : "+r"(top2));
    uint32_t above = __shfl_down_sync(FULL, low, 1, TPI);
    if (gl == TPI - 1) above = 0;
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) acc[j] = acc[j + 1];
    const uint64_t t = ((uint64_t)top2 << 32 | top) + cy + above;
    acc[W - 1] = (uint32_t)t;
    cy = (uint32_t)(t >> 32);
  }
  resolve<TPI, W>(acc, cy, lane, gl);
}

// x [B][TPI * W] canonical words (< 2n), nw the words of n: P squarings a row.
template <int TPI, int W, int FORM>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ nw, uint32_t n0inv,
             uint32_t* __restrict__ out, int L32, int P) {
  constexpr int ROWS = THREADS / TPI;
  __shared__ uint32_t sa_all[ROWS][TPI * W];
  const int lane = threadIdx.x & 31, gl = threadIdx.x % TPI, r = threadIdx.x / TPI;
  const size_t at = ((size_t)blockIdx.x * ROWS + r) * TPI * W + gl * W;  // B a multiple of ROWS
  uint32_t* sa = sa_all[r];
  uint32_t a[W], nn[W], o[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    a[j] = x[at + j];
    nn[j] = nw[gl * W + j];
  }
  for (int p = 0; p < P; ++p) {
    stage<TPI, W>(sa, gl, a);
    if (FORM == 0) mont_mul<TPI, W>(sa, a, nn, n0inv, L32, lane, gl, o);
    if (FORM == 1) mont_mul_chain<TPI, W>(sa, a, nn, n0inv, L32, lane, gl, o);
    if (FORM == 2) mont_mul_ptx<TPI, W>(sa, a, nn, n0inv, L32, lane, gl, o);
#pragma unroll
    for (int j = 0; j < W; ++j) a[j] = o[j];
  }
#pragma unroll
  for (int j = 0; j < W; ++j) out[at + j] = a[j];
}

}  // namespace k6forms

// (TPI, W) pairs served: 129 words (n^2 of a 2048-bit key), 257 (547 limbs).
#define K6FORMS_EACH(X) X(32, 5) X(16, 9) X(8, 17) X(32, 9) X(16, 17) X(8, 33)

extern "C" int forms_modexp_launch(int tpi, const void* base, long long bgs, long long bbs,
                                   const void* wins, long long wgs, long long wbs,
                                   const void* n, const void* r2, const void* one, void* out,
                                   void* table, int G, int B, int L, int NW, void* stream) {
  using namespace cios32;
  const int w = (words_for(L) + tpi - 1) / tpi;
  dim3 grid((B + THREADS / tpi - 1) / (THREADS / tpi), G);
#define X(T, WW)                                                                         \
  if (tpi == T && w == WW) {                                                             \
    modexp32_kernel<T, WW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(                  \
        (const int*)base, bgs, bbs, (const int*)wins, wgs, wbs, (const int*)n,           \
        (const int*)r2, (const int*)one, (int*)out, (uint32_t*)table, B, L, NW);         \
    return (int)cudaGetLastError();                                                      \
  }
  K6FORMS_EACH(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Words of table scratch forms_modexp_launch needs.
extern "C" long long forms_table_words(int tpi, int G, int B, int L) {
  const int rows = cios32::THREADS / tpi;
  const int w = (cios32::words_for(L) + tpi - 1) / tpi;
  return (long long)G * ((B + rows - 1) / rows) * rows * 16 * w * tpi;
}

extern "C" int forms_chain_launch(int tpi, int w, int form, const void* x, const void* n,
                                  unsigned n0inv, void* out, int B, int L32, int P,
                                  void* stream) {
  using namespace k6forms;
  const int blocks = B / (cios32::THREADS / tpi);
#define X(T, WW)                                                                           \
  if (tpi == T && w == WW) {                                                               \
    if (form == 0)                                                                         \
      chain_kernel<T, WW, 0><<<blocks, cios32::THREADS, 0, (cudaStream_t)stream>>>(       \
          (const uint32_t*)x, (const uint32_t*)n, n0inv, (uint32_t*)out, L32, P);          \
    else if (form == 1)                                                                    \
      chain_kernel<T, WW, 1><<<blocks, cios32::THREADS, 0, (cudaStream_t)stream>>>(       \
          (const uint32_t*)x, (const uint32_t*)n, n0inv, (uint32_t*)out, L32, P);          \
    else                                                                                   \
      chain_kernel<T, WW, 2><<<blocks, cios32::THREADS, 0, (cudaStream_t)stream>>>(       \
          (const uint32_t*)x, (const uint32_t*)n, n0inv, (uint32_t*)out, L32, P);          \
    return (int)cudaGetLastError();                                                        \
  }
  K6FORMS_EACH(X)
#undef X
  return (int)cudaErrorInvalidValue;
}
