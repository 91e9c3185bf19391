// The measurements behind the 32-bit K4 and K7 (csrc/mod_mul.cu,
// csrc/mont_raw.cu), built and run by tools/k47_forms.py on one GPU.  The
// file is compiled twice: K47_PART 0 holds the K4 candidates, K47_PART 1 the
// K7 ones (each part includes one library source, whose launchers then
// appear once in the linked library).
//
// K4 (k4_forms_launch), at 8, 16 or 32 lanes a row:
//   form 0  the library's mod_mul32_kernel: a 2^d and b 2^d read into words,
//           two products through the 15-bit r2, no constant derived;
//   form 1  R32^2 mod n derived per row, r2 doubled 2d times mod n, then
//           mont32(a, R32^2) and mont32(b, .) (the prologue K6 runs);
//   form 2  the same constant derived once a block by its first warp into
//           shared memory, the other warps waiting at a block-wide barrier;
//   form 3  the prologue of form 1 alone: it writes R32^2 mod n as limbs.
// K7 (k7_forms_launch):
//   form 0  the library's mont_raw32_kernel: one product mont32(a 2^d, b);
//   form 1  mont32(a, b) = a b R32^-1, reduced below n, then d doublings.
//
// Not part of the library: nothing in the package loads it.

#if K47_PART == 0
#include "../pailliercryptolib_tpu_torch/csrc/mod_mul.cu"
#else
#include "../pailliercryptolib_tpu_torch/csrc/mont_raw.cu"
#endif

namespace k47forms {

using namespace cios32;

// Row set-up shared by the candidates: the row this thread's group works
// on, whether it stores, and n's words with n0inv32.  Every warp runs on
// (rows beyond B take row B - 1 and store nothing), so a block-wide barrier
// may follow.
struct Row {
  int lane, gl, r, row, L32, d;
  bool live;
};

template <int TPI>
__device__ __forceinline__ Row row_of(int B, int L) {
  Row q;
  q.lane = threadIdx.x & 31;
  q.gl = threadIdx.x % TPI;
  q.r = threadIdx.x / TPI;
  const int row = blockIdx.x * (THREADS / TPI) + q.r;
  q.live = row < B;
  q.row = q.live ? row : B - 1;
  q.L32 = words_for(L);
  q.d = 32 * q.L32 - 15 * L;
  return q;
}

#if K47_PART == 0

// FORM 1 / 2: R32^2 mod n = r2 doubled 2d times; FORM 3 stops there.
template <int TPI, int W, int FORM>
__global__ void __launch_bounds__(THREADS)
k4_const_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
                long long b_bs, const int* __restrict__ n, const int* __restrict__ r2,
                int* __restrict__ out, int B, int L) {
  constexpr int ROWS = THREADS / TPI;
  __shared__ uint32_t sa_all[ROWS][TPI * W];
  __shared__ uint32_t cw[TPI * W];
  const Row q = row_of<TPI>(B, L);
  const int g = blockIdx.y;
  uint32_t* sa = sa_all[q.r];
  const size_t at = ((size_t)g * B + q.row) * L;
  uint32_t nn[W], c[W], x[W];
  limbs_to_words<TPI, W>(n + (size_t)g * L, L, q.lane, q.gl, nn);
  const uint32_t n0 = neg_inv32(__shfl_sync(FULL, nn[0], 0, TPI));
  // form 2: warp 0 derives it (its rows alike: the ballots and shuffles
  // take every lane of the warp), its first row writes it
  if (FORM != 2 || threadIdx.x < 32) {
    limbs_to_words<TPI, W>(r2 + (size_t)g * L, L, q.lane, q.gl, c);
#pragma unroll 1
    for (int k = 0; k < 2 * q.d; ++k) dbl_mod<TPI, W>(c, nn, q.lane, q.gl);
  }
  if (FORM == 2) {
    if (q.r == 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) cw[q.gl * W + j] = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < W; ++j) c[j] = cw[q.gl * W + j];
  }
  if (FORM == 3) {
    stage<TPI, W>(sa, q.gl, c);
    if (q.live) words_to_limbs<TPI, W>(sa, L, q.gl, out + at);
    return;
  }
  limbs_to_words<TPI, W>(a + at, L, q.lane, q.gl, x);
  stage<TPI, W>(sa, q.gl, x);
  mont_mul<TPI, W>(sa, c, nn, n0, q.L32, q.lane, q.gl, x);  // a R32 mod n, < 2n
  limbs_to_words<TPI, W>(b + g * b_gs + q.row * b_bs, L, q.lane, q.gl, c);
  stage<TPI, W>(sa, q.gl, c);
  mont_mul<TPI, W>(sa, x, nn, n0, q.L32, q.lane, q.gl, c);  // a b mod n, < 1.5 n
  cond_sub<TPI, W>(c, nn, q.lane, q.gl);
  stage<TPI, W>(sa, q.gl, c);
  if (q.live) words_to_limbs<TPI, W>(sa, L, q.gl, out + at);
}

#else

// FORM 1: mont32(a, b) = a b R32^-1 mod n, below n, then times 2^d mod n.
template <int TPI, int W>
__global__ void __launch_bounds__(THREADS)
k7_dbl_kernel(const int* __restrict__ a, const int* __restrict__ b, long long b_gs,
              long long b_bs, const int* __restrict__ n, int* __restrict__ out, int B,
              int L) {
  constexpr int ROWS = THREADS / TPI;
  __shared__ uint32_t sa_all[ROWS][TPI * W];
  const Row q = row_of<TPI>(B, L);
  const int g = blockIdx.y;
  uint32_t* sa = sa_all[q.r];
  const size_t at = ((size_t)g * B + q.row) * L;
  uint32_t nn[W], x[W], y[W];
  limbs_to_words<TPI, W>(n + (size_t)g * L, L, q.lane, q.gl, nn);
  const uint32_t n0 = neg_inv32(__shfl_sync(FULL, nn[0], 0, TPI));
  limbs_to_words<TPI, W>(a + at, L, q.lane, q.gl, x);
  limbs_to_words<TPI, W>(b + g * b_gs + q.row * b_bs, L, q.lane, q.gl, y);
  stage<TPI, W>(sa, q.gl, x);
  mont_mul<TPI, W>(sa, y, nn, n0, q.L32, q.lane, q.gl, x);
  cond_sub<TPI, W>(x, nn, q.lane, q.gl);
#pragma unroll 1
  for (int k = 0; k < q.d; ++k) dbl_mod<TPI, W>(x, nn, q.lane, q.gl);
  stage<TPI, W>(sa, q.gl, x);
  if (q.live) words_to_limbs<TPI, W>(sa, L, q.gl, out + at);
}

#endif

}  // namespace k47forms

// (lanes, words a lane) served: L32 = 33, 65, 129, 257 words (L = 69, 137,
// 274, 547 limbs) at 8, 16 and 32 lanes a row.
#define K47FORMS_EACH(X)                                                       \
  X(8, 5) X(8, 9) X(8, 17) X(8, 33) X(16, 3) X(16, 5) X(16, 9) X(16, 17)       \
  X(32, 2) X(32, 3) X(32, 5) X(32, 9)

#if K47_PART == 0

extern "C" int k4_forms_launch(int form, int tpi, const void* a, const void* b,
                               long long b_gs, long long b_bs, const void* n,
                               const void* r2, void* out, int G, int B, int L,
                               void* stream) {
  using namespace cios32;
  using namespace k47forms;
  const int w = (words_for(L) + tpi - 1) / tpi;
  dim3 grid((B + THREADS / tpi - 1) / (THREADS / tpi), G);
  const cudaStream_t s = (cudaStream_t)stream;
#define ARGS \
  (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n, (const int*)r2, (int*)out, B, L
#define X(T, WW)                                                               \
  if (tpi == T && w == WW) {                                                   \
    if (form == 0) mod_mul32_kernel<T, WW><<<grid, THREADS, 0, s>>>(ARGS);     \
    if (form == 1) k4_const_kernel<T, WW, 1><<<grid, THREADS, 0, s>>>(ARGS);   \
    if (form == 2) k4_const_kernel<T, WW, 2><<<grid, THREADS, 0, s>>>(ARGS);   \
    if (form == 3) k4_const_kernel<T, WW, 3><<<grid, THREADS, 0, s>>>(ARGS);   \
    return form < 0 || form > 3 ? (int)cudaErrorInvalidValue : (int)cudaGetLastError(); \
  }
  K47FORMS_EACH(X)
#undef X
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

#else

extern "C" int k7_forms_launch(int form, int tpi, const void* a, const void* b,
                               long long b_gs, long long b_bs, const void* n, void* out,
                               int G, int B, int L, void* stream) {
  using namespace cios32;
  using namespace k47forms;
  const int w = (words_for(L) + tpi - 1) / tpi;
  dim3 grid((B + THREADS / tpi - 1) / (THREADS / tpi), G);
  const cudaStream_t s = (cudaStream_t)stream;
#define ARGS (const int*)a, (const int*)b, b_gs, b_bs, (const int*)n, (int*)out, B, L
#define X(T, WW)                                                               \
  if (tpi == T && w == WW) {                                                   \
    if (form == 0) mont_raw32_kernel<T, WW><<<grid, THREADS, 0, s>>>(ARGS);    \
    if (form == 1) k7_dbl_kernel<T, WW><<<grid, THREADS, 0, s>>>(ARGS);        \
    return form < 0 || form > 1 ? (int)cudaErrorInvalidValue : (int)cudaGetLastError(); \
  }
  K47FORMS_EACH(X)
#undef X
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

#endif
