// K4 — grouped modular product a*b mod n on 15-bit limbs, canonical output:
// two redundant-digit CIOS Montgomery products (through R^2), a sequential
// carry resolve and one conditional subtract.
//
// Replaces: the JAX package's ops/pallas_modexp.py pallas_mod_mul /
// _mod_mul_kernel (through _binary_pallas), with its device functions
// _mont_mul, _canonicalize and _cond_sub.  The reference transposes to a
// limb-major layout to put the batch on the TPU's lane axis; that is a lane
// layout device and is not carried over: operands stay [G][B][L].
//
// On this card: the work is tiny on the decrypt path (two calls, ~2*L^2
// multiply-adds per row and product, L = 69 for a 2048-bit key), so the
// first form is the plainest one: one thread per batch row, the digits in
// thread-local arrays (local memory is interleaved per thread, so limb i of
// neighbouring rows sits in neighbouring words).  Bound by integer issue at
// low occupancy, and by its uncoalesced row reads; both are small beside the
// modexp kernels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LIMB_BITS = 15;
constexpr uint32_t LIMB_MASK = (1u << LIMB_BITS) - 1;
constexpr int MAX_L = 160;
constexpr int THREADS = 64;

// acc <- a*b*R^{-1} mod n as redundant digits <= 2^15 (value < 2n).
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b,
                                         const uint32_t* n, uint32_t n0inv, int L,
                                         uint32_t* acc /* [L+1] */) {
  for (int l = 0; l <= L; ++l) acc[l] = 0;
  const uint32_t b0 = b[0];
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a[i];
    const uint32_t t0 = acc[0] + ai * b0;
    const uint32_t mi = (t0 * n0inv) & LIMB_MASK;
    // add lo at column l and hi at column l+1, then shift down one digit
    uint32_t p1 = ai * b[0], p2 = mi * n[0];
    uint32_t carry0 = (acc[0] + (p1 & LIMB_MASK) + (p2 & LIMB_MASK)) >> LIMB_BITS;
    uint32_t hi_prev = (p1 >> LIMB_BITS) + (p2 >> LIMB_BITS);
    for (int l = 1; l < L; ++l) {
      p1 = ai * b[l];
      p2 = mi * n[l];
      acc[l - 1] = acc[l] + (p1 & LIMB_MASK) + (p2 & LIMB_MASK) + hi_prev;
      hi_prev = (p1 >> LIMB_BITS) + (p2 >> LIMB_BITS);
    }
    acc[L - 1] = acc[L] + hi_prev;
    acc[L] = 0;
    acc[0] += carry0;
  }
  // two redundant carry rounds: digits <= 2^15
  for (int round = 0; round < 2; ++round) {
    uint32_t carry = 0;
    for (int l = 0; l <= L; ++l) {
      uint32_t v = acc[l];
      acc[l] = (v & LIMB_MASK) + carry;
      carry = v >> LIMB_BITS;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mod_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
               const int* __restrict__ n, const int* __restrict__ n0inv,
               const int* __restrict__ r2, int* __restrict__ out, int B, int L) {
  __shared__ uint32_t ns[MAX_L], r2s[MAX_L];
  const int g = blockIdx.y;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    ns[l] = (uint32_t)n[g * L + l];
    r2s[l] = (uint32_t)r2[g * L + l];
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const uint32_t n0 = (uint32_t)n0inv[g];
  const size_t base = ((size_t)g * B + row) * L;
  uint32_t x[MAX_L], y[MAX_L], acc[MAX_L + 1];
  for (int l = 0; l < L; ++l) {
    x[l] = (uint32_t)a[base + l];
    y[l] = (uint32_t)b[base + l];
  }
  mont_mul(x, r2s, ns, n0, L, acc);     // a * R mod n
  for (int l = 0; l < L; ++l) x[l] = acc[l];
  mont_mul(x, y, ns, n0, L, acc);       // a * b mod n, value < 2n
  // full carry propagation
  uint32_t carry = 0;
  for (int l = 0; l < L; ++l) {
    uint32_t t = acc[l] + carry;
    acc[l] = t & LIMB_MASK;
    carry = t >> LIMB_BITS;
  }
  // conditional subtract: diff = acc - n, kept when no borrow out
  uint32_t borrow = 0;
  for (int l = 0; l < L; ++l) {
    uint32_t sub = ns[l] + borrow;
    borrow = acc[l] < sub ? 1u : 0u;
    x[l] = (acc[l] - sub) & LIMB_MASK;
  }
  for (int l = 0; l < L; ++l)
    out[base + l] = (int)(borrow ? acc[l] : x[l]);
}

}  // namespace

extern "C" int mod_mul_launch(const void* a, const void* b, const void* n,
                              const void* n0inv, const void* r2, void* out, int G,
                              int B, int L, void* stream) {
  if (L > MAX_L) return (int)cudaErrorInvalidValue;
  dim3 grid((B + THREADS - 1) / THREADS, G);
  mod_mul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (const int*)n, (const int*)n0inv,
      (const int*)r2, (int*)out, B, L);
  return (int)cudaGetLastError();
}
