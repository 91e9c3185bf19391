// P2, P4 — one primitive, `iters` dependent steps x <- op(x, c), for Hopper.
//
// Replaces: the JAX package's benchmarks/probe_ops.py (make_kernel, its
// eleven steps on [32, 128, 256], one constant a column) and
// benchmarks/probe_vpu_ops.py (_mk, seven steps acc <- op(acc, y) on
// [256, 512]).  Computes what chain_kernel<OP> of probes.cu, the first form,
// computes, bit for bit: element idx runs `iters` steps of probe_ops.cuh's
// step<OP> on x[idx] with the operand c[idx % cmod].
//
// A chain is bound by the rate at which an SM starts its one instruction.
// The first form left issue slots unused in three ways, and this one
// removes each:
//
// - One element a thread is one dependent chain a warp: a scheduler needs
//   four or more ready warps to cover a 4-cycle FMUL / IMAD.  Here a thread
//   carries E independent elements (template parameter, 1, 2, 4 or 8),
//   interleaved step by step, so a warp has E instructions to issue before
//   it needs the first result.  The launcher's caller picks E from n and
//   cmod (cuda_probes.chain_elems), never from the data.
// - A loop of 16 steps whose trip count is only known at run time spends 3
//   of every 19 issue slots on its counter, compare and branch.  Here the
//   steps run in blocks of S = 64 (E = 1) or 32 (E > 1) steps, unrolled at
//   compile time, inside a loop over iters / S: its counter, compare and
//   branch are 3 of 67 issue slots of a one-instruction step at E = 1 and 2
//   (4.5%), 3 of 131 at E = 4.  The remaining iters % S steps run one at a
//   time after it.
// - 512 blocks of 256 threads leave 116 SMs with four blocks and 16 with
//   three.  Here the grid is the SM count times the blocks an SM holds at
//   once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or fewer when
//   the work is smaller, and a grid-stride loop hands out chunks of E x 128
//   elements: every block is resident from the start (no second wave) and
//   the blocks' shares differ by at most one chunk.  128 threads a block
//   give each of an SM's four schedulers one warp of every block.
//
// Loads and stores: a thread's E words are contiguous, read and written by
// one 8-byte (E = 2) or 16-byte (E >= 4) access when x and out are aligned
// to it (vec_x); its E operands likewise when cmod is a multiple of E and c
// is aligned (vec_c: the run c[i0 % cmod ..] then never wraps).  Otherwise,
// and for the last group of a ragged n, word by word, the operand index
// wrapping at cmod.  Lanes past n compute on zeros and store nothing.
//
// An empty asm statement after every step of every element keeps the
// compiler's front end from replacing a chain by its closed form or
// hoisting it; it emits no instruction, and ptxas still merges what the
// hardware's instructions allow (two adds in one IADD3, x ^ c ^ c = x,
// shifts by constants), as in the first form.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ops.cuh"

namespace probes {

constexpr int CHAIN_THREADS = 128;

template <int E>
__host__ __device__ constexpr int chain_block_steps() { return E == 1 ? 64 : 32; }

template <int E>
__device__ __forceinline__ void load_run(const uint32_t* __restrict__ p, uint32_t (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = p[0];
  } else if constexpr (E == 2) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ p, const uint32_t (&v)[E]) {
  if constexpr (E == 1) {
    p[0] = v[0];
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// one step of each of the E chains
template <int OP, int E>
__device__ __forceinline__ void step_all(uint32_t (&v)[E], const uint32_t (&cv)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = step<OP>(v[e], cv[e]);
    asm volatile("" : "+r"(v[e]));
  }
}

// x, out [n] words; c [cmod] words.  Thread t of block b takes the groups
// g = b * 128 + t + k * gridDim.x * 128 (k = 0, 1, ...) below ceil(n / E);
// group g is the elements g * E .. g * E + E - 1 (those below n).
template <int OP, int E>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ c,
             uint32_t* __restrict__ out, long long n, long long cmod, int iters,
             int vec_x, int vec_c) {
  constexpr int S = chain_block_steps<E>();
  const long long groups = (n + E - 1) / E;
  const long long stride = (long long)gridDim.x * CHAIN_THREADS;
  const int blocks = iters / S, rest = iters - blocks * S;
  for (long long g = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g * E;
    const bool whole = i0 + E <= n;
    uint32_t v[E], cv[E];
    if (whole && vec_x) {
      load_run<E>(x + i0, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = i0 + e < n ? x[i0 + e] : 0u;
    }
    long long ci = i0 % cmod;
    if (whole && vec_c) {
      load_run<E>(c + ci, cv);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        cv[e] = c[ci];
        ci = ci + 1 == cmod ? 0 : ci + 1;
      }
    }
    for (int b = 0; b < blocks; ++b) {
#pragma unroll
      for (int s = 0; s < S; ++s) step_all<OP, E>(v, cv);
    }
#pragma unroll 1
    for (int s = 0; s < rest; ++s) step_all<OP, E>(v, cv);
    if (whole && vec_x) {
      store_run<E>(out + i0, v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (i0 + e < n) out[i0 + e] = v[e];
    }
  }
}

// Resident blocks an SM holds of one instance, asked once an instance.
template <int OP, int E>
static cudaError_t blocks_per_sm(int* out) {
  static int cached = 0;
  if (!cached) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, chain_kernel<OP, E>, CHAIN_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  *out = cached;
  return cudaSuccess;
}

// grid = min(ceil(ceil(n / E) / 128), SMs x resident blocks an SM)
template <int OP, int E>
static cudaError_t chain_grid(long long n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<OP, E>(&per_sm);
  if (err != cudaSuccess) return err;
  const long long need = ((n + E - 1) / E + CHAIN_THREADS - 1) / CHAIN_THREADS;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < cap ? need : cap);
  return cudaSuccess;
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// launch (x != nullptr) or report the grid (grid_out != nullptr)
template <int OP, int E>
static int chain_run(const void* x, const void* c, void* out, long long n, long long cmod,
                     int iters, int* grid_out, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = chain_grid<OP, E>(n, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid_out) {
    *grid_out = grid;
    return 0;
  }
  constexpr int vec_bytes = 4 * (E < 4 ? E : 4);
  const int vec_x = aligned(x, vec_bytes) && aligned(out, vec_bytes);
  const int vec_c = cmod % E == 0 && aligned(c, vec_bytes);
  chain_kernel<OP, E><<<grid, CHAIN_THREADS, 0, st>>>(
      (const uint32_t*)x, (const uint32_t*)c, (uint32_t*)out, n, cmod, iters, vec_x, vec_c);
  return (int)cudaGetLastError();
}

template <int E>
static int chain_dispatch(const void* x, const void* c, void* out, long long n,
                          long long cmod, int op, int iters, int* grid_out, cudaStream_t st) {
#define CHAIN_CASE(OP) \
  case OP:             \
    return chain_run<OP, E>(x, c, out, n, cmod, iters, grid_out, st)
  switch (op) {
    CHAIN_CASE(OP_ADD); CHAIN_CASE(OP_XOR); CHAIN_CASE(OP_SHIFT); CHAIN_CASE(OP_MUL);
    CHAIN_CASE(OP_MUL_CONST); CHAIN_CASE(OP_MUL_SELF); CHAIN_CASE(OP_WHERE_SUB);
    CHAIN_CASE(OP_CVT_ROUNDTRIP); CHAIN_CASE(OP_FMUL); CHAIN_CASE(OP_MUL_I32);
    CHAIN_CASE(OP_MUL_MASK12); CHAIN_CASE(OP_SHIFT_ADD); CHAIN_CASE(OP_MUL_ADD);
    CHAIN_CASE(OP_FMUL_ADD);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CHAIN_CASE
}

static int chain_elems_dispatch(const void* x, const void* c, void* out, long long n,
                                long long cmod, int op, int elems, int iters,
                                int* grid_out, cudaStream_t st) {
  if (n <= 0 || cmod <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  switch (elems) {
    case 1: return chain_dispatch<1>(x, c, out, n, cmod, op, iters, grid_out, st);
    case 2: return chain_dispatch<2>(x, c, out, n, cmod, op, iters, grid_out, st);
    case 4: return chain_dispatch<4>(x, c, out, n, cmod, op, iters, grid_out, st);
    case 8: return chain_dispatch<8>(x, c, out, n, cmod, op, iters, grid_out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace probes

using namespace probes;

// x, out [n] words, c [cmod] words, `elems` (E) 1, 2, 4 or 8.
extern "C" int probe_chain_launch(const void* x, const void* c, void* out, long long n,
                                  long long cmod, int op, int elems, int iters,
                                  void* stream) {
  return chain_elems_dispatch(x, c, out, n, cmod, op, elems, iters, nullptr,
                              (cudaStream_t)stream);
}

// The grid probe_chain_launch takes for n elements (negative: a CUDA error).
extern "C" int probe_chain_grid(long long n, int op, int elems) {
  int grid = 0;
  int err = chain_elems_dispatch(nullptr, nullptr, nullptr, n, 1, op, elems, 0, &grid,
                                 nullptr);
  return err ? -err : grid;
}
