// P2, P4 — the primitives of the dependent chains: one step x <- op(x, c).
// Shared by the chain kernels of probes.cu (the first form, one element a
// thread) and probe_chain.cu (E interleaved elements a thread).  Float steps
// use the _rn intrinsics, so a multiply and an add are never contracted into
// one fused multiply-add and the result equals the plain version's bit for
// bit.

#pragma once

#include <cstdint>

namespace probes {

enum Op {
  OP_ADD = 0,       // x + c
  OP_XOR,           // x ^ c
  OP_SHIFT,         // x >> 3
  OP_MUL,           // x * c
  OP_MUL_CONST,     // x * 12289
  OP_MUL_SELF,      // x * x
  OP_WHERE_SUB,     // x >= c ? x - c : x
  OP_CVT_ROUNDTRIP, // u32 -> i32 -> f32 -> i32 -> u32
  OP_FMUL,          // f32 x * c
  OP_MUL_I32,       // (int)x * (int)c
  OP_MUL_MASK12,    // (x & 0xFFF) * (c & 0xFFF)
  OP_SHIFT_ADD,     // (x >> 3) + c
  OP_MUL_ADD,       // x * c + c
  OP_FMUL_ADD,      // f32 x * c + c, two roundings
  NUM_OPS
};

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t x, uint32_t c) {
  switch (OP) {
    case OP_ADD: return x + c;
    case OP_XOR: return x ^ c;
    case OP_SHIFT: return x >> 3;
    case OP_MUL: return x * c;
    case OP_MUL_CONST: return x * 12289u;
    case OP_MUL_SELF: return x * x;
    case OP_WHERE_SUB: return x >= c ? x - c : x;
    case OP_CVT_ROUNDTRIP:
      return (uint32_t)__float2int_rz(__int2float_rn((int)x));
    case OP_FMUL:
      return __float_as_uint(__fmul_rn(__uint_as_float(x), __uint_as_float(c)));
    case OP_MUL_I32: return (uint32_t)((int)x * (int)c);
    case OP_MUL_MASK12: return (x & 0xFFFu) * (c & 0xFFFu);
    case OP_SHIFT_ADD: return (x >> 3) + c;
    case OP_MUL_ADD: return x * c + c;
    case OP_FMUL_ADD: {
      float cf = __uint_as_float(c);
      return __float_as_uint(__fadd_rn(__fmul_rn(__uint_as_float(x), cf), cf));
    }
  }
  return x;
}

}  // namespace probes
