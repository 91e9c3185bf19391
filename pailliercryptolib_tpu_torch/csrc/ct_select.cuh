// Table selects whose addresses take no secret: the 16-entry power table of
// K3 (rns_modexp2f.cu) and K5 (rns_modexp2.cu), the library forms of both.
//
// Replaces: the selects of the JAX package's ops/pallas_rns2.py, which read
// every entry of a 16-entry table and choose with jnp.where (the per-row
// windows of _modexp2_kernel_var) or index a table that lives in VMEM
// scratch, a memory with no cache (the shared windows of K3 and K5), and
// ops/pallas_modexp.py _select_pow ("Constant-time 16-way table select").
//
// On this card the per-row tables are global scratch that L1 / L2 serve, so
// the time of a load can depend on its address.  A window here is the private
// key (lambda; p - 1 and q - 1), a plaintext scalar or an obfuscator
// exponent: no load address, no branch and no register index may take it.
// The table of a (row, lane) is laid out as its 16 entries side by side,
// 64 contiguous bytes ([row][lane][16] words, entry t = r_A | z_B << 16, both
// residues below 2^15): select16 reads all of it by four 16-byte loads whose
// addresses are the row's and the lane's only, and keeps the entry the
// window names with a mask in registers (one AND-OR a word).

#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace prns {
namespace ctsel {

// m[t]: the bits of entry t that windows wa (the A residue, low half) and wb
// (the B residue, high half) keep; all ones in a half where t is its window,
// zero elsewhere.  Computed by comparisons, never by an index.
__device__ __forceinline__ void window_masks(uint32_t (&m)[16], uint32_t wa, uint32_t wb) {
#pragma unroll
  for (int t = 0; t < 16; ++t)
    m[t] = ((0u - (uint32_t)(wa == (uint32_t)t)) & 0x0000FFFFu) |
           ((0u - (uint32_t)(wb == (uint32_t)t)) & 0xFFFF0000u);
}

// The entry of the 16 words at e (16-byte aligned) that masks m keep: every
// word is loaded, at addresses that do not depend on the window, and the
// masks combine them.
__device__ __forceinline__ uint32_t select16(const uint32_t* e, const uint32_t (&m)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(e);
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = q[i];
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y |= (v[i].x & m[4 * i]) | (v[i].y & m[4 * i + 1]) | (v[i].z & m[4 * i + 2]) |
         (v[i].w & m[4 * i + 3]);
  return y;
}

}  // namespace ctsel
}  // namespace prns
