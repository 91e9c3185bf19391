// Tensor-core form of the RNS Montgomery product for Hopper (sm_90a): the
// device function of the CRT-folded modexp (K3) and of the fixed-base modexp
// (K2) on constant sets of up to 320 lanes.
//
// Replaces: the JAX package's ops/pallas_rns2.py _make_mont_mul2 / _mm_terms /
// _mm8, which run the base extensions on the TPU's matrix unit.
//
// What it computes: the same product as prns::mont_mul2 (rns_mont_mul.cuh),
// integer for integer: x*y*M_A^{-1} mod N on (A-side, scaled-B-side) residue
// pairs, three fused reductions (sigma, z_B, r_A), two base extensions.  The
// plane sums ll / mid / hh are the same integers in any order (int32 sums of
// at most 2 * 320 * 127^2 ~ 1.0e7), and the Kawamura alpha estimate adds its
// three float terms in the order and with the round-to-nearest intrinsics of
// rns_mont_mul.cuh, so the results are bit-equal to it and to the plain
// version (ops/cuda_rns2.mont_mul2_plain).
//
// What bounds it on this card.  A base extension is a [rows, k] x [k, ~k]
// product of 7-bit digit planes; on the CUDA cores (`dp4a`, rns_mont_mul.cuh)
// it sits at the issue ceiling, and every block of 8 rows re-read ~384 KB of
// weights from L2 per product.  Here:
//   * one int8 tensor-core product per extension: mma.sync m16n8k32
//     (s8 x s8 -> s32).  M stacks a row's low digits (tile row g) over its
//     high digits (row g + 8); N interleaves each lane's Tlo (column 2t) and
//     Thi (column 2t + 1) weights; K is the contraction padded to a multiple
//     of 32.  The accumulator fragment of thread (g, t) then holds ll,
//     lo*Thi, hi*Tlo and hh of ONE (row, lane): the epilogues run on it in
//     registers, and that thread is the owner of the (row, lane) for the
//     whole launch.
//   * the weights stay on chip: the lane axis is split over a cluster of
//     CLUSTER = 4 CTAs, each of which loads its quarter of T1 and T2 (~100 KB
//     as fragment-ordered int8 planes for a 2048-bit key) into shared memory
//     once per launch.  The digits every CTA needs for the full contraction
//     are written as bytes into the CTA's own fragments, then the words its
//     lanes filled are copied into the other three CTAs' shared memory
//     (distributed shared memory, 16-byte stores where a fragment's halves
//     belong to one CTA); so are the group-scoped alpha' values, which only the CTA owning the trailing
//     G columns of T2 computes (it alone holds the z_B of the redundant
//     lanes).  The Kawamura alpha needs only sigma's digits, which every CTA
//     holds: every CTA computes it from its own copy of T1's alpha columns.
//   * three cluster barriers a product, the dependency chain's own: sigma ->
//     (1) extension 1, alpha -> z_B -> (3) extension 2 -> alpha' -> (4) r_A;
//     CTA barriers order the rest (each digit copy waits for its CTA's bytes;
//     alpha is this CTA's own).  Digits of sigma and of z_B have buffers of
//     their own, so no barrier guards a buffer's reuse.
//   * the extensions read the digit fragments from shared memory, which is
//     what limits them: a warp owns NL = 2 n-tiles (8 lanes), so each A
//     fragment it reads feeds two products.
// A cluster owns ROWS = 72 batch rows (MT = 9 m-tiles).  Warp w of a CTA owns
// n-tiles 2w and 2w + 1 for all 72 rows: thread (g, t) the lanes 8w + t and
// 8w + 4 + t of its CTA's quarter, rows g, g + 8, ..., g + 64.  So a CTA runs
// W threads (320 for W = 320: up to 204 registers a thread), and 2048 rows
// are 29 clusters = 116 CTAs.  The H100 holds 30 such clusters at once (one
// CTA a SM by shared memory, four SMs of one GPC a cluster); 64 rows a
// cluster took 32 clusters, and the last two ran as a second wave.
//
// Shared memory of a CTA (dynamic, in 32-bit words), laid out for the widest
// set (MAX_KC = 10 chunks of 32 in the contraction, MAX_NT = 20 n-tiles and
// 80 lanes a CTA, 320 threads) whatever the set, so that every address is a
// constant offset and no register holds a pointer into it:
//   aS, aZ    [MT][MAX_KC][32 threads][4]  A fragments: digits of sigma / z_B
//   wt1, wt2  [MAX_KC][MAX_NT][32][2]      B fragments of T1 / T2 (this CTA's lanes)
//   alpha, alpha2  [2][ROWS]               group-scoped alpha / alpha'
//   lc        [NROWS][MAX_W / 4]           per-lane constants (rowc), this CTA's lanes
//   vt        [MT][NL][MAX_THREADS]        each thread's v_B (+ t_B), later its
//                                          t_A, kept out of registers across the
//                                          extensions
//   wta       [MAX_KC][2][32][2]           B fragments of T1's n-tiles kb / 4 and
//                                          kb / 4 + 1: the alpha columns
// 232,192 bytes of the 232,448 a CTA may have: one CTA a SM.

#pragma once
#include <cooperative_groups.h>

#include "rns_mont_mul.cuh"

namespace prns {
namespace tc {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 4;            // CTAs a cluster: each owns W / 4 lanes
constexpr int MT = 9;                 // m16 tiles: 8 batch rows each
constexpr int ROWS = 8 * MT;          // batch rows a cluster
constexpr int NL = 2;                 // n-tiles a warp = lanes a thread
constexpr int MAX_W = 320;            // lanes (the lean fold's contraction limit)
constexpr int MAX_THREADS = MAX_W;    // W / (4 * CLUSTER * NL) warps a CTA
constexpr int MAX_KC = MAX_W / 32;    // contraction chunks of 32
constexpr int MT_GROUP = 3;           // m-tiles whose products are in flight at once
static_assert(MT % MT_GROUP == 0, "m-tiles come in groups of MT_GROUP");

struct Dims {
  int k;    // A lanes (both groups when folded) = contraction length
  int kb;   // B lanes including the G redundant lanes
  int W;    // lanes of the constant set (rowc row stride), multiple of 32
  int KC;   // ceil(k / 32)
};

__host__ __device__ inline int n_tiles(const Dims& d) { return d.W / (4 * CLUSTER); }
__host__ __device__ inline int lanes_per_cta(const Dims& d) { return d.W / CLUSTER; }
__host__ __device__ inline int threads(const Dims& d) { return d.W; }
// words of one weight array (T1 or T2) of one CTA in global memory
__host__ __device__ inline int weight_words(const Dims& d) { return d.KC * n_tiles(d) * 64; }

constexpr int MAX_NT = MAX_W / (4 * CLUSTER);
constexpr int LC_STRIDE = MAX_W / CLUSTER;
constexpr int OFF_AS = 0;
constexpr int OFF_AZ = OFF_AS + MT * MAX_KC * 128;
constexpr int OFF_WT1 = OFF_AZ + MT * MAX_KC * 128;
constexpr int OFF_WT2 = OFF_WT1 + MAX_KC * MAX_NT * 64;
constexpr int OFF_ALPHA = OFF_WT2 + MAX_KC * MAX_NT * 64;
constexpr int OFF_ALPHA2 = OFF_ALPHA + 2 * ROWS;
constexpr int OFF_LC = OFF_ALPHA2 + 2 * ROWS;
constexpr int OFF_VT = OFF_LC + NROWS * LC_STRIDE;
constexpr int OFF_WTA = OFF_VT + MT * NL * MAX_THREADS;
constexpr int SMEM_BYTES = 4 * (OFF_WTA + MAX_KC * 2 * 64);
static_assert(SMEM_BYTES <= 232448, "a CTA's shared memory on sm_90");

// What the launchers take; anything else is refused before launch.
inline bool dims_fit(const Dims& d, int G) {
  return d.W > 0 && d.W <= MAX_W && d.W % (4 * CLUSTER * NL) == 0 && d.k > 0 &&
         d.KC == (d.k + 31) / 32 && d.KC * 32 <= d.W && d.k + G <= d.W &&
         d.kb + G <= d.W;
}

}  // namespace tc
}  // namespace prns

extern __shared__ __align__(16) uint32_t prns_tc_smem[];

namespace prns {
namespace tc {

struct Smem {
  uint32_t* wt1;
  uint32_t* wt2;
  uint32_t* aS;
  uint32_t* aZ;
  uint32_t* alpha;
  uint32_t* alpha2;
  uint32_t* lc;
  uint32_t* vt;
  uint32_t* wta;
};

__device__ __forceinline__ Smem carve() {
  Smem s;
  s.aS = prns_tc_smem + OFF_AS;
  s.aZ = prns_tc_smem + OFF_AZ;
  s.wt1 = prns_tc_smem + OFF_WT1;
  s.wt2 = prns_tc_smem + OFF_WT2;
  s.alpha = prns_tc_smem + OFF_ALPHA;
  s.alpha2 = prns_tc_smem + OFF_ALPHA2;
  s.lc = prns_tc_smem + OFF_LC;
  s.vt = prns_tc_smem + OFF_VT;
  s.wta = prns_tc_smem + OFF_WTA;
  return s;
}

// This thread's place: warp w owns n-tiles 2w and 2w + 1 of its CTA's
// quarter; lane-in-warp l = 4g + t; its lanes are jl0 + 4 nl (nl < NL).
struct Place {
  int l, g, t, w;
  int jl0;   // first lane within the CTA's quarter
  int j0;    // first lane of the constant set
  int rank;  // CTA rank in the cluster
};

__device__ __forceinline__ Place place(const Dims& d, unsigned rank) {
  Place p;
  p.l = threadIdx.x & 31;
  p.w = threadIdx.x >> 5;
  p.g = p.l >> 2;
  p.t = p.l & 3;
  p.jl0 = 4 * NL * p.w + p.t;
  p.rank = (int)rank;
  p.j0 = p.rank * lanes_per_cta(d) + p.jl0;
  return p;
}

// The same shared-memory word in the CTA of rank `rank`, as a 32-bit address
// of the cluster's shared window (a 64-bit generic pointer for each of the
// four ranks would hold twice the registers).
__device__ __forceinline__ uint32_t remote_addr(const uint32_t* local, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(r)
      : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(lo), "r"(hi)
               : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// This thread's slot (lane nl, m-tile mt) of vt: v_B (+ t_B), then t_A
// inside a product; the kernels may stage a product's operand there before it.
__device__ __forceinline__ uint32_t& vt_slot(const Smem& s, int nl, int mt) {
  return s.vt[threadIdx.x + (mt * NL + nl) * MAX_THREADS];
}

// Per-lane constant of row `row` (RowId) for this thread's lane nl.
__device__ __forceinline__ uint32_t lane_const(const Smem& s, const Place& p, int row,
                                               int nl) {
  return s.lc[row * LC_STRIDE + p.jl0 + 4 * nl];
}

// Once per launch: this CTA's weight fragments and lane constants into shared
// memory, then a cluster barrier (every CTA of the cluster has started before
// any pushes into its shared memory).
// T1a: [KC][2][32][2] words, the B fragments of T1's n-tiles kb / 4 and kb / 4
// + 1 (whichever CTA owns them), for this CTA's own alpha.
__device__ __forceinline__ void load_chip_state(const Smem& s, const Dims& d,
                                                const Place& p,
                                                const uint32_t* __restrict__ rowc,
                                                const uint32_t* __restrict__ T1,
                                                const uint32_t* __restrict__ T2,
                                                const uint32_t* __restrict__ T1a) {
  // global [KC][NT][32][2] words -> shared [KC][MAX_NT][32][2], as uint4
  const int nt16 = n_tiles(d) * 16, nw4 = weight_words(d) / 4;
  const uint4* g1 = reinterpret_cast<const uint4*>(T1 + (size_t)p.rank * weight_words(d));
  const uint4* g2 = reinterpret_cast<const uint4*>(T2 + (size_t)p.rank * weight_words(d));
  uint4* s1 = reinterpret_cast<uint4*>(s.wt1);
  uint4* s2 = reinterpret_cast<uint4*>(s.wt2);
  for (int i = threadIdx.x; i < nw4; i += blockDim.x) {
    const int kc = i / nt16, o = kc * MAX_NT * 16 + (i - kc * nt16);
    s1[o] = __ldg(&g1[i]);
    s2[o] = __ldg(&g2[i]);
  }
  for (int i = threadIdx.x; i < d.KC * 32; i += blockDim.x)
    reinterpret_cast<uint4*>(s.wta)[i] = __ldg(&reinterpret_cast<const uint4*>(T1a)[i]);
  const int Wc = lanes_per_cta(d);
  for (int i = threadIdx.x; i < NROWS * Wc; i += blockDim.x) {
    int row = i / Wc, jl = i - row * Wc;
    s.lc[row * LC_STRIDE + jl] = __ldg(&rowc[row * d.W + p.rank * Wc + jl]);
  }
  cg::this_cluster().sync();
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// Put the 7-bit digits of value v (row 8*mt + g, this thread's lane nl) into
// this CTA's A fragments `buf`, as two byte stores.  Fragment (mt, kc),
// thread 4g' + t', register r holds bytes k = 16 (r >> 1) + 4 t' .. + 3 of
// tile row g' + 8 (r & 1): row g's low digits, then its high.
__device__ __forceinline__ void put_digits(uint32_t* buf, const Dims& d, const Place& p,
                                           int mt, int nl, uint32_t v) {
  const int j = p.j0 + 4 * nl;
  if (j < d.KC * 32) {
    const int kc = j >> 5, u = (j & 31) >> 2;
    uint8_t* w = reinterpret_cast<uint8_t*>(buf) +
                 (((mt * MAX_KC + kc) * 32 + p.g * 4 + (u & 3)) * 4 + (u >> 2) * 2) * 4 + (j & 3);
    w[0] = (uint8_t)(v & DIGIT_MASK);
    w[4] = (uint8_t)(v >> DIGIT_BITS);
  }
}

// After every thread of the CTA has put its digits into `buf`: copy the
// fragment words this CTA's lanes filled into the same place in the other
// CTAs of the cluster, 16 bytes a store where both halves of a thread's
// fragment belong to this CTA (lanes q and q + 16 of a chunk), else 8.
__device__ __forceinline__ void share_digits(uint32_t* buf, const Dims& d, const Place& p) {
  __syncthreads();
  const int Wc = lanes_per_cta(d), lo = p.rank * Wc, hi = lo + Wc;  // this CTA's lanes
  const int kc0 = lo >> 5, nkc = min((hi - 1) >> 5, d.KC - 1) - kc0 + 1;
  if (nkc <= 0) return;
  const int items = MT * nkc * 32;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int th = i & 31, kc = kc0 + (i >> 5) % nkc, mt = (i >> 5) / nkc;
    const int q = kc * 32 + 4 * (th & 3);  // lanes of the slot's halves: q.., q + 16..
    const bool h0 = q >= lo && q < hi, h1 = q + 16 >= lo && q + 16 < hi;
    uint32_t* src = buf + ((mt * MAX_KC + kc) * 32 + th) * 4;
    if (h0 && h1) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r)
        st_remote(remote_addr(src, (p.rank + r) % CLUSTER), v);
    } else if (h0 || h1) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + (h1 ? 2 : 0));
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r)
        st_remote(remote_addr(src + (h1 ? 2 : 0), (p.rank + r) % CLUSTER), v.x, v.y);
    }
  }
}

// One base extension: for each m-tile mt and lane nl, epi(nl, mt, c) with c
// the accumulator fragment of (row 8*mt + g, lane nl) = {ll, lo*Thi, hi*Tlo,
// hh}.  Each A fragment read from shared memory feeds the warp's NL n-tiles;
// MT_GROUP m-tiles are in flight at a time, and each epilogue folds its
// fragment away at once, so that no more than NL * MT_GROUP accumulators are
// ever live.
template <bool EXT, typename Epi>
__device__ __forceinline__ void extend(const uint32_t* wt, const uint32_t* a,
                                       const Dims& d, const Place& p, Epi&& epi) {
  const uint2* bw = reinterpret_cast<const uint2*>(wt) + NL * p.w * 32 + p.l;
  const uint4* aw = reinterpret_cast<const uint4*>(a) + p.l;
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += MT_GROUP) {
    int c[NL][MT_GROUP][4];
#pragma unroll
    for (int nl = 0; nl < NL; ++nl)
#pragma unroll
      for (int u = 0; u < MT_GROUP; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[nl][u][i] = 0;
    if (EXT) {
      // not unrolled in full: that would let the compiler hoist every chunk's
      // fragment loads into registers
#pragma unroll 2
      for (int kc = 0; kc < d.KC; ++kc) {
        uint2 b[NL];
#pragma unroll
        for (int nl = 0; nl < NL; ++nl) b[nl] = bw[kc * MAX_NT * 32 + nl * 32];
#pragma unroll
        for (int u = 0; u < MT_GROUP; ++u) {
          const uint4 av = aw[((m0 + u) * MAX_KC + kc) * 32];
#pragma unroll
          for (int nl = 0; nl < NL; ++nl) mma_s8(c[nl][u], av, b[nl]);
        }
      }
    }
#pragma unroll
    for (int nl = 0; nl < NL; ++nl)
#pragma unroll
      for (int u = 0; u < MT_GROUP; ++u) epi(nl, m0 + u, c[nl][u]);
  }
}

// Write v to word `idx` of array `arr` in every CTA of the cluster.
__device__ __forceinline__ void push_all(const uint32_t* arr, int idx, uint32_t v) {
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) st_remote(remote_addr(arr + idx, r), v);
}

// (rA, zB) = mont_mul2((xA, xB), (yA, yB)) for the cluster's ROWS rows: this
// thread's lanes j0 + 4 nl, rows 8*mt + g.  The outputs replace x.  The
// operand y is fetched where it is used, by y(nl, mt, yA, yB), so that no
// array of it is held in registers across the product.  Every thread of
// every CTA of the cluster must call it.  CANON as in rns_mont_mul.cuh; EXT =
// false leaves the tensor-core products out (ll = mid = hh = 0), which only
// the probe of the part linear in k uses.
template <bool F32, bool LEAN, int G, bool CANON = false, bool EXT = true, typename Y>
__device__ __forceinline__ void mont_mul2(const Smem& s, const Dims& d, const Place& p,
                                          const uint32_t* __restrict__ rowc,
                                          uint32_t (&xA)[NL][MT], uint32_t (&xB)[NL][MT],
                                          Y&& y) {
  static_assert(F32 || !LEAN, "the lean fold needs the f32 reduction");
  constexpr int RA_LAYERS = (F32 && !CANON) ? 2 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  // [mt][nl] slot of this thread: v_B (+ t_B), then t_A
  auto VT = [&](int nl, int mt) -> uint32_t& { return vt_slot(s, nl, mt); };

  // sigma = (x_A y_A) (-N^{-1} (M_A/a_i)^{-1}) mod a_i, canonical: its digits
  // are the A operand of the A -> B extension, in every CTA
  {
#pragma unroll
    for (int nl = 0; nl < NL; ++nl) {
      const int j = p.j0 + 4 * nl;
      const uint32_t mA = lane_const(s, p, R_MODSA, nl), muA = lane_const(s, p, R_MUA, nl);
      const uint32_t sig0 = lane_const(s, p, R_SIG0, nl), sig1 = lane_const(s, p, R_SIG1, nl);
      const uint32_t c0 = lane_const(s, p, R_C0, nl), c1 = lane_const(s, p, R_C1, nl);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t yA, yB;
        y(nl, mt, yA, yB);
        uint32_t uA = xA[nl][mt] * yA;
        uint32_t sg =
            red_mu<F32, 3>((uA >> MOD_BITS) * sig1 + (uA & MASK14) * sig0, mA, muA);
        put_digits(s.aS, d, p, mt, nl, j < d.k ? sg : 0u);
        uint32_t uB = xB[nl][mt] * yB;
        VT(nl, mt) = (uB >> MOD_BITS) * c1 + (uB & MASK14) * c0;
      }
    }
  }
  share_digits(s.aS, d, p);
  cluster.sync();  // (1) sigma's digits are in every CTA

  // the Kawamura alpha of the lanes kb..kb+G-1, in this CTA: warp w takes
  // m-tiles w, w + warps, ...; the columns ride T1's n-tiles kb / 4 and
  // kb / 4 + 1 (wta)
  for (int mt = p.w; mt < MT; mt += blockDim.x / 32) {
    int c[2][4] = {};
    if (EXT) {
      const uint2* bw = reinterpret_cast<const uint2*>(s.wta) + p.l;
      const uint4* aw = reinterpret_cast<const uint4*>(s.aS) + mt * MAX_KC * 32 + p.l;
#pragma unroll 2
      for (int kc = 0; kc < d.KC; ++kc) {
        const uint4 av = aw[kc * 32];
        mma_s8(c[0], av, bw[(kc * 2) * 32]);
        mma_s8(c[1], av, bw[(kc * 2 + 1) * 32]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = 4 * (d.kb / 4 + i) + p.t;
      if (j >= d.kb && j < d.kb + G) {
        float af = __fadd_rn(__fadd_rn(__int2float_rn(c[i][0]),
                                       __fmul_rn(__int2float_rn(c[i][1] + c[i][2]), 128.0f)),
                             __fmul_rn(__int2float_rn(c[i][3]), 16384.0f));
        af = __fmul_rn(af, 1.0f / 67108864.0f);  // 2^-26
        float fl = fmaxf(floorf(__fsub_rn(af, 0.0625f)), 0.0f);
        s.alpha[(j - d.kb) * ROWS + mt * 8 + p.g] = (uint32_t)__float2int_rz(fl);
      }
    }
  }

  // A -> B+m_r extension, folded onto v_B at once (the z_B sum is the same
  // uint32 value in either order)
  extend<EXT>(s.wt1, s.aS, d, p, [&](int nl, int mt, const int (&c)[4]) {
    VT(nl, mt) += fold_terms<LEAN>(c[0], c[1] + c[2], c[3], lane_const(s, p, R_C28B, nl),
                                   lane_const(s, p, R_C21B, nl));
  });
  __syncthreads();  // (2) this CTA's alpha is in its shared memory

  // z_B = (s + q_hat N) M_A^{-1} w mod b, all terms in one reduction
  {
#pragma unroll
    for (int nl = 0; nl < NL; ++nl) {
      const int j = p.j0 + 4 * nl;
      const uint32_t mB = lane_const(s, p, R_MODSB, nl), muB = lane_const(s, p, R_MUB, nl);
      const uint32_t cAlpha = lane_const(s, p, R_CALPHA, nl);
      const uint32_t* al = s.alpha + lane_const(s, p, R_GIDB, nl) * ROWS + p.g;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t z = red_mu<F32, 3>(VT(nl, mt) + al[mt * 8] * cAlpha, mB, muB);
        xB[nl][mt] = z;
        put_digits(s.aZ, d, p, mt, nl, j < d.k ? z : 0u);
      }
    }
  }
  share_digits(s.aZ, d, p);
  cluster.sync();  // (3) z_B's digits are in every CTA

  // exact Shenoy extension back to base A; lanes k..k+G-1 are the redundant
  // residues (M_B^{-1}-scaled), whose z this thread holds itself (B lane j):
  // their alpha' goes to every CTA
  extend<EXT>(s.wt2, s.aZ, d, p, [&](int nl, int mt, const int (&c)[4]) {
    const int j = p.j0 + 4 * nl;
    const uint32_t tA = fold_terms<LEAN>(c[0], c[1] + c[2], c[3],
                                         lane_const(s, p, R_C28A, nl),
                                         lane_const(s, p, R_C21A, nl));
    VT(nl, mt) = tA;
    if (j >= d.k && j < d.k + G) {
      const int gg = j - d.k;
      push_all(s.alpha2, gg * ROWS + mt * 8 + p.g,
               red_mu<F32, 3>(tA + __ldg(&rowc[R_TWOMR * d.W + gg]) - xB[nl][mt],
                              __ldg(&rowc[R_MR * d.W + gg]), __ldg(&rowc[R_MUR * d.W + gg])));
    }
  });
  cluster.sync();  // (4) alpha' is in every CTA
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const uint32_t mA = lane_const(s, p, R_MODSA, nl), muA = lane_const(s, p, R_MUA, nl);
    const uint32_t padA = lane_const(s, p, R_PADA, nl), mbA = lane_const(s, p, R_MBMODA, nl);
    const uint32_t* a2 = s.alpha2 + lane_const(s, p, R_GIDA, nl) * ROWS + p.g;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      xA[nl][mt] = red_mu<F32, RA_LAYERS>(VT(nl, mt) + padA - a2[mt * 8] * mbA, mA, muA);
  }
}

// (x * y) mod m on this thread's B lane nl, canonical (the z -> r unscale by
// w^{-1}).
template <bool F32>
__device__ __forceinline__ uint32_t mulmod_b(const Smem& s, const Place& p, int nl,
                                             uint32_t x, uint32_t y) {
  return red_mu<F32, 3>(x * y, lane_const(s, p, R_MODSB, nl), lane_const(s, p, R_MUB, nl));
}

}  // namespace tc
}  // namespace prns
