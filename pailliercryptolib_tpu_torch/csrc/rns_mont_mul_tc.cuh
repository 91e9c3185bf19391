// Tensor-core form of the RNS Montgomery product for Hopper (sm_90a): the
// device function of the CRT-folded modexp (K3), and of the fixed-base table
// build (K1), the fixed-base modexp (K2) and the generic modexp (K5) on sets
// of up to 640 lanes.
//
// Replaces: the JAX package's ops/pallas_rns2.py _make_mont_mul2 / _mm_terms /
// _mm8, which run the base extensions on the TPU's matrix unit.
//
// What it computes: the Bajard-Imbert product x*y*M_A^{-1} mod N on (A-side,
// scaled-B-side) residue pairs, three fused reductions (sigma, z_B, r_A), two
// base extensions, integer for integer the plain version's
// (ops/cuda_rns2.mont_mul2_plain).  The plane sums ll / mid / hh are the same
// integers in any order (int32 sums of at most 2 * 640 * 127^2 ~ 2.1e7), and
// the Kawamura alpha estimate adds its three float terms in the plain
// version's order with round-to-nearest intrinsics (no FMA contraction), so
// the results are bit-equal to it.
//
// What bounds it on this card.  A base extension is a [rows, k] x [k, ~k]
// product of 7-bit digit planes; on the CUDA cores (`dp4a`, the port's first
// form, removed: PERF.md has its times) it sat at the issue ceiling, and
// every block of 8 rows re-read ~384 KB of weights from L2 per product.
// Here:
//   * one int8 tensor-core product per extension: mma.sync m16n8k32
//     (s8 x s8 -> s32).  M stacks a row's low digits (tile row g) over its
//     high digits (row g + 8); N interleaves each lane's Tlo (column 2t) and
//     Thi (column 2t + 1) weights; K is the contraction padded to a multiple
//     of 32.  The accumulator fragment of thread (g, t) then holds ll,
//     lo*Thi, hi*Tlo and hh of ONE (row, lane): the epilogues run on it in
//     registers, and that thread is the owner of the (row, lane) for the
//     whole launch.
//   * the weights stay on chip: the lane axis is split over a cluster of
//     CLUSTER CTAs (2, 4 or 8: the layouts below), each of which loads its
//     share of T1 and T2 (~100 KB as fragment-ordered int8 planes for a
//     2048-bit key) into shared memory once per launch — but for the widest
//     sets, whose CTAs read theirs from L2.  The digits every CTA needs for
//     the full contraction are written as bytes into the CTA's own
//     fragments, then the words its lanes filled are copied into the other
//     CTAs' shared memory (distributed shared memory, 16-byte stores where a
//     fragment's halves belong to one CTA); so are the group-scoped alpha'
//     values, which only the CTA owning the trailing G columns of T2
//     computes (it alone holds the z_B of the redundant lanes).  The Kawamura alpha needs only sigma's digits, which every CTA
//     holds: every CTA computes it from its own copy of T1's alpha columns.
//   * three exchanges a product, the dependency chain's own: sigma ->
//     (1) extension 1, alpha -> z_B -> (3) extension 2 -> alpha' -> (4) r_A;
//     CTA barriers order the rest (each digit copy waits for its CTA's bytes;
//     alpha is this CTA's own).  Digits of sigma and of z_B have buffers of
//     their own.  In a layout of one half each exchange ends at a cluster
//     barrier, which also keeps every buffer from being overwritten before
//     its readers are done; in a layout of two halves, at mbarriers (below).
//   * the extensions read the digit fragments from shared memory, which is
//     what limits them: a warp owns NL n-tiles (4 NL lanes), so each A
//     fragment it reads feeds NL products (2 in a layout of one half, 4 in
//     one of two).
// The tiling is a compile-time Layout<CLUSTER, MT, MAX_W, MT_GROUP, WT_SMEM,
// HALVES>; four are named here (and K1 takes two of its own, of fewer m-tiles,
// for a chain of dependent products over few rows: csrc/fb_table2.cu):
//   Narrow = <4, 9, 320, 2, weights in shared memory, two halves>  K3, and K5
//     on sets of up to 320 lanes.  A cluster owns ROWS = 72 batch rows (MT = 9
//     m-tiles), in two halves that run the product out of step: half 0 the
//     m-tiles 0-4 (rows 0-39), half 1 the m-tiles 5-8 (rows 40-71), each on
//     five warps of every CTA.  Warp v of a half owns n-tiles 4v .. 4v + 3 for
//     the half's rows: thread (g, t) the lanes 16v + 4 nl + t (nl < 4) of its
//     CTA's quarter, rows 8 mt + g.  So a CTA runs W threads (320 for W = 320:
//     up to 168 registers a thread, ten warps over the SM's four register
//     files), a thread holds 20 (row, lane) elements (16 in half 1), and 2048
//     rows are 29 clusters = 116 CTAs.  The H100 holds 30 such clusters at
//     once (one CTA a SM by shared memory, four SMs of one GPC a cluster); 64
//     rows a cluster took 32 clusters, and the last two ran as a second wave.
//     Its extensions keep two of a half's m-tiles in flight (MT_GROUP = 2):
//     each A fragment read feeds four products, each B fragment two.  (All
//     five, whose B fragments would feed five, hold 80 accumulators and
//     spill.)
//   Narrow1 = <4, 9, 320, 3, weights in shared memory, one half>  K2 (and
//     P5's one-half form, probes.cu): the same cluster and rows, all ten
//     warps of a CTA on all 72 rows, warp w the n-tiles 2w, 2w + 1.
//   Wide = <8, 9, 640, 9, weights in device memory>  K2 and K5 on the n^2
//     sets of 3072- and 4096-bit keys (480 lanes, padded to 512, and 640).  T1 + T2
//     of a 640-lane set are ~1.6 MB of fragments, more than a cluster's
//     shared memory holds beside the A fragments.  They stay in device memory
//     (the 50 MB L2 holds them) and each warp loads its B fragments where it
//     uses them, one chunk ahead; the A fragments of 72 rows (184 KB at 20
//     chunks) fill the shared memory of each CTA of a cluster of eight (80
//     lanes, 320 threads, the narrow layout's thread shape).  All nine
//     m-tiles are in flight at once (MT_GROUP = MT), so a CTA reads its
//     share of the weights from L2 once an extension, ~48 MB a product
//     across the card; their 72 accumulators take the registers that z_B
//     held across the second extension, and z_B waits in the vt slot
//     instead.  The H100 holds 15 clusters of eight at once: batch 2048 is
//     29 clusters in two waves.  (A cluster of 16 with the weights in shared
//     memory, 100 KB and 40 lanes a CTA, 40 rows a cluster, 7 clusters at
//     once, was measured slower than the port's first, CUDA-core form;
//     PERF.md has the numbers.)
//   Small = <2, 9, 160, 3, weights in shared memory>  K5 on sets of up to 160
//     lanes (the p^2 / q^2 pair of a 2048-bit key's grouped CRT decrypt, n^2
//     of keys up to 1024 bits): the narrow layout's shared memory is laid out
//     for 320 lanes and holds one CTA a SM whatever the set, so a 160-lane set
//     there runs 160 threads a SM and, two groups at batch 2048, two waves.
//     A cluster of two CTAs of 80 lanes (320 threads, 132 KB) keeps both
//     groups in one wave.
// Everything else is the same code for all of them.
//
// Two halves out of step (HALVES = 2).  With one half, all warps of an SM are
// in the same phase of the product at once, and every exchange waits for the
// slowest CTA of the cluster.  The rows of a cluster are independent (every
// row has its own chain of products), so the narrow layout gives each half
// its own rows and its own synchronisation; the halves run free of each
// other, and one half's extensions may run beside the other half's
// reductions, pushes and waits.  (Both phases lean on shared memory: the
// extensions read their fragments from it near its bandwidth, the reductions
// their lane constants and vt slots.  So the overlap gains little; a turn
// order that kept the halves' extensions strictly apart gained nothing on
// K3 / K5.)
//   * inside a CTA, a named barrier a half (bar.sync 1 + half, its threads)
//     takes the place of __syncthreads;
//   * across the cluster, an mbarrier in shared memory for each (half,
//     buffer: sigma's digits, z_B's digits, alpha') takes the place of a
//     cluster barrier.  The receiving half arms it (mbarrier.arrive.expect_tx)
//     for the bytes the other CTAs push into that buffer a product; each
//     sender pushes its words by st.async...mbarrier::complete_tx::bytes to
//     the receiver's barrier, and a CTA that owns no lane of the contraction
//     (and so pushes no digit) arrives on it instead, once a product (the
//     barrier counts one arrival more for each such CTA).  Every thread of
//     the half waits on the barrier's phase, which flips once a product; one
//     thread arms the next phase once this one is complete.  alpha' reaches
//     the CTA that computes it by a plain store and the half's barrier, so a
//     CTA that owns every redundant lane neither arms nor waits for it.
//   * a buffer is never overwritten before its reader is done with it, and no
//     push of product i + 1 lands in a phase of product i, by the data's own
//     order.  Every CTA signals every other one once a product for sigma's
//     digits and once for z_B's (bytes or an arrival), after the half's
//     barrier that follows its own last read of the buffer before:
//       - S pushes sigma(i + 1) into R after its r_A(i), so after its
//         extension 2 of product i, which needed R's z_B(i) signal; R gives
//         that after it has waited for sigma(i) and read it (alpha,
//         extension 1);
//       - S pushes z_B(i + 1) after its extension 1 of product i + 1, which
//         needed R's sigma(i + 1) signal; R gives that after its r_A(i), so
//         after it has waited for z_B(i) and read it (extension 2);
//       - the owner O of a redundant lane pushes alpha'(i + 1) after its
//         extension 2 of product i + 1, which needed R's z_B(i + 1) signal;
//         R gives that after its r_A(i), which waited for alpha'(i) and read
//         it.  In O itself its own threads' program order and the half's
//         barriers order the two.
//     alpha is a CTA's own, written after the sigma wait and read after the
//     half's barrier that follows extension 1.
//   * one cluster barrier after the barriers are initialised (with the
//     weights, load_chip_state) and one before exit (finish), so that no CTA
//     leaves while another may still write into its shared memory.
//
// Shared memory of a CTA (dynamic, in 32-bit words), laid out for the widest
// set of its layout (MAX_KC = MAX_W / 32 chunks of 32 in the contraction,
// MAX_NT = MAX_W / (4 CLUSTER) n-tiles and MAX_W / CLUSTER lanes a CTA,
// MAX_THREADS = 4 MAX_W / CLUSTER) whatever the set, so that every address is
// a constant offset and no register holds a pointer into it:
//   aS, aZ    [MT][MAX_KC][32 threads][4]  A fragments: digits of sigma / z_B
//   wt1, wt2  [MAX_KC][MAX_NT][32][2]      B fragments of T1 / T2 (this CTA's lanes)
//   alpha, alpha2  [2][ROWS]               group-scoped alpha / alpha'
//   lc        [NROWS][MAX_W / CLUSTER]     per-lane constants (rowc), this CTA's lanes
//   vt        [MT][NL][MAX_THREADS / HALVES]  each thread's v_B (+ t_B), later
//                                          its t_A, kept out of registers across
//                                          the extensions (a half's m-tiles and
//                                          threads)
//   wta       [MAX_KC][2][32][2]           B fragments of T1's n-tiles kb / 4 and
//                                          kb / 4 + 1: the alpha columns
//   mbar      [HALVES][3] x 64 bits        the exchanges' mbarriers (two halves)
// (wt1 / wt2 only where the weights stay in shared memory.)  Narrow: 232,240
// bytes (Narrow1 232,192), Wide: 227,072, of the 232,448 a CTA may have,
// Small: 132,352: one CTA a SM.

#pragma once
#include <cooperative_groups.h>

#include "rns_mont_mul.cuh"

namespace prns {
namespace tc {

namespace cg = cooperative_groups;

// The tiling, fixed at compile time (see the head of this file).
template <int CLUSTER_, int MT_, int MAX_W_, int MT_GROUP_, bool WT_SMEM_ = true,
          int HALVES_ = 1>
struct Layout {
  static constexpr int CLUSTER = CLUSTER_;     // CTAs a cluster: each owns W / CLUSTER lanes
  static constexpr int MT = MT_;               // m16 tiles: 8 batch rows each
  static constexpr int ROWS = 8 * MT;          // batch rows a cluster
  static constexpr int HALVES = HALVES_;       // row sets that run the product out of step
  static constexpr int MTH = (MT + HALVES - 1) / HALVES;  // m-tiles of half 0 (a thread's most)
  static constexpr int NL = 2 * HALVES;        // n-tiles a warp = lanes a thread
  static constexpr int MAX_W = MAX_W_;         // widest constant set
  static constexpr int MAX_THREADS = 4 * MAX_W / CLUSTER;  // W / (4 * CLUSTER * NL) warps a half
  static constexpr int HALF_THREADS = MAX_THREADS / HALVES;
  static constexpr int MAX_KC = MAX_W / 32;    // contraction chunks of 32
  static constexpr int MT_GROUP = MT_GROUP_;   // m-tiles whose products are in flight at once
  // the weight fragments in shared memory for the whole launch, or read from
  // device memory (L2) where they are used
  static constexpr bool WT_SMEM = WT_SMEM_;
  static constexpr int MAX_NT = MAX_W / (4 * CLUSTER);
  static constexpr int WT_WORDS = WT_SMEM ? MAX_KC * MAX_NT * 64 : 0;
  static constexpr int LC_STRIDE = MAX_W / CLUSTER;
  static constexpr int OFF_AS = 0;
  static constexpr int OFF_AZ = OFF_AS + MT * MAX_KC * 128;
  static constexpr int OFF_WT1 = OFF_AZ + MT * MAX_KC * 128;
  static constexpr int OFF_WT2 = OFF_WT1 + WT_WORDS;
  static constexpr int OFF_ALPHA = OFF_WT2 + WT_WORDS;
  static constexpr int OFF_ALPHA2 = OFF_ALPHA + 2 * ROWS;
  static constexpr int OFF_LC = OFF_ALPHA2 + 2 * ROWS;
  static constexpr int OFF_VT = OFF_LC + NROWS * LC_STRIDE;
  static constexpr int OFF_WTA = OFF_VT + MT * NL * HALF_THREADS;
  static constexpr int OFF_MBAR = OFF_WTA + MAX_KC * 2 * 64;
  static constexpr int MBAR_WORDS = HALVES > 1 ? 2 * 3 * HALVES : 0;
  static constexpr int SMEM_BYTES = 4 * (OFF_MBAR + MBAR_WORDS);
  static_assert(HALVES > 1 || MT % MT_GROUP == 0, "m-tiles come in groups of MT_GROUP");
  static_assert(HALVES == 1 || (HALVES == 2 && MT_GROUP <= MTH), "two halves at most");
  static_assert(WT_SMEM || MT_GROUP == MT, "weights from device memory: read once");
  static_assert(WT_SMEM || HALVES == 1, "weights from device memory: one half");
  static_assert(MAX_W % (4 * CLUSTER * NL) == 0, "whole warps a half");
  static_assert(OFF_MBAR % 2 == 0, "mbarriers on 8 bytes");
  static_assert(SMEM_BYTES <= 232448, "a CTA's shared memory on sm_90");
};

using Narrow = Layout<4, 9, 320, 2, true, 2>;
using Narrow1 = Layout<4, 9, 320, 3>;
using Wide = Layout<8, 9, 640, 9, false>;
using Small = Layout<2, 9, 160, 3>;

struct Dims {
  int k;    // A lanes (both groups when folded) = contraction length
  int kb;   // B lanes including the G redundant lanes
  int W;    // lanes of the constant set (rowc row stride)
  int KC;   // ceil(k / 32)
};

template <class L>
__host__ __device__ inline int n_tiles(const Dims& d) { return d.W / (4 * L::CLUSTER); }
template <class L>
__host__ __device__ inline int lanes_per_cta(const Dims& d) { return d.W / L::CLUSTER; }
template <class L>
__host__ __device__ inline int threads(const Dims& d) { return 4 * lanes_per_cta<L>(d); }
// words of one weight array (T1 or T2) of one CTA in global memory
template <class L>
__host__ __device__ inline int weight_words(const Dims& d) { return d.KC * n_tiles<L>(d) * 64; }
// lanes of the contraction (below 32 KC) that the CTA of rank `rank` owns
template <class L>
__host__ __device__ inline int contraction_lanes(const Dims& d, int rank) {
  const int Wc = lanes_per_cta<L>(d), lo = rank * Wc;
  const int hi = lo + Wc < d.KC * 32 ? lo + Wc : d.KC * 32;
  return hi > lo ? hi - lo : 0;
}
// m-tiles of half h
template <class L>
__host__ __device__ inline int half_mt(int h) {
  return L::MT - h * L::MTH < L::MTH ? L::MT - h * L::MTH : L::MTH;
}

// What the launchers take; anything else is refused before launch.
template <class L>
inline bool dims_fit(const Dims& d, int G) {
  return d.W > 0 && d.W <= L::MAX_W && d.W % (4 * L::CLUSTER * L::NL) == 0 && d.k > 0 &&
         d.KC == (d.k + 31) / 32 && d.KC * 32 <= d.W && d.k + G <= d.W &&
         d.kb + G <= d.W;
}

}  // namespace tc
}  // namespace prns

extern __shared__ __align__(16) uint32_t prns_tc_smem[];

namespace prns {
namespace tc {

template <class L>
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
  uint64_t* mbar;  // [HALVES][3]: sigma's digits, z_B's digits, alpha'
};

// The shared-memory arrays of a CTA; T1 / T2 (this group's, all CTAs') are
// where a layout without the weights in shared memory reads them.
template <class L>
__device__ __forceinline__ Smem<L> carve(const Dims& d, const uint32_t* T1,
                                         const uint32_t* T2) {
  Smem<L> s;
  s.aS = prns_tc_smem + L::OFF_AS;
  s.aZ = prns_tc_smem + L::OFF_AZ;
  if (L::WT_SMEM) {
    s.wt1 = prns_tc_smem + L::OFF_WT1;
    s.wt2 = prns_tc_smem + L::OFF_WT2;
  } else {
    const size_t off = (size_t)cg::this_cluster().block_rank() * weight_words<L>(d);
    s.wt1 = const_cast<uint32_t*>(T1) + off;
    s.wt2 = const_cast<uint32_t*>(T2) + off;
  }
  s.alpha = prns_tc_smem + L::OFF_ALPHA;
  s.alpha2 = prns_tc_smem + L::OFF_ALPHA2;
  s.lc = prns_tc_smem + L::OFF_LC;
  s.vt = prns_tc_smem + L::OFF_VT;
  s.wta = prns_tc_smem + L::OFF_WTA;
  s.mbar = reinterpret_cast<uint64_t*>(prns_tc_smem + L::OFF_MBAR);
  return s;
}

// This thread's place: warp v of half h owns n-tiles NL v .. NL v + NL - 1
// of its CTA's share for the half's m-tiles; lane-in-warp l = 4g + t; its
// lanes are jl0 + 4 nl (nl < NL).  With one half, h = 0 and v is the warp.
template <class L>
struct Place {
  int l, g, t;
  int h;       // half
  int v;       // warp within the half
  int ht;      // thread within the half
  int hn;      // threads of a half
  int jl0;     // first lane within the CTA's share
  int j0;      // first lane of the constant set
  int rank;    // CTA rank in the cluster
  uint32_t phase;  // parity of the exchanges' barrier phase (two halves)
};

template <class L>
__device__ __forceinline__ Place<L> place(const Dims& d, unsigned rank) {
  Place<L> p;
  p.l = threadIdx.x & 31;
  p.g = p.l >> 2;
  p.t = p.l & 3;
  p.hn = blockDim.x / L::HALVES;
  p.h = L::HALVES == 1 ? 0 : (int)threadIdx.x / p.hn;
  p.ht = threadIdx.x - p.h * p.hn;
  p.v = p.ht >> 5;
  p.jl0 = 4 * L::NL * p.v + p.t;
  p.rank = (int)rank;
  p.j0 = p.rank * lanes_per_cta<L>(d) + p.jl0;
  p.phase = 0;
  return p;
}

// First m-tile of this thread's half, its m-tiles, and whether this thread's
// m-tile u (< MTH) exists: the rows of u are 8 (mt0 + u) + g.
template <class L>
__device__ __forceinline__ int mt0(const Place<L>& p) { return L::HALVES == 1 ? 0 : p.h * L::MTH; }
template <class L>
__device__ __forceinline__ int n_mt(const Place<L>& p) {
  return L::HALVES == 1 ? L::MT : half_mt<L>(p.h);
}
template <class L>
__device__ __forceinline__ bool has_mt(const Place<L>& p, int u) {
  return L::HALVES == 1 || u < n_mt(p);
}

// The CTA barrier of this thread's half: __syncthreads with one half, a named
// barrier (1 + half) over the half's threads with two.
template <class L>
__device__ __forceinline__ void half_sync(const Place<L>& p) {
  if constexpr (L::HALVES == 1) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + p.h), "r"(p.hn) : "memory");
  }
}

// The same shared-memory word in the CTA of rank `rank`, as a 32-bit address
// of the cluster's shared window (a 64-bit generic pointer for each of the
// ranks would hold twice the registers).
__device__ __forceinline__ uint32_t remote_addr(const void* local, int rank) {
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

// The mbarriers of a layout of two halves (PTX ISA: mbarrier, st.async).
// Stores into another CTA's shared memory that complete bytes of the
// transaction count of the barrier `bar` in that CTA.
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint32_t lo, uint32_t hi, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
      ::"r"(addr), "r"(lo), "r"(hi), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, const uint4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(const uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// this CTA's arrival that opens a phase, with the bytes it waits for
__device__ __forceinline__ void mbar_arm(const uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// an arrival on the barrier of another CTA (address from remote_addr)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` is complete; the other CTAs' stores that
// completed it are visible after
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

enum Exchange { X_SIGMA = 0, X_Z = 1, X_ALPHA2 = 2 };

// Bytes the other CTAs push into a digit buffer of half h of the CTA of rank
// `rank` a product: 16 a (lane, m-tile) of their contraction lanes (two
// digit bytes of 8 rows), and the arrivals its barrier counts: its own arm
// and one from each other CTA that owns no lane of the contraction.
template <class L>
__host__ __device__ inline int digit_bytes(const Dims& d, int rank, int h) {
  return 16 * half_mt<L>(h) * (d.KC * 32 - contraction_lanes<L>(d, rank));
}
template <class L>
__host__ __device__ inline int digit_arrivals(const Dims& d, int rank) {
  int n = 1;
  for (int r = 0; r < L::CLUSTER; ++r) n += r != rank && contraction_lanes<L>(d, r) == 0;
  return n;
}
// Bytes of alpha' the other CTAs push into half h of rank `rank` a product: 4
// a row of the half for each redundant lane k .. k + G - 1 it does not own.
template <class L>
__host__ __device__ inline int alpha2_bytes(const Dims& d, int G, int rank, int h) {
  const int Wc = lanes_per_cta<L>(d);
  int n = 0;
  for (int j = d.k; j < d.k + G; ++j) n += j / Wc != rank;
  return 32 * half_mt<L>(h) * n;
}

// Once per launch: this CTA's weight fragments and lane constants into shared
// memory, the mbarriers of a layout of two halves initialised and armed for
// the first product (G: redundant lanes of the products to come), then a
// cluster barrier (every CTA of the cluster has started, and its barriers
// exist, before any pushes into its shared memory).
// T1a: [KC][2][32][2] words, the B fragments of T1's n-tiles kb / 4 and kb / 4
// + 1 (whichever CTA owns them), for this CTA's own alpha.
template <int G = 1, class L>
__device__ __forceinline__ void load_chip_state(const Smem<L>& s, const Dims& d,
                                                const Place<L>& p,
                                                const uint32_t* __restrict__ rowc,
                                                const uint32_t* __restrict__ T1,
                                                const uint32_t* __restrict__ T2,
                                                const uint32_t* __restrict__ T1a) {
  // global [KC][NT][32][2] words -> shared [KC][MAX_NT][32][2], as uint4
  const int nt16 = n_tiles<L>(d) * 16, nw4 = weight_words<L>(d) / 4;
  const uint4* g1 = reinterpret_cast<const uint4*>(T1 + (size_t)p.rank * weight_words<L>(d));
  const uint4* g2 = reinterpret_cast<const uint4*>(T2 + (size_t)p.rank * weight_words<L>(d));
  uint4* s1 = reinterpret_cast<uint4*>(s.wt1);
  uint4* s2 = reinterpret_cast<uint4*>(s.wt2);
  for (int i = threadIdx.x; L::WT_SMEM && i < nw4; i += blockDim.x) {
    const int kc = i / nt16, o = kc * L::MAX_NT * 16 + (i - kc * nt16);
    s1[o] = __ldg(&g1[i]);
    s2[o] = __ldg(&g2[i]);
  }
  for (int i = threadIdx.x; i < d.KC * 32; i += blockDim.x)
    reinterpret_cast<uint4*>(s.wta)[i] = __ldg(&reinterpret_cast<const uint4*>(T1a)[i]);
  const int Wc = lanes_per_cta<L>(d);
  for (int i = threadIdx.x; i < NROWS * Wc; i += blockDim.x) {
    int row = i / Wc, jl = i - row * Wc;
    s.lc[row * L::LC_STRIDE + jl] = __ldg(&rowc[row * d.W + p.rank * Wc + jl]);
  }
  if constexpr (L::HALVES > 1) {
    if (threadIdx.x == 0) {
      for (int h = 0; h < L::HALVES; ++h) {
        uint64_t* bar = s.mbar + 3 * h;
        for (int x = X_SIGMA; x <= X_Z; ++x) {
          mbar_init(bar + x, digit_arrivals<L>(d, p.rank));
          mbar_arm(bar + x, digit_bytes<L>(d, p.rank, h));
        }
        mbar_init(bar + X_ALPHA2, 1);
        const int a2 = alpha2_bytes<L>(d, G, p.rank, h);
        if (a2) mbar_arm(bar + X_ALPHA2, a2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  cg::this_cluster().sync();
}

// Before a kernel of a layout of two halves exits: no CTA of the cluster
// leaves while another may still write into its shared memory.
template <class L>
__device__ __forceinline__ void finish(const Place<L>&) {
  if constexpr (L::HALVES > 1) cg::this_cluster().sync();
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
template <class L>
__device__ __forceinline__ void put_digits(uint32_t* buf, const Dims& d, const Place<L>& p,
                                           int mt, int nl, uint32_t v) {
  const int j = p.j0 + 4 * nl;
  if (j < d.KC * 32) {
    const int kc = j >> 5, u = (j & 31) >> 2;
    uint8_t* w = reinterpret_cast<uint8_t*>(buf) +
                 (((mt * L::MAX_KC + kc) * 32 + p.g * 4 + (u & 3)) * 4 + (u >> 2) * 2) * 4 +
                 (j & 3);
    w[0] = (uint8_t)(v & DIGIT_MASK);
    w[4] = (uint8_t)(v >> DIGIT_BITS);
  }
}

// After every thread of the half has put its digits into `buf`: copy the
// fragment words this CTA's lanes filled for the half's m-tiles into the same
// place in the other CTAs of the cluster, 16 bytes a store where both halves
// of a thread's fragment belong to this CTA (lanes q and q + 16 of a chunk),
// else 8.  With two halves the stores complete the bytes of the receiver's
// barrier of exchange x, and a CTA with no lane of the contraction arrives on
// the others' barriers instead.
template <class L>
__device__ __forceinline__ void share_digits(const Smem<L>& s, uint32_t* buf, int x,
                                             const Dims& d, const Place<L>& p) {
  half_sync(p);
  const int Wc = lanes_per_cta<L>(d), lo = p.rank * Wc, hi = lo + Wc;  // this CTA's lanes
  const int kc0 = lo >> 5, nkc = min((hi - 1) >> 5, d.KC - 1) - kc0 + 1;
  const uint64_t* bar = s.mbar + 3 * p.h + x;
  if (nkc <= 0) {
    if (L::HALVES > 1 && p.ht == 0) {
#pragma unroll
      for (int r = 1; r < L::CLUSTER; ++r)
        mbar_arrive_remote(remote_addr(bar, (p.rank + r) % L::CLUSTER));
    }
    return;
  }
  const int items = n_mt(p) * nkc * 32;
  const int first = mt0(p) * L::MAX_KC * 32;
  for (int i = p.ht; i < items; i += p.hn) {
    const int th = i & 31, kc = kc0 + (i >> 5) % nkc, mt = (i >> 5) / nkc;
    const int q = kc * 32 + 4 * (th & 3);  // lanes of the slot's halves: q.., q + 16..
    const bool h0 = q >= lo && q < hi, h1 = q + 16 >= lo && q + 16 < hi;
    uint32_t* src = buf + (first + (mt * L::MAX_KC + kc) * 32 + th) * 4;
    if (h0 && h1) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int r = 1; r < L::CLUSTER; ++r) {
        const int rr = (p.rank + r) % L::CLUSTER;
        if constexpr (L::HALVES == 1) st_remote(remote_addr(src, rr), v);
        else st_async(remote_addr(src, rr), v, remote_addr(bar, rr));
      }
    } else if (h0 || h1) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + (h1 ? 2 : 0));
#pragma unroll
      for (int r = 1; r < L::CLUSTER; ++r) {
        const int rr = (p.rank + r) % L::CLUSTER;
        if constexpr (L::HALVES == 1) st_remote(remote_addr(src + (h1 ? 2 : 0), rr), v.x, v.y);
        else st_async(remote_addr(src + (h1 ? 2 : 0), rr), v.x, v.y, remote_addr(bar, rr));
      }
    }
  }
}

// The end of an exchange: a cluster barrier with one half; with two, every
// thread of the half waits for this product's phase of its barrier of
// exchange x, and one thread arms the next phase for `bytes`.
template <class L>
__device__ __forceinline__ void exchange_wait(const Smem<L>& s, const Place<L>& p, int x,
                                              int bytes) {
  if constexpr (L::HALVES == 1) {
    cg::this_cluster().sync();
  } else {
    const uint64_t* bar = s.mbar + 3 * p.h + x;
    mbar_wait(bar, p.phase);
    if (p.ht == 0) mbar_arm(bar, bytes);
  }
}

// One base extension: for each m-tile u of this thread's half and lane nl,
// epi(nl, u, c) with c the accumulator fragment of (row 8 (mt0 + u) + g, lane
// nl) = {ll, lo*Thi, hi*Tlo, hh}.  Each A fragment read from shared memory
// feeds the warp's NL n-tiles, each B fragment MT_GROUP m-tiles; MT_GROUP
// m-tiles are in flight at a time, and each epilogue folds its fragment away
// at once, so that no more than NL * MT_GROUP accumulators are ever live.
template <bool EXT, int KC_UNROLL, class L, typename Epi>
__device__ __forceinline__ void extend(const uint32_t* wt, const uint32_t* a,
                                       const Dims& d, const Place<L>& p, Epi&& epi) {
  constexpr int NL = L::NL, MT_GROUP = L::MT_GROUP, MTH = L::MTH;
  // n-tiles a chunk of the weights holds: the layout's widest in shared
  // memory, this set's in device memory
  const int nt = L::WT_SMEM ? L::MAX_NT : n_tiles<L>(d);
  const uint2* bw = reinterpret_cast<const uint2*>(wt) + NL * p.v * 32 + p.l;
  const uint4* aw = reinterpret_cast<const uint4*>(a) + mt0(p) * L::MAX_KC * 32 + p.l;
#pragma unroll
  for (int m0 = 0; m0 < MTH; m0 += MT_GROUP) {
    int c[NL][MT_GROUP][4];
#pragma unroll
    for (int nl = 0; nl < NL; ++nl)
#pragma unroll
      for (int u = 0; u < MT_GROUP; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[nl][u][i] = 0;
    if (EXT && L::WT_SMEM) {
      // not unrolled in full: that would let the compiler hoist every chunk's
      // fragment loads into registers
#pragma unroll KC_UNROLL
      for (int kc = 0; kc < d.KC; ++kc) {
        uint2 b[NL];
#pragma unroll
        for (int nl = 0; nl < NL; ++nl) b[nl] = bw[kc * L::MAX_NT * 32 + nl * 32];
#pragma unroll
        for (int u = 0; u < MT_GROUP; ++u) {
          if (m0 + u < MTH && has_mt(p, m0 + u)) {
            const uint4 av = aw[((m0 + u) * L::MAX_KC + kc) * 32];
#pragma unroll
            for (int nl = 0; nl < NL; ++nl) mma_s8(c[nl][u], av, b[nl]);
          }
        }
      }
    } else if (EXT) {
      // weights from device memory: the next chunk's fragments are loaded
      // while this chunk's products run
      uint2 bn[NL];
#pragma unroll
      for (int nl = 0; nl < NL; ++nl) bn[nl] = __ldg(&bw[nl * 32]);
#pragma unroll 2
      for (int kc = 0; kc < d.KC; ++kc) {
        uint2 b[NL];
#pragma unroll
        for (int nl = 0; nl < NL; ++nl) {
          b[nl] = bn[nl];
          if (kc + 1 < d.KC) bn[nl] = __ldg(&bw[(kc + 1) * nt * 32 + nl * 32]);
        }
#pragma unroll
        for (int u = 0; u < MT_GROUP; ++u) {
          const uint4 av = aw[((m0 + u) * L::MAX_KC + kc) * 32];
#pragma unroll
          for (int nl = 0; nl < NL; ++nl) mma_s8(c[nl][u], av, b[nl]);
        }
      }
    }
#pragma unroll
    for (int nl = 0; nl < NL; ++nl)
#pragma unroll
      for (int u = 0; u < MT_GROUP; ++u)
        if (m0 + u < MTH && has_mt(p, m0 + u)) epi(nl, m0 + u, c[nl][u]);
  }
}

// This thread's slot (lane nl, m-tile u of its half) of vt: v_B (+ t_B), then
// t_A inside a product; the kernels may stage a product's operand there
// before it.
template <class L>
__device__ __forceinline__ uint32_t& vt_slot(const Smem<L>& s, const Place<L>& p, int nl, int u) {
  const int base = L::HALVES == 1 ? (int)threadIdx.x
                                  : p.h * L::MTH * L::NL * L::HALF_THREADS + p.ht;
  return s.vt[base + (u * L::NL + nl) * L::HALF_THREADS];
}

// Per-lane constant of row `row` (RowId) for this thread's lane nl.
template <class L>
__device__ __forceinline__ uint32_t lane_const(const Smem<L>& s, const Place<L>& p, int row,
                                               int nl) {
  return s.lc[row * L::LC_STRIDE + p.jl0 + 4 * nl];
}

// alpha' of redundant lane gg and row 8 mt + g into every CTA of the cluster:
// with one half by stores into the cluster's shared window; with two by a
// store of its own and stores that complete bytes of the other CTAs' barrier
// of this half's alpha'.
template <class L>
__device__ __forceinline__ void push_alpha2(const Smem<L>& s, const Place<L>& p, int idx,
                                            uint32_t v) {
  if constexpr (L::HALVES == 1) {
#pragma unroll
    for (int r = 0; r < L::CLUSTER; ++r) st_remote(remote_addr(s.alpha2 + idx, r), v);
  } else {
    s.alpha2[idx] = v;
    const uint64_t* bar = s.mbar + 3 * p.h + X_ALPHA2;
#pragma unroll
    for (int r = 1; r < L::CLUSTER; ++r) {
      const int rr = (p.rank + r) % L::CLUSTER;
      st_async(remote_addr(s.alpha2 + idx, rr), v, remote_addr(bar, rr));
    }
  }
}

// (rA, zB) = mont_mul2((xA, xB), (yA, yB)) for this thread's half of the
// cluster's ROWS rows: lanes j0 + 4 nl, rows 8 (mt0 + u) + g.  The outputs
// replace x.  The operand y is fetched where it is used, by y(nl, u, yA, yB),
// so that no array of it is held in registers across the product.  Every
// thread of every CTA of the cluster must call it.  CANON asks for canonical
// r_A under the f32 flavor too (the fixed-base table build: its entries feed
// 7-bit digit planes); EXT = false leaves the tensor-core products out (ll =
// mid = hh = 0), which only the probe of the part linear in k uses.
template <bool F32, bool LEAN, int G, bool CANON = false, bool EXT = true, class L,
          typename Y>
__device__ __forceinline__ void mont_mul2(const Smem<L>& s, const Dims& d, Place<L>& p,
                                          const uint32_t* __restrict__ rowc,
                                          uint32_t (&xA)[L::NL][L::MTH],
                                          uint32_t (&xB)[L::NL][L::MTH], Y&& y) {
  static_assert(F32 || !LEAN, "the lean fold needs the f32 reduction");
  constexpr int RA_LAYERS = (F32 && !CANON) ? 2 : 3;
  constexpr int NL = L::NL, MTH = L::MTH, ROWS = L::ROWS;
  // the extensions' chunk loop two chunks at a time, but for the folded sets
  // (G = 2) in two halves: their two groups' alpha and alpha' take the
  // registers of the second chunk's fragments (ptxas -v: no spills either way)
  constexpr int KC_UNROLL = L::HALVES > 1 && G > 1 ? 1 : 2;
  const int m0 = mt0(p);
  // [u][nl] slot of this thread: v_B (+ t_B), then t_A
  auto VT = [&](int nl, int u) -> uint32_t& { return vt_slot(s, p, nl, u); };

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
      for (int u = 0; u < MTH; ++u) {
        if (!has_mt(p, u)) continue;
        uint32_t yA, yB;
        y(nl, u, yA, yB);
        uint32_t uA = xA[nl][u] * yA;
        uint32_t sg =
            red_mu<F32, 3>((uA >> MOD_BITS) * sig1 + (uA & MASK14) * sig0, mA, muA);
        put_digits(s.aS, d, p, m0 + u, nl, j < d.k ? sg : 0u);
        uint32_t uB = xB[nl][u] * yB;
        VT(nl, u) = (uB >> MOD_BITS) * c1 + (uB & MASK14) * c0;
      }
    }
  }
  share_digits(s, s.aS, X_SIGMA, d, p);
  // (1) sigma's digits are in every CTA
  exchange_wait(s, p, X_SIGMA, digit_bytes<L>(d, p.rank, p.h));

  // the Kawamura alpha of the lanes kb..kb+G-1, in this CTA: warp v of the
  // half takes the half's m-tiles v, v + warps, ...; the columns ride T1's
  // n-tiles kb / 4 and kb / 4 + 1 (wta)
  for (int u = p.v; u < n_mt(p); u += p.hn / 32) {
    const int mt = m0 + u;
    int c[2][4] = {};
    if (EXT) {
      const uint2* bw = reinterpret_cast<const uint2*>(s.wta) + p.l;
      const uint4* aw = reinterpret_cast<const uint4*>(s.aS) + mt * L::MAX_KC * 32 + p.l;
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
  extend<EXT, KC_UNROLL>(s.wt1, s.aS, d, p, [&](int nl, int u, const int (&c)[4]) {
    VT(nl, u) += fold_terms<LEAN>(c[0], c[1] + c[2], c[3], lane_const(s, p, R_C28B, nl),
                                  lane_const(s, p, R_C21B, nl));
  });
  half_sync(p);  // (2) this CTA's alpha is in its shared memory

  // z_B = (s + q_hat N) M_A^{-1} w mod b, all terms in one reduction
  {
#pragma unroll
    for (int nl = 0; nl < NL; ++nl) {
      const int j = p.j0 + 4 * nl;
      const uint32_t mB = lane_const(s, p, R_MODSB, nl), muB = lane_const(s, p, R_MUB, nl);
      const uint32_t cAlpha = lane_const(s, p, R_CALPHA, nl);
      const uint32_t* al = s.alpha + lane_const(s, p, R_GIDB, nl) * ROWS + p.g;
#pragma unroll
      for (int u = 0; u < MTH; ++u) {
        if (!has_mt(p, u)) continue;
        uint32_t z = red_mu<F32, 3>(VT(nl, u) + al[(m0 + u) * 8] * cAlpha, mB, muB);
        if (L::WT_SMEM) xB[nl][u] = z;
        else VT(nl, u) = z;  // back into registers in extension 2's epilogue
        put_digits(s.aZ, d, p, m0 + u, nl, j < d.k ? z : 0u);
      }
    }
  }
  share_digits(s, s.aZ, X_Z, d, p);
  // (3) z_B's digits are in every CTA
  exchange_wait(s, p, X_Z, digit_bytes<L>(d, p.rank, p.h));

  // exact Shenoy extension back to base A; lanes k..k+G-1 are the redundant
  // residues (M_B^{-1}-scaled), whose z this thread holds itself (B lane j):
  // their alpha' goes to every CTA
  extend<EXT, KC_UNROLL>(s.wt2, s.aZ, d, p, [&](int nl, int u, const int (&c)[4]) {
    const int j = p.j0 + 4 * nl;
    const uint32_t tA = fold_terms<LEAN>(c[0], c[1] + c[2], c[3],
                                         lane_const(s, p, R_C28A, nl),
                                         lane_const(s, p, R_C21A, nl));
    if (!L::WT_SMEM) xB[nl][u] = VT(nl, u);
    VT(nl, u) = tA;
    if (j >= d.k && j < d.k + G) {
      const int gg = j - d.k;
      push_alpha2(s, p, gg * ROWS + (m0 + u) * 8 + p.g,
                  red_mu<F32, 3>(tA + __ldg(&rowc[R_TWOMR * d.W + gg]) - xB[nl][u],
                                 __ldg(&rowc[R_MR * d.W + gg]), __ldg(&rowc[R_MUR * d.W + gg])));
    }
  });
  if constexpr (L::HALVES == 1) {
    cg::this_cluster().sync();  // (4) alpha' is in every CTA
  } else {
    half_sync(p);  // (4) this CTA's own alpha' is in its shared memory, the others' pushed
    const int bytes = alpha2_bytes<L>(d, G, p.rank, p.h);
    if (bytes) exchange_wait(s, p, X_ALPHA2, bytes);
    p.phase ^= 1u;
  }
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const uint32_t mA = lane_const(s, p, R_MODSA, nl), muA = lane_const(s, p, R_MUA, nl);
    const uint32_t padA = lane_const(s, p, R_PADA, nl), mbA = lane_const(s, p, R_MBMODA, nl);
    const uint32_t* a2 = s.alpha2 + lane_const(s, p, R_GIDA, nl) * ROWS + p.g;
#pragma unroll
    for (int u = 0; u < MTH; ++u)
      if (has_mt(p, u))
        xA[nl][u] = red_mu<F32, RA_LAYERS>(VT(nl, u) + padA - a2[(m0 + u) * 8] * mbA, mA, muA);
  }
}

// (x * y) mod m on this thread's B lane nl, canonical (the z -> r unscale by
// w^{-1}).
template <bool F32, class L>
__device__ __forceinline__ uint32_t mulmod_b(const Smem<L>& s, const Place<L>& p, int nl,
                                             uint32_t x, uint32_t y) {
  return red_mu<F32, 3>(x * y, lane_const(s, p, R_MODSB, nl), lane_const(s, p, R_MUB, nl));
}

// Host side, for a kernel of layout L that takes its cluster size at launch:
// the launch configuration of clusters.x clusters (times clusters.y on the
// grid's y axis) with L's dynamic shared memory and its threads for the set
// d, how many of its clusters the card holds at once (-1 on an error), and
// the launch itself.
template <class L, typename Kern>
inline cudaError_t cluster_config(Kern kern, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                                  dim3 clusters, const Dims& d, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  cfg = {};
  cfg.gridDim = dim3(clusters.x * L::CLUSTER, clusters.y, 1);
  cfg.blockDim = dim3(threads<L>(d), 1, 1);
  cfg.dynamicSmemBytes = L::SMEM_BYTES;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = L::CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <class L, typename Kern>
inline int max_active_clusters(Kern kern, const Dims& d) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = -1;
  if (cluster_config<L>(kern, cfg, attr, dim3(32), d, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <class L, typename... KArgs, typename... Args>
inline cudaError_t launch_clusters(void (*kern)(KArgs...), dim3 clusters, const Dims& d,
                                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<L>(kern, cfg, attr, clusters, d, st);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tc
}  // namespace prns
