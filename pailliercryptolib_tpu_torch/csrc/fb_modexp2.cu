// K2 — fixed-base modexp: base^e from exponent bytes through the per-key
// table: per byte one table row and one RNS Montgomery product into the
// accumulator.
//
// Replaces: the JAX package's ops/pallas_rns2.py pallas_fb_modexp2 /
// _fb_modexp2_body, which walks the bytes as a sequential grid axis and
// gathers the table row with a one-hot [rows x 256] int8 matrix product,
// which reads the whole table slice of a step whatever the byte.
//
// On this card: the byte walk is a loop inside the block that owns its batch
// rows (accumulator in registers).  The bytes are those of the DJN obfuscator
// exponent r: whoever learns hs^r learns m from the ciphertext, so the gather
// must not read the table at an address that takes a byte.  The kernel
// (below) gathers by the reference's one-hot product on the int8
// tensor cores: per step, onehot [rows x 256] . planes [256 x lanes] over the
// 7-bit digit planes of the step's table slice, which every CTA reads whole
// for its lanes, whatever the bytes.  Bound by integer issue (NP - 1
// Montgomery products per row); the one-hot product adds 2 x 256 x 2 planes
// int8 operations a (row, lane) and step, and its planes, 1024 x W bytes a
// step, are served by L2.
//
// Compiled for every form of a one-system constant set (rns_mont_mul.cuh).
// For a 4096-bit key (randbits 2048, k = 637) the planes are 256 positions x
// 2 sides x 2 planes x 256 entries x 640 lanes = 168 MB (the indexed table of
// int32 words was 334 MB): they live in device memory, and a step's slice
// (656 KB) is what L2 serves.
//
// mont_out = 1 leaves the accumulator in Montgomery form (<= 3N) and only
// unscales the B lanes; mont_out = 0 multiplies by plain 1 first (<= 2N).
//
// fb_modexp2_tc_kernel runs the walk on the tensor-core product of
// rns_mont_mul_tc.cuh on every one-system set of up to 640 lanes: the narrow
// layout up to 320 (n^2 of keys up to 2048 bits: a cluster of four CTAs
// shares 72 rows, the extension weights in its shared memory for the whole
// launch), the wide one beyond (n^2 of 3072- and 4096-bit keys, 480 lanes
// padded to 512, and 640: a cluster of eight, 72 rows, the ~1.6 MB of weight
// fragments read from L2 once an extension, all nine m-tiles in flight).
//
// Thread (g, t) of warp w owns lanes j0 + 4 nl (nl < NL) and rows g + 8 mt of
// its cluster's 72.  One kernel template for two layouts, launched with its
// cluster size as a launch attribute: LAYOUT 0, narrow in one half (Narrow1:
// sets of up to 320 lanes, a cluster of four, the extension weights in its
// shared memory; the one-hot gather below pairs m-tiles across all 72 rows
// and holds 2 NL accumulators a pair, so K2 keeps the layout K3 and K5 had
// before they split their rows in two halves), 1, wide (up to 640, a cluster
// of eight, the weights read from L2 once an extension).
//
// The operand of step i (the table entry the row's byte selects) is the
// one-hot product of the JAX package's gather (pallas_rns2 _fb_modexp2_body:
// onehot [rows, 256] . planes [256, lanes] over 7-bit digit planes,
// lo + (hi << 7)), on the int8 tensor cores (mma.sync m16n8k32 s8): every
// byte of the step's table slice that a CTA's lanes own is read, whatever
// the bytes.  The A operand is the one-hot of two m-tiles' rows (tile rows g
// and g + 8 are the thread's rows 8 mt + g and 8 (mt + 1) + g), built in
// registers by comparisons; the B operand is the planes, laid out as its
// fragments (ops/cuda_rns2.fb_gather_table): tab[NP][2 sides][8 chunks of 32
// entries][W / 4 n-tiles][32][2] words, tile column 2t / 2t + 1 the lo / hi
// plane of lane 4 nt + t.  So the accumulator of thread (g, t) holds lo and
// hi of its own (row, lane) for both m-tiles: the entry is lo + (hi << 7),
// exact (one nonzero term, both planes below 2^7 because K1's residues are
// canonical, below 2^14).  It is staged in the product's vt slot
// (A | B << 16), which the product reads first; step i + 1's gather waits for
// step i's product, which uses vt for its own values.

#include <type_traits>

#include "rns_mont_mul_tc.cuh"

namespace prns {
namespace k2 {

namespace cg = cooperative_groups;

constexpr int FB_TABLE = 256;
constexpr int FB_CHUNKS = FB_TABLE / 32;  // contraction chunks of the one-hot product
// m-tile pairs whose one-hot products are in flight at once (their
// accumulators: 2 sides x NL lanes x 4 words each)
constexpr int MP_GROUP = 3;

template <int LAYOUT>
using FbLayout = typename std::conditional<LAYOUT == 1, tc::Wide, tc::Narrow1>::type;

template <int LAYOUT, bool F32, bool LEAN>
__global__ void __launch_bounds__(FbLayout<LAYOUT>::MAX_THREADS, 1)
fb_modexp2_tc_kernel(const int* __restrict__ tab, const uint8_t* __restrict__ wins,
                     const uint32_t* __restrict__ rowc, const uint32_t* __restrict__ T1,
                     const uint32_t* __restrict__ T2, const uint32_t* __restrict__ T1a,
                     int* __restrict__ out, int B, int NP,
                     int mont_out, tc::Dims d) {
  using TcL = FbLayout<LAYOUT>;
  const tc::Smem<TcL> s = tc::carve<TcL>(d, T1, T2);
  tc::Place<TcL> p = tc::place<TcL>(d, cg::this_cluster().block_rank());
  tc::load_chip_state(s, d, p, rowc, T1, T2, T1a);
  constexpr int MT = TcL::MT, NL = TcL::NL;
  constexpr int MP = (MT + 1) / 2;  // m-tile pairs (the last one's upper tile absent for odd MT)
  const int row0 = (blockIdx.x / TcL::CLUSTER) * TcL::ROWS + p.g;  // + 8 mt
  const int Wt = d.k + d.kb;
  uint32_t accA[NL][MT], accB[NL][MT];

  // step i's entries of this thread's (lane, row) slots into vt, by the
  // one-hot product
  auto onehot_gather = [&](int i) {
    // this thread's rows' bytes as one-hot rows of 256: byte b is word b >> 2,
    // byte b & 3 of the row; thread column t holds words 4 (2 kc + h) + t of
    // chunk kc, half h.  hot: that word if it is this column's, else 0; pos:
    // 2 kc + h of the word (never matched for an absent m-tile).
    uint32_t pos[2 * MP], hot[2 * MP];
#pragma unroll
    for (int mt = 0; mt < 2 * MP; ++mt) {
      const int row = row0 + 8 * mt;
      const uint32_t b = mt < MT && row < B ? (uint32_t)__ldg(&wins[(size_t)row * NP + i]) : 0u;
      hot[mt] = (1u << (8 * (b & 3u))) & (0u - (uint32_t)(((b >> 2) & 3u) == (uint32_t)p.t));
      pos[mt] = mt < MT ? b >> 4 : 0xFFu;
    }
    // B fragments of step i: [2 sides][FB_CHUNKS][W / 4][32] uint2, this
    // thread's n-tile (j0 >> 2) + nl
    const int NTg = d.W / 4;
    const uint2* bp = reinterpret_cast<const uint2*>(tab) +
                      (size_t)i * 2 * FB_CHUNKS * NTg * 32 + (p.j0 >> 2) * 32 + p.l;
#pragma unroll
    for (int m0 = 0; m0 < MP; m0 += MP_GROUP) {
      int c[MP_GROUP][NL][2][4];
#pragma unroll
      for (int u = 0; u < MP_GROUP; ++u)
#pragma unroll
        for (int nl = 0; nl < NL; ++nl)
#pragma unroll
          for (int sd = 0; sd < 2; ++sd)
#pragma unroll
            for (int q = 0; q < 4; ++q) c[u][nl][sd][q] = 0;
#pragma unroll 1
      for (int kc = 0; kc < FB_CHUNKS; ++kc) {
        uint2 bf[NL][2];
#pragma unroll
        for (int nl = 0; nl < NL; ++nl)
#pragma unroll
          for (int sd = 0; sd < 2; ++sd)
            bf[nl][sd] = __ldg(&bp[((sd * FB_CHUNKS + kc) * NTg + nl) * 32]);
        const uint32_t h0 = 2 * kc, h1 = 2 * kc + 1;
#pragma unroll
        for (int u = 0; u < MP_GROUP; ++u) {
          const int mp = m0 + u;
          if (mp < MP) {
            // A fragment: register r holds tile row g + 8 (r & 1), entries
            // 32 kc + 16 (r >> 1) + 4 t .. + 3
            const int lo = 2 * mp, hi = 2 * mp + 1;
            uint4 a;
            a.x = hot[lo] & (0u - (uint32_t)(pos[lo] == h0));
            a.y = hot[hi] & (0u - (uint32_t)(pos[hi] == h0));
            a.z = hot[lo] & (0u - (uint32_t)(pos[lo] == h1));
            a.w = hot[hi] & (0u - (uint32_t)(pos[hi] == h1));
#pragma unroll
            for (int nl = 0; nl < NL; ++nl)
#pragma unroll
              for (int sd = 0; sd < 2; ++sd) tc::mma_s8(c[u][nl][sd], a, bf[nl][sd]);
          }
        }
      }
      // c[u][nl][side] = {lo, hi of m-tile 2 mp, lo, hi of m-tile 2 mp + 1}
#pragma unroll
      for (int u = 0; u < MP_GROUP; ++u)
#pragma unroll
        for (int nl = 0; nl < NL; ++nl)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int mt = 2 * (m0 + u) + h;
            if (m0 + u < MP && mt < MT) {
              const uint32_t ya = (uint32_t)c[u][nl][0][2 * h] +
                                  ((uint32_t)c[u][nl][0][2 * h + 1] << DIGIT_BITS);
              const uint32_t yb = (uint32_t)c[u][nl][1][2 * h] +
                                  ((uint32_t)c[u][nl][1][2 * h + 1] << DIGIT_BITS);
              tc::vt_slot(s, p, nl, mt) = ya | (yb << 16);
            }
          }
    }
  };
  const int nsteps = mont_out ? NP : NP + 1;
  onehot_gather(0);
#pragma unroll
  for (int nl = 0; nl < NL; ++nl)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t v = tc::vt_slot(s, p, nl, mt);
      accA[nl][mt] = v & 0xFFFFu;
      accB[nl][mt] = v >> 16;
    }
  for (int i = 1; i < nsteps; ++i) {
    if (i < NP) {
      onehot_gather(i);
    } else {  // leave the Montgomery domain: multiply by (1, w)
#pragma unroll
      for (int nl = 0; nl < NL; ++nl)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::vt_slot(s, p, nl, mt) = 1u | (tc::lane_const(s, p, R_PONEB, nl) << 16);
    }
    tc::mont_mul2<F32, LEAN, 1>(s, d, p, rowc, accA, accB,
                                [&](int nl, int mt, uint32_t& ya, uint32_t& yb) {
                                  const uint32_t v = tc::vt_slot(s, p, nl, mt);
                                  ya = v & 0xFFFFu;
                                  yb = v >> 16;
                                });
  }
#pragma unroll
  for (int nl = 0; nl < NL; ++nl) {
    const int j = p.j0 + 4 * nl;
    const uint32_t winv = tc::lane_const(s, p, R_WINV, nl);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int row = row0 + 8 * mt;
      if (row < B) {
        if (j < d.k) out[(size_t)row * Wt + j] = (int)accA[nl][mt];
        if (j < d.kb)
          out[(size_t)row * Wt + d.k + j] = (int)tc::mulmod_b<F32>(s, p, nl, accB[nl][mt], winv);
      }
    }
  }
}

// The layout a set takes: narrow, else wide, else -1.
inline int fb_tc_layout(const tc::Dims& d) {
  if (tc::dims_fit<tc::Narrow1>(d, 1)) return 0;
  if (tc::dims_fit<tc::Wide>(d, 1)) return 1;
  return -1;
}

}  // namespace k2
}  // namespace prns

using namespace prns;
using namespace prns::k2;

// tab: the planes (see the head of this file); T1, T2:
// [CLUSTER][KC][W/(4 CLUSTER)][32][2] words of B fragments, T1a:
// [KC][2][32][2], T1's alpha columns (ops/cuda_rns2._tc_pack).
extern "C" int fb_modexp2_tc_launch(const void* tab, const void* wins, const void* rowc,
                                    const void* T1, const void* T2, const void* T1a, void* out,
                                    int B, int NP, int mont_out, int k, int kb, int W, int f32,
                                    int lean, void* stream) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = fb_tc_layout(d);
  if (layout < 0 || B <= 0) return (int)cudaErrorInvalidValue;
#define PRNS_LAUNCH_L(LY, F, LN)                                                          \
  do {                                                                                    \
    using TL = FbLayout<LY>;                                                              \
    cudaError_t err = tc::launch_clusters<TL>(                                            \
        fb_modexp2_tc_kernel<LY, F, LN>, (B + TL::ROWS - 1) / TL::ROWS, d,                \
        (cudaStream_t)stream, (const int*)tab, (const uint8_t*)wins, (const uint32_t*)rowc, \
        (const uint32_t*)T1, (const uint32_t*)T2, (const uint32_t*)T1a, (int*)out, B, NP,   \
        mont_out, d);                                                                     \
    if (err != cudaSuccess) return (int)err;                                              \
  } while (0)
#define PRNS_LAUNCH(F, LN)                  \
  do {                                      \
    if (layout == 1) PRNS_LAUNCH_L(1, F, LN); \
    else PRNS_LAUNCH_L(0, F, LN);           \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_LAUNCH);
#undef PRNS_LAUNCH
#undef PRNS_LAUNCH_L
  return 0;
}

// How many clusters of K2 (the layout and form of the set) the card holds at
// once; -1 if none is compiled for it.
extern "C" int fb_modexp2_tc_max_clusters(int k, int kb, int W, int f32, int lean) {
  tc::Dims d{k, kb, W, (k + 31) / 32};
  const int layout = fb_tc_layout(d);
  if (layout < 0 || (lean && !f32)) return -1;
  int n = -1;
#define PRNS_QUERY(F, LN)                                                                      \
  do {                                                                                         \
    n = layout == 1 ? tc::max_active_clusters<FbLayout<1>>(fb_modexp2_tc_kernel<1, F, LN>, d)  \
                    : tc::max_active_clusters<FbLayout<0>>(fb_modexp2_tc_kernel<0, F, LN>, d); \
  } while (0)
  PRNS_DISPATCH_FORM(f32, lean, PRNS_QUERY);
#undef PRNS_QUERY
  return n;
}
