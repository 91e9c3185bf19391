"""Fused-constant RNS Montgomery kernels for Hopper, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_rns2.py``.  Same
Bajard-Imbert algorithm as ops/rns.py, restructured (as the reference's) so
that one Montgomery product runs exactly three fused reductions and two
deferred-reduction base extensions, with the B-side residues carried
pre-multiplied by w_j = (M_B/b_j)^{-1} mod b_j (the "scaled-B carry").

Four CUDA kernels live here, each beside a plain PyTorch function of the
same signature and the same integer arithmetic:

====================  ========================  =============================
wrapper               plain version             source
====================  ========================  =============================
``fb_table2``         ``fb_table2_plain``       ``csrc/fb_table2.cu``
``fb_modexp2``        ``fb_modexp2_plain``      ``csrc/fb_modexp2.cu``
``rns_modexp2f``      ``rns_modexp2f_plain``    ``csrc/rns_modexp2f.cu``
``rns_modexp2``       ``rns_modexp2_plain``     ``csrc/rns_modexp2.cu``
====================  ========================  =============================

Every one of them runs the tensor-core form of the product
(``csrc/rns_mont_mul_tc.cuh``: int8 ``mma.sync`` base extensions on a
cluster of CTAs, each holding a share of the lanes), in the layouts
:data:`TC_KERNEL_LAYOUTS` names for it (:func:`tc_layout`): K3 in a cluster
of four up to 320 lanes (the extension weights in its shared memory), its 72
rows in two halves that run the product out of step; K2 in that cluster with
its rows in one half, and beyond it, up to 640 lanes, in a cluster of eight
that reads the weights from L2; K5 in the two-half cluster of four, the
cluster of eight and, up to 160 lanes, a cluster of two; K1, a chain of
dependent products over few rows, in layouts of fewer rows a cluster, so that
its rows spread over more of the card.
:data:`KERNEL_FORMS` counts the K3 / K5 launches that ran their rows in two
halves, and :func:`mont_mul2_tc_plain` walks the tensor-core tiling (weight
packing :func:`_tc_pack`, digit fragments, the per-CTA lane split) in plain
PyTorch.

No table select of the library reads at an address that takes a secret:
K2 gathers by the reference's one-hot product on the int8 tensor cores
(:func:`fb_gather_table` packs the table as its B fragments,
:func:`fb_onehot_gather_plain` is the plain version), K3 and K5 read all
16 entries of a row's power table and keep one by masks
(``csrc/ct_select.cuh``).

The plain version of the product is :func:`mont_mul2_plain`, in every form a constant set can
take:
integer-Barrett or f32-reciprocal reduction (``muA``'s dtype; forced to f32
for "wide-pool" sets with a modulus below 2^13, i.e. n^2 of 3072- and
4096-bit keys), the lean fold or the full one (:func:`_is_lean`), up to 640
lanes.  A wrapper takes the plain version only
for CPU tensors; for CUDA tensors it launches its kernel or raises.  Each
wrapper counts its launches in :data:`LAUNCHES`.

Results are integers and bit-equal between kernel and plain version.  Two
spots use float32, both reproduced operation for operation: the Kawamura
alpha estimate and the f32-reciprocal reduction (see :func:`red_mu`).

Constant sets are plain dicts of tensors (``stack_group_consts2`` /
``fold_group_consts2``: numpy in, tensors out, every array equal to the
reference's).  Integer constants are int32 tensors, digit planes int8, the
f32-reciprocal constants float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import trace
from . import _build
from .bigint import dot_exact
from .limbs import WINDOW_BITS
from .rns import (
    ALPHA_MARGIN,
    DIGIT_BITS,
    DIGIT_MASK,
    MOD_BITS,
    inv_f32,
    is_wide_pool,
)

_I64 = torch.int64
_I32 = torch.int32
_F32 = torch.float32
_TABLE = 1 << WINDOW_BITS
_MASK14 = (1 << MOD_BITS) - 1

FB_WINDOW_BITS = 8
FB_TABLE = 1 << FB_WINDOW_BITS

#: Kawamura alpha-column weight scale: floor(2^26 / a_i) — see
#: _per_ctx_consts2 for why 26 and not 27.
ALPHA_W_BITS = 26

#: Launch counts of the CUDA kernels, one per wrapper (a wrapper adds one
#: where it launches its kernel and nowhere else).
LAUNCHES = {"fb_table2": 0, "fb_modexp2": 0, "rns_modexp2f": 0, "rns_modexp2": 0}

#: The launches of ``rns_modexp2`` again, by the form of the kernel that ran:
#: one shared exponent, per-row exponents, or more than one group of constants.
MODEXP2_FORMS = {"shared": 0, "var": 0, "grouped": 0}

#: The launches of K3 and K5 again where their layout runs its rows in two
#: halves out of step (the narrow one, csrc/rns_mont_mul_tc.cuh).
KERNEL_FORMS = {"rns_modexp2f_tc_split": 0, "rns_modexp2_tc_split": 0}

#: Limits of the kernels as compiled (csrc/rns_mont_mul_tc.cuh,
#: rns_modexp2.cu, rns_modexp2f.cu): lanes of a constant set (one
#: residue system over n^2 of a 4096-bit key is 640), input limbs of the
#: generic modexp (the n^2-width ciphertext of a 4096-bit key is 548), and
#: lanes / input limbs of the CRT-folded kernel, whose layout ends at
#: 2048-bit keys.
KERNEL_MAX_THREADS = 640
KERNEL_MAX_LIN = 576
KERNEL_MAX_THREADS_FOLDED = 320
KERNEL_MAX_LIN_FOLDED = 288
#: The tensor-core product (csrc/rns_mont_mul_tc.cuh), its narrow layout (K3
#: and K5 up to 320 lanes; K2 in the same layout in one half): CTAs a cluster
#: (each owns a quarter of the lanes), m16 tiles of 8 rows a cluster, batch
#: rows a cluster, and the widest constant set it takes.
TC_CLUSTER = 4
TC_MT = 9
#: n-tiles (of four lanes) a warp of the tensor-core product owns in a layout
#: of one half; in one of two halves (:data:`TC_LAYOUTS`) a warp owns twice
#: as many for half the rows (:func:`tc_nl`)
TC_NL = 2
TC_ROWS = 8 * TC_MT
TC_MAX_W = 320
#: Its wide layout (K2 and K5 on the n^2 sets of 3072- and 4096-bit keys; the
#: weights read from L2): a cluster of 8 CTAs, 9 m-tiles, sets of up to 640
#: lanes, padded to a multiple of 4 * TC_WIDE_CLUSTER * TC_NL = 64 lanes.
TC_WIDE_CLUSTER = 8
TC_WIDE_MT = 9
TC_WIDE_ROWS = 8 * TC_WIDE_MT
TC_WIDE_MAX_W = 640
#: Its small layout (K5 on sets of up to 160 lanes): a cluster of 2 CTAs, the
#: narrow layout's m-tiles.
TC_SMALL_CLUSTER = 2
TC_SMALL_MAX_W = 160
#: Every compiled layout as (CTAs a cluster, m-tiles a cluster, widest set,
#: halves: row sets that run the product out of step): the three above, the
#: narrow one in one half (csrc/rns_mont_mul_tc.cuh Narrow1: K2's, and P5's
#: one-half form) and K1's two (csrc/fb_table2.cu K1Narrow, K1Wide).
TC_LAYOUTS = {
    "small": (TC_SMALL_CLUSTER, TC_MT, TC_SMALL_MAX_W, 1),
    "narrow": (TC_CLUSTER, TC_MT, TC_MAX_W, 2),
    "narrow1": (TC_CLUSTER, TC_MT, TC_MAX_W, 1),
    "wide": (TC_WIDE_CLUSTER, TC_WIDE_MT, TC_WIDE_MAX_W, 1),
    "k1_narrow": (4, 1, 320, 1),
    "k1_wide": (8, 3, 640, 1),
}
#: The layouts each tensor-core kernel is compiled for, in the order its
#: launcher tries them: a set runs in the first that holds it.  K3
#: (``rns_modexp2f``) takes the CRT-folded sets, the others one-system sets.
TC_KERNEL_LAYOUTS = {
    "fb_table2": ("k1_narrow", "k1_wide"),
    "fb_modexp2": ("narrow1", "wide"),
    "rns_modexp2f": ("narrow",),
    "rns_modexp2": ("small", "narrow", "wide"),
}
#: Longest base-extension contraction for which the lean fold of the
#: f32-reciprocal flavor stays below 2^31 (16129 * 259 * K + 2^28 + 5.4e8).
LEAN_MAX_CONTRACTION = 320


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Constant array -> tensor: unsigned 32-bit values (all < 2^31) become
    int32, int8 and float32 keep their type."""
    a = np.ascontiguousarray(a)
    if a.dtype in (np.uint32, np.uint64):
        if int(a.max(initial=0)) >= (1 << 31):
            raise ValueError("constant does not fit a signed 32-bit word")
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

def _per_ctx_consts2(c, f32_mu=False):
    """v3 fused constants for ONE RNSContext (see stack_group_consts2).

    ``f32_mu`` selects _red_mu's f32-reciprocal flavor for the full-width
    reduction chains (the decrypt kernel's; the fixed-base encrypt kernels keep the
    integer default, as the reference does)."""
    k = c.k
    A = c.mods[:k].astype(np.uint64)
    Bx = c.mods[k:].astype(np.uint64)  # B primes + m_r
    if f32_mu:
        muA = inv_f32(c.mods[:k])
        muBx = inv_f32(c.mods[k:])
    else:
        muA = c.barrett[:k]
        muBx = c.barrett[k:]
    N = c.N
    mr = int(c.mods[-1])
    sig0 = c.sigma_c_A.astype(np.uint64)
    sig1 = (sig0 << MOD_BITS) % A
    # scaled-B carry weights over the Bx lanes
    wvec = np.concatenate(
        [c.MBj_inv_B, np.array([c.MBinv_mr], np.uint32)]
    ).astype(np.uint64)
    winv = np.array(
        [pow(int(w), -1, int(m)) for w, m in zip(wvec, Bx)], np.uint64
    )
    MAinv = c.MAinv_B.astype(np.uint64)  # over Bx
    c0 = (MAinv * winv) % Bx
    c1 = (c0 << MOD_BITS) % Bx
    NMAinvW = (
        np.array([N % int(m) for m in Bx], np.uint64) * MAinv % Bx
    ) * wvec % Bx
    negMA = np.array([(-c.MA) % int(m) for m in Bx], np.uint64)
    cAlpha = (negMA * NMAinvW) % Bx
    # T1p = T1 * (N * MAinv * w) mod m_j   [k, k+1], plus one extra
    # column of Kawamura alpha weights floor(2^26 / a_i): the alpha
    # fraction sum rides the SAME base-extension matmul.  2^26 (not
    # 2^27) keeps the weight < 2^14 for wide pools (a_i down to 2^12),
    # so its 7-bit int8 digit planes stay valid; the coarser
    # quantization error <= k * 2^-12 plus ALPHA_MARGIN still undershoots
    # by at most 1 for k <= ~3800 (both errors are one-sided downward,
    # so the estimate can never overshoot).
    T1p = (c.T1.astype(np.uint64) * NMAinvW[None, :]) % Bx[None, :]
    aw = ((np.uint64(1) << ALPHA_W_BITS) // A).astype(np.uint64)
    T1p = np.concatenate([T1p, aw[:, None]], axis=1)  # [k, k+2]
    # T2 extended with the m_r column scaled by M_B^{-1} mod m_r
    # (folds the alpha2 = diff * MBinv multiply into the weights)
    T2r_s = (c.T2r.astype(np.uint64) * np.uint64(c.MBinv_mr)) % np.uint64(mr)
    T2x = np.concatenate(
        [c.T2.astype(np.uint64), T2r_s[:, None]], axis=1
    )
    # fused Shenoy pad row: 2^14 * a >= alpha2 * (M_B mod a)
    padA = (A << MOD_BITS).astype(np.uint32)
    # modsAr: A-moduli columns + m_r column (T2x reduction targets)
    modsAr = np.concatenate([c.mods[:k], c.mods[-1:]])
    muAr = (
        inv_f32(modsAr)
        if f32_mu
        else np.concatenate([muA, c.barrett[-1:]])
    )

    def planes(T):
        lo = (T & DIGIT_MASK).astype(np.int8)
        hi = (T >> DIGIT_BITS).astype(np.int8)
        return lo, hi

    T1lo, T1hi = planes(T1p.astype(np.uint32))
    T2lo, T2hi = planes(T2x.astype(np.uint32))
    # deferred-reduction plane weights per target column
    c28B = ((np.uint64(1) << 28) % Bx).astype(np.uint32)
    c21B = ((np.uint64(1) << 21) % Bx).astype(np.uint32)
    Ar = modsAr.astype(np.uint64)
    c28A = ((np.uint64(1) << 28) % Ar).astype(np.uint32)
    c21A = ((np.uint64(1) << 21) % Ar).astype(np.uint32)
    return dict(
        modsA=c.mods[:k], muA=muA,
        modsBx=c.mods[k:], muBx=muBx,
        modsAr=modsAr, muAr=muAr,
        sig0=sig0.astype(np.uint32), sig1=sig1.astype(np.uint32),
        c0=c0.astype(np.uint32), c1=c1.astype(np.uint32),
        cAlpha=cAlpha.astype(np.uint32),
        c28B=c28B, c21B=c21B, c28A=c28A, c21A=c21A,
        MB_mod_A=c.MB_mod_A,
        padA=padA,
        winv=winv.astype(np.uint32),
        wvec=wvec.astype(np.uint32),
        inv_a_f32=c.inv_a_f32,
        T1lo=T1lo, T1hi=T1hi,
        T2lo=T2lo, T2hi=T2hi,
        # scalars: m_r, mu_r (int Barrett), (unused), 2*m_r (alpha2 pad)
        scal=np.array(
            [mr, int(c.barrett[-1]), 0, 2 * mr], np.uint32
        ),
        # f32 reciprocal of m_r (lane 0; padded to width 4) — the m_r
        # chain's mu when f32_mu is selected (flavor is dispatched on
        # muA's dtype, so both rows always ship)
        scalf=np.concatenate(
            [inv_f32(c.mods[-1:]), np.zeros((3,), np.float32)]
        ),
        sqA=c.mont_sq[:k],
        sqB=((c.mont_sq[k:].astype(np.uint64) * wvec) % Bx).astype(
            np.uint32
        ),
        oneA=c.mont_one[:k],
        oneB=((c.mont_one[k:].astype(np.uint64) * wvec) % Bx).astype(
            np.uint32
        ),
        poneB=wvec.astype(np.uint32),  # plain 1 in the scaled domain
        CinA=c.Cin[:, :k],
        CinB=(
            (c.Cin[:, k:].astype(np.uint64) * wvec[None, :]) % Bx[None, :]
        ).astype(np.uint32),
    )

def stack_group_consts2(ctxs, f32_mu=False, device="cpu") -> dict:
    """Build the v3 fused constants from RNSContexts (all same k).

    The B-side (and m_r) lanes of every Montgomery-domain constant are
    pre-multiplied by w = [(M_B/b_j)^{-1} mod b_j | M_B^{-1} mod m_r]
    (the scaled-B carry, see module docstring); ``wvec`` is kept in the
    dict for host-side scaling of extra kernel inputs (fixed-base g).
    ``f32_mu`` selects _red_mu's f32-reciprocal flavor (see there);
    wide-pool contexts (rns.is_wide_pool: any modulus < 2^13) force it —
    the integer-Barrett error bound does not hold for them."""
    f32_mu = f32_mu or any(is_wide_pool(c) for c in ctxs)
    k = ctxs[0].k
    assert all(c.k == k for c in ctxs)
    ds = [_per_ctx_consts2(c, f32_mu=f32_mu) for c in ctxs]
    out = {}
    for key in ds[0]:
        out[key] = _to_tensor(np.stack([d[key] for d in ds]), device)
    return out


def fold_group_consts2(ctxs, f32_mu=False, shared_input=False,
                       device="cpu") -> dict:
    """Fold TWO same-k RNSContexts (CRT's p^2 / q^2) into ONE set of
    kernel constants whose LANE axis carries both groups side by side.

    Folding puts both residue systems on one lane axis: a [rows, 2k] /
    [rows, 2k+2] elementwise op covers both at once, so every squaring in
    the exponentiation serves both CRT halves.  Layout:

      A side   [A_p(k) | A_q(k)]                           (2k lanes)
      B side   [B_p(k) | B_q(k) | mr_p | mr_q]             (2k+2 lanes)
      T1f      [2k, 2k+4]  block-diagonal, output columns
               [B_p | B_q | mr_p | mr_q | alpha_p | alpha_q]
      T2f      [2k, 2k+2]  block-diagonal, output columns
               [A_p | A_q | mr_p | mr_q]
      Cin      [2L, 2k(+2)] block-diagonal (input rows:
               p-limbs | q-limbs), or [L, 2k(+2)] row-shared when
               ``shared_input`` (one limb vector feeds both groups —
               the CRT-decrypt configuration, where the full n^2-width
               ciphertext enters both half-width systems and the
               mod-p^2/q^2 folds ride the Cin weights)

    Group-scoped scalars (Kawamura alpha, Shenoy alpha2) become [Bt, 2]
    columns broadcast to their group's lanes (by lane group id in the kernel); the two
    shared exponents select table rows via two scalar reads + the same
    per-lane masks (maskA/maskB).
    """
    f32_mu = f32_mu or any(is_wide_pool(c) for c in ctxs)
    assert len(ctxs) == 2 and ctxs[0].k == ctxs[1].k
    k = ctxs[0].k
    d0 = _per_ctx_consts2(ctxs[0], f32_mu=f32_mu)
    d1 = _per_ctx_consts2(ctxs[1], f32_mu=f32_mu)
    k2 = 2 * k

    def cat_a(key):  # A-side row constants [k] -> [2k]
        return np.concatenate([d0[key], d1[key]])

    def cat_b(key):  # Bx-side [k+1] -> [B_p | B_q | mr_p | mr_q]
        return np.concatenate(
            [d0[key][:k], d1[key][:k], d0[key][k:], d1[key][k:]]
        )

    out = {}
    for key in ("modsA", "muA", "sig0", "sig1", "sqA", "oneA", "padA",
                "MB_mod_A"):
        out[key] = cat_a(key)
    for key in ("modsBx", "muBx", "c0", "c1", "cAlpha", "c28B", "c21B",
                "winv", "sqB", "oneB", "poneB"):
        out[key] = cat_b(key)
    # T2 reduction targets ([A | m_r] per group) fold the same way
    out["modsAr"] = cat_b("modsAr")
    out["muAr"] = cat_b("muAr")
    out["c28Ar"] = cat_b("c28A")
    out["c21Ar"] = cat_b("c21A")
    # redundant-modulus scalars become [2] rows (one lane per group)
    out["mrv"] = np.array([d0["scal"][0], d1["scal"][0]], np.uint32)
    if f32_mu:
        out["murv"] = np.array([d0["scalf"][0], d1["scalf"][0]], np.float32)
    else:
        out["murv"] = np.array([d0["scal"][1], d1["scal"][1]], np.uint32)
    out["twomrv"] = np.array([d0["scal"][3], d1["scal"][3]], np.uint32)

    def fold_T1(key):  # [k, k+2] per group -> [2k, 2k+4]
        T = np.zeros((k2, k2 + 4), np.int8)
        for g, d in enumerate((d0, d1)):
            rows = slice(g * k, (g + 1) * k)
            T[rows, g * k : (g + 1) * k] = d[key][:, :k]
            T[rows, k2 + g] = d[key][:, k]  # m_r column
            T[rows, k2 + 2 + g] = d[key][:, k + 1]  # alpha column
        return T

    def fold_T2(key):  # [k, k+1] per group -> [2k, 2k+2]
        T = np.zeros((k2, k2 + 2), np.int8)
        for g, d in enumerate((d0, d1)):
            rows = slice(g * k, (g + 1) * k)
            T[rows, g * k : (g + 1) * k] = d[key][:, :k]
            T[rows, k2 + g] = d[key][:, k]
        return T

    out["T1lo"], out["T1hi"] = fold_T1("T1lo"), fold_T1("T1hi")
    out["T2lo"], out["T2hi"] = fold_T2("T2lo"), fold_T2("T2hi")
    # per-lane group masks: the two-exponent table select and the
    # alpha/alpha2 group broadcasts (by lane group id in the kernel)
    maskA = np.zeros((k2,), np.uint32)
    maskA[:k] = 1
    maskB = np.zeros((k2 + 2,), np.uint32)
    maskB[:k] = 1
    maskB[k2] = 1
    out["maskA"], out["maskB"] = maskA, maskB

    L = d0["CinA"].shape[0]
    if shared_input:
        # ONE shared limb vector feeds both groups (CRT decrypt: the
        # full n^2-width ciphertext, whose mod-p^2 / mod-q^2 folds ride
        # the per-group Cin weights — ops/rns.py RNSContext.Cin): rows
        # are the shared limbs, columns the per-group lanes.
        CinA = np.concatenate([d0["CinA"], d1["CinA"]], axis=1)
        CinB = np.zeros((L, k2 + 2), np.uint32)
        CinB[:, :k] = d0["CinB"][:, :k]
        CinB[:, k:k2] = d1["CinB"][:, :k]
        CinB[:, k2] = d0["CinB"][:, k]
        CinB[:, k2 + 1] = d1["CinB"][:, k]
    else:
        # block-diagonal input conversions: rows = [p-limbs | q-limbs]
        CinA = np.zeros((2 * L, k2), np.uint32)
        CinA[:L, :k] = d0["CinA"]
        CinA[L:, k:] = d1["CinA"]
        CinB = np.zeros((2 * L, k2 + 2), np.uint32)
        CinB[:L, :k] = d0["CinB"][:, :k]
        CinB[:L, k2] = d0["CinB"][:, k]
        CinB[L:, k:k2] = d1["CinB"][:, :k]
        CinB[L:, k2 + 1] = d1["CinB"][:, k]
    out["CinA"], out["CinB"] = CinA, CinB

    return {key: _to_tensor(a[None], device) for key, a in out.items()}



# ---------------------------------------------------------------------------
# plain versions (int64 inside)
# ---------------------------------------------------------------------------


def red_mu(v, m, mu, layers=3):
    """Fused reduction of int64 ``v`` (< 2^29.7 integer flavor, < 2^31 f32
    flavor) to v mod m, dispatched on ``mu``'s dtype:

    * integer ``mu`` = floor(2^28/m): Barrett estimate, then the 4m/2m/m
      conditional-subtract chain.
    * float32 ``mu`` = (1 - 2^-20)/m: q = trunc(f32(v) * mu) with v
      converted round-to-nearest and ONE float multiply; q is in
      {q_true-1, q_true}, so one conditional subtract canonicalizes.

    ``layers=2`` stops at a representative < 2m."""
    if mu.dtype == _F32:
        q = (v.to(_F32) * mu).to(_I64)
        r = v - q * m
    else:
        q = ((v >> MOD_BITS) * mu) >> MOD_BITS
        r = v - q * m
        r = torch.where(r >= 4 * m, r - 4 * m, r)
        r = torch.where(r >= 2 * m, r - 2 * m, r)
    if layers >= 3:
        r = torch.where(r >= m, r - m, r)
    return r


def _plane_sums(x, Tlo, Thi):
    """The three digit-plane sums (ll, mid, hh) of x @ T, x < 2^14."""
    xlo = x & DIGIT_MASK
    xhi = x >> DIGIT_BITS
    ll = dot_exact(xlo, Tlo)
    mid = dot_exact(xlo, Thi) + dot_exact(xhi, Tlo)
    hh = dot_exact(xhi, Thi)
    return ll, mid, hh


def _fold(ll, mid, hh, c28, c21, lean):
    """2^14-radix fold of the plane sums with the per-lane constants."""
    if lean:
        return (
            ll
            + (mid << DIGIT_BITS)
            + ((hh & _MASK14) << MOD_BITS)
            + (hh >> MOD_BITS) * c28
        )
    return (
        (hh >> MOD_BITS) * c28
        + ((hh & _MASK14) << MOD_BITS)
        + (mid >> MOD_BITS) * c21
        + ((mid & _MASK14) << DIGIT_BITS)
        + ll
    )


def _mm_terms(x, Tlo, Thi, c28, c21, ncols, lean):
    """Deferred-reduction base extension: the 2^14-radix fold of x @ T over
    the first ``ncols`` columns, plus the raw (ll, mid, hh) plane sums."""
    raw = _plane_sums(x, Tlo, Thi)
    return _fold(*(v[..., :ncols] for v in raw), c28, c21, lean), raw


def _group_bcast(vals, mask):
    """Per-group columns [rows, 2] -> their group's lanes: lanes with
    ``mask`` != 0 take column 0, the rest column 1."""
    return torch.where(mask != 0, vals[:, 0:1], vals[:, 1:2])


def _plain_consts(consts, g=0):
    """Group ``g`` of a constant set, the leading group axis dropped and
    integer tensors widened to int64 (planes and f32 constants keep their
    type)."""
    out = {}
    for key, v in consts.items():
        if not isinstance(v, torch.Tensor):
            continue
        v = v[g]
        out[key] = v.to(_I64) if v.dtype == _I32 else v
    return out


def _num_groups(consts) -> int:
    return consts["sig0"].shape[0]


def _is_lean(consts) -> bool:
    """Whether a constant set takes the lean deferred-reduction fold: only
    under the f32-reciprocal flavor (whose v < 2^31 contract absorbs the
    larger bound of the unsplit mid plane) and only while the contraction of
    the base extensions is short enough for that bound.  The set decides,
    as in the reference, never the key size."""
    return (
        consts["muA"].dtype == _F32
        and consts["T1lo"].shape[-2] <= LEAN_MAX_CONTRACTION
    )


def mont_mul2_plain(c, xA, xB, yA, yB, canonical_out=False, sums=None):
    """Plain version of the kernels' Montgomery product (``c`` from
    :func:`_plain_consts`; int64 operands [rows, lanes], broadcastable).

    xA [rows, k] A-side residues; xB [rows, kb] SCALED B-side residues
    with the redundant lane(s) last.  Returns (rA, zB) of x*y*M_A^{-1} mod
    N (< 3N).  Works on stacked (one system) and folded (two systems side
    by side) constants, in both reduction flavors, with the lean or the
    full fold as the set asks (:func:`_is_lean`).  ``sums(x, ext)`` gives
    the plane sums (ll, mid, hh) of extension ``ext`` (1 or 2) over all the
    weight columns; the default multiplies the planes directly."""
    if sums is None:
        def sums(x, ext):
            return _plane_sums(x, c[f"T{ext}lo"], c[f"T{ext}hi"])
    k = c["sig0"].shape[-1]
    folded = "maskB" in c
    f32 = c["muA"].dtype == _F32
    lean = _is_lean(c)
    if folded:
        m_r, mu_r, two_mr = c["mrv"], c["murv"], c["twomrv"]  # [2]
        c28A, c21A = c["c28Ar"], c["c21Ar"]
    else:
        m_r = c["scal"][0:1]
        mu_r = c["scalf"][0:1] if f32 else c["scal"][1:2]
        two_mr = c["scal"][3:4]
        c28A, c21A = c["c28A"], c["c21A"]

    uA, uB = xA * yA, xB * yB
    hA, lA = uA >> MOD_BITS, uA & _MASK14
    hB, lB = uB >> MOD_BITS, uB & _MASK14
    sigma = red_mu(hA * c["sig1"] + lA * c["sig0"], c["modsA"], c["muA"])
    kp1 = c["c28B"].shape[-1]
    ll, mid, hh = sums(sigma, 1)
    tB = _fold(ll[:, :kp1], mid[:, :kp1], hh[:, :kp1], c["c28B"], c["c21B"], lean)
    # Kawamura alpha from the weight column(s) riding the same product:
    # three float terms added in this order, each add rounded once
    af = (
        ll[:, kp1:].to(_F32)
        + mid[:, kp1:].to(_F32) * float(1 << DIGIT_BITS)
        + hh[:, kp1:].to(_F32) * float(1 << (2 * DIGIT_BITS))
    ) * (1.0 / (1 << ALPHA_W_BITS))
    alpha = torch.clamp(torch.floor(af - ALPHA_MARGIN), min=0.0).to(_I64)
    if folded:
        alpha = _group_bcast(alpha, c["maskB"])
    zB = red_mu(
        hB * c["c1"] + lB * c["c0"] + tB + alpha * c["cAlpha"],
        c["modsBx"], c["muBx"],
    )
    tA = _fold(*(v[:, : c28A.shape[-1]] for v in sums(zB[:, :k], 2)), c28A, c21A, lean)
    alpha2 = red_mu(tA[:, k:] + two_mr - zB[:, k:], m_r, mu_r)
    a2 = _group_bcast(alpha2, c["maskA"]) if folded else alpha2
    rA = red_mu(
        tA[:, :k] + c["padA"] - a2 * c["MB_mod_A"],
        c["modsA"], c["muA"],
        layers=2 if (f32 and not canonical_out) else 3,
    )
    return rA, zB


def _limbs_to_res2(xl, CinA, CinB, c):
    """limbs [rows, L] -> residue pair ([rows, k], [rows, kb]) through the
    three 7-bit digit planes of the limbs."""
    def side(Cin, m, mu):
        Clo, Chi = Cin & DIGIT_MASK, Cin >> DIGIT_BITS
        acc = None
        for shift in (0, DIGIT_BITS, 2 * DIGIT_BITS):
            d = (xl >> shift) & DIGIT_MASK
            v = red_mu((dot_exact(d, Chi) << DIGIT_BITS) + dot_exact(d, Clo), m, mu)
            term = v << shift
            acc = term if acc is None else red_mu(acc + term, m, mu)
        return acc

    return (
        side(CinA, c["modsA"], c["muA"]),
        side(CinB, c["modsBx"], c["muBx"]),
    )


def fb_table2_plain(gA, gB, consts):
    """Plain version of :func:`fb_table2`."""
    c = _plain_consts(consts)
    accA = c["oneA"].expand(gA.shape[1], -1)
    accB = c["oneB"].expand(gB.shape[1], -1)
    yA, yB = gA[0].to(_I64), gB[0].to(_I64)
    tabA, tabB = [], []
    for j in range(FB_TABLE):
        tabA.append(accA)
        tabB.append(accB)
        if j < FB_TABLE - 1:
            accA, accB = mont_mul2_plain(c, accA, accB, yA, yB, canonical_out=True)
    return (
        torch.stack(tabA)[None].to(_I32).contiguous(),
        torch.stack(tabB)[None].to(_I32).contiguous(),
    )


def fb_onehot_gather_plain(planes, w, k):
    """Plain version of K2's gather: the entries rows select from one step's
    planes ([2, FB_CHUNKS, W / 4, 32, 2] int32, a step of
    :func:`fb_gather_table`) by bytes ``w`` [B], as the reference's one-hot
    product, ``onehot [B, 256] @ planes [256, lanes]`` over the 7-bit digit
    planes, exact (:func:`dot_exact`), recombined as lo + (hi << 7).
    Returns [B, 2k+1] int64 (A lanes, then B)."""
    P = fb_unpack_planes(planes).to(_I64)  # [side, plane, 256, W]
    W = P.shape[-1]
    onehot = (w.to(_I64)[:, None] == torch.arange(FB_TABLE, device=w.device)).to(_I64)
    sums = dot_exact(onehot, P.permute(2, 0, 1, 3).reshape(FB_TABLE, 4 * W))
    lo_hi = sums.view(-1, 2, 2, W)
    sel = lo_hi[:, :, 0] + (lo_hi[:, :, 1] << DIGIT_BITS)  # [B, side, W]
    return torch.cat([sel[:, 0, :k], sel[:, 1, : k + 1]], dim=-1)


def fb_modexp2_plain(planes, wins, consts, mont_out=False):
    """Plain version of :func:`fb_modexp2`: the table entries gathered by the
    one-hot product (:func:`fb_onehot_gather_plain`)."""
    c = _plain_consts(consts)
    k = c["sig0"].shape[-1]
    NP = planes.shape[0]
    w = wins[0]  # [B, NP]
    accA = accB = None
    for i in range(NP):
        sel = fb_onehot_gather_plain(planes[i], w[:, i], k)  # [B, k + kb]
        if i == 0:
            accA, accB = sel[:, :k], sel[:, k:]
        else:
            accA, accB = mont_mul2_plain(c, accA, accB, sel[:, :k], sel[:, k:])
    if not mont_out:
        pA = torch.ones((1, k), dtype=_I64, device=planes.device)
        accA, accB = mont_mul2_plain(c, accA, accB, pA, c["poneB"][None])
    outB = red_mu(accB * c["winv"], c["modsBx"], c["muBx"])
    return torch.cat([accA, outB], dim=-1)[None].to(_I32)


def rns_modexp2f_plain(base_limbs, windows, consts):
    """Plain version of :func:`rns_modexp2f`."""
    c = _plain_consts(consts)
    k = c["sig0"].shape[-1]
    xl = base_limbs.to(_I64)
    B = xl.shape[0]
    wins = windows.to("cpu").tolist()  # the key's exponents: same for all rows
    xA, xB = _limbs_to_res2(xl, c["CinA"], c["CinB"], c)
    aA, aB = mont_mul2_plain(c, xA, xB, c["sqA"], c["sqB"])
    oneA = c["oneA"].expand(B, -1)
    oneB = c["oneB"].expand(B, -1)
    tabA, tabB = [oneA, aA], [oneB, aB]
    for _ in range(2, _TABLE):
        nA, nB = mont_mul2_plain(c, tabA[-1], tabB[-1], aA, aB)
        tabA.append(nA)
        tabB.append(nB)
    gA, gB = c["maskA"] != 0, c["maskB"] != 0
    accA, accB = oneA, oneB
    for w0, w1 in zip(wins[0], wins[1]):
        for _ in range(WINDOW_BITS):
            accA, accB = mont_mul2_plain(c, accA, accB, accA, accB)
        selA = torch.where(gA, tabA[w0], tabA[w1])
        selB = torch.where(gB, tabB[w0], tabB[w1])
        accA, accB = mont_mul2_plain(c, accA, accB, selA, selB)
    pA = torch.ones((1, k), dtype=_I64, device=xl.device)
    outA, outB = mont_mul2_plain(c, accA, accB, pA, c["poneB"][None])
    outB = red_mu(outB * c["winv"], c["modsBx"], c["muBx"])
    return torch.cat([outA, outB], dim=-1).to(_I32)


def rns_modexp2_plain(base_limbs, windows, consts, shared=False):
    """Plain version of :func:`rns_modexp2`."""
    if "maskB" in consts:
        raise ValueError("rns_modexp2 needs stacked (not folded) constants")
    outs = []
    for g in range(_num_groups(consts)):
        c = _plain_consts(consts, g)
        k = c["sig0"].shape[-1]
        xl = base_limbs[g if base_limbs.shape[0] > 1 else 0].to(_I64)
        B = xl.shape[0]
        xA, xB = _limbs_to_res2(xl, c["CinA"], c["CinB"], c)
        aA, aB = mont_mul2_plain(c, xA, xB, c["sqA"], c["sqB"])
        oneA = c["oneA"].expand(B, -1)
        oneB = c["oneB"].expand(B, -1)
        tabA, tabB = [oneA, aA], [oneB, aB]
        for _ in range(2, _TABLE):
            nA, nB = mont_mul2_plain(c, tabA[-1], tabB[-1], aA, aB)
            tabA.append(nA)
            tabB.append(nB)
        if shared:  # one exponent for every row: the windows are host ints
            sels = [
                (tabA[w & (_TABLE - 1)], tabB[w & (_TABLE - 1)])
                for w in windows[g].to("cpu").tolist()
            ]
        else:  # row i takes entry w[i] of its own table
            tA, tB = torch.stack(tabA), torch.stack(tabB)  # [16, B, lanes]
            w = windows[g].to(_I64) & (_TABLE - 1)  # [B, NW]
            rows = torch.arange(B, device=xl.device)
            sels = [
                (tA[w[:, i], rows], tB[w[:, i], rows]) for i in range(w.shape[-1])
            ]
        accA, accB = oneA, oneB
        for selA, selB in sels:
            for _ in range(WINDOW_BITS):
                accA, accB = mont_mul2_plain(c, accA, accB, accA, accB)
            accA, accB = mont_mul2_plain(c, accA, accB, selA, selB)
        pA = torch.ones((1, k), dtype=_I64, device=xl.device)
        outA, outB = mont_mul2_plain(c, accA, accB, pA, c["poneB"][None])
        outB = red_mu(outB * c["winv"], c["modsBx"], c["muBx"])
        outs.append(torch.cat([outA, outB], dim=-1))
    return torch.stack(outs).to(_I32)


def unfold_rns_out(res, k):
    """Folded [B, 4k+2] kernel output -> grouped [2, B, 2k+1] residues
    ([A | B | m_r] lane order per group)."""
    outA, outB = res[:, : 2 * k], res[:, 2 * k :]
    res_p = torch.cat(
        [outA[:, :k], outB[:, :k], outB[:, 2 * k : 2 * k + 1]], dim=-1
    )
    res_q = torch.cat(
        [outA[:, k:], outB[:, k : 2 * k], outB[:, 2 * k + 1 :]], dim=-1
    )
    return torch.stack([res_p, res_q])


#: Contraction chunks of 32 table entries in K2's one-hot product.
FB_CHUNKS = FB_TABLE // 32


def fb_planes_width(k):
    """Lanes of K2's planes for a one-system set of k A lanes: the width of
    the tensor-core layout that runs it (:func:`tc_layout` of the set's
    :func:`_kernel_pack` width)."""
    return tc_layout(-(-(k + 2) // 32) * 32, "fb_modexp2")[2]


def fb_indexed_table(tabA, tabB):
    """Table pair ([1,256,NP,k], [1,256,NP,k+1]) -> [NP, 256, 2k+1] int32,
    one word a residue with the A lanes first: the entry a byte names at an
    address that takes the byte, the input of :func:`fb_pack_planes` and the
    plain oracle the tests hold the one-hot gather against."""
    return torch.cat([tabA[0], tabB[0]], dim=-1).transpose(0, 1).contiguous()


def fb_pack_planes(tab):
    """[NP, 256, 2k+1] int32 (:func:`fb_indexed_table`; canonical residues,
    below 2^14) -> K2's planes: the B fragments of the one-hot product,
    [NP, 2, FB_CHUNKS, W / 4, 32, 2] int32 (W = :func:`fb_planes_width`).
    Word (i, side, kc, nt, 4g + t, r) holds, byte e, digit plane g % 2 (lo,
    hi: the reference's ``fb_digit_planes2``) of side ``side`` (A lanes, B
    lanes) of lane 4 nt + g // 2 in entry 32 kc + 16 r + 4 t + e of step i:
    mma.sync m16n8k32's B operand, tile column 2t / 2t + 1 the lo / hi plane
    of lane 4 nt + t (zero beyond the side's lanes)."""
    NP, T, Wt = tab.shape
    k = (Wt - 1) // 2
    if T != FB_TABLE or Wt != 2 * k + 1:
        raise ValueError(f"tab: expected [NP, {FB_TABLE}, 2k+1], got {tuple(tab.shape)}")
    if tab.numel() and (int(tab.min()) < 0 or int(tab.max()) >= 1 << (2 * DIGIT_BITS)):
        raise ValueError("tab: the one-hot gather needs canonical residues below 2^14")
    W = fb_planes_width(k)
    S = torch.zeros((NP, 2, FB_TABLE, W), dtype=_I32, device=tab.device)
    S[:, 0, :, :k] = tab[..., :k]
    S[:, 1, :, : k + 1] = tab[..., k:]
    P = torch.stack([S & DIGIT_MASK, S >> DIGIT_BITS], dim=2).to(torch.int8)
    # [i, side, p, kc, r, t, e, nt, h] -> [i, side, kc, nt, h, p, t, r, e]:
    # thread 4g + t with g = 2h + p, word r, byte e
    P = P.view(NP, 2, 2, FB_CHUNKS, 2, 4, 4, W // 4, 4).permute(0, 1, 3, 7, 8, 2, 5, 4, 6)
    return P.contiguous().view(_I32).reshape(NP, 2, FB_CHUNKS, W // 4, 32, 2)


def fb_unpack_planes(planes):
    """K2's planes [..., 2, FB_CHUNKS, W / 4, 32, 2] int32 -> the digit
    planes [..., side, plane (lo, hi), 256, W] int8 (:func:`fb_pack_planes`
    read back)."""
    lead, (_, _, NT) = planes.shape[:-5], planes.shape[-5:-2]
    b = planes.contiguous().view(torch.int8).reshape(*lead, 2, FB_CHUNKS, NT, 4, 2, 4, 2, 4)
    n = len(lead)
    # [side, kc, nt, h, p, t, r, e] -> [side, p, kc, r, t, e, nt, h]
    b = b.permute(*range(n), *(n + i for i in (0, 4, 1, 6, 5, 7, 2, 3)))
    return b.reshape(*lead, 2, 2, FB_TABLE, 4 * NT)


def fb_gather_table(tabA, tabB):
    """Table pair ([1,256,NP,k], [1,256,NP,k+1], K1's canonical output) ->
    the table :func:`fb_modexp2` takes: the int8 digit planes of every entry
    as the B fragments of its one-hot product (:func:`fb_pack_planes`), built
    once a key.  The gather reads all of a step's planes whatever the byte,
    as the reference's one-hot product does, so no load address takes a
    secret byte; 2 x 2 x 256 x W bytes a byte position, a quarter of
    :func:`fb_indexed_table`'s words."""
    return fb_pack_planes(fb_indexed_table(tabA, tabB))


# ---------------------------------------------------------------------------
# kernel constant packing
# ---------------------------------------------------------------------------

# rows of the packed per-lane table; order fixed by csrc/rns_mont_mul.cuh
_ROW_IDS = (
    "modsA", "muA", "sig0", "sig1", "padA", "MB_mod_A", "c28A", "c21A", "gidA",
    "modsBx", "muBx", "c0", "c1", "cAlpha", "c28B", "c21B", "gidB", "winv",
    "sqA", "sqB", "oneA", "oneB", "poneB", "mr", "mur", "twomr",
)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """int32 view of a constant row (float32 rows as their bit patterns)."""
    return t.view(_I32) if t.dtype == _F32 else t.to(_I32)


def _pack_group(c, folded, f32, k, kb, W):
    """Device-side form of ONE group ``c`` (leading axis dropped) of a
    constant set: (rowc [NROWS, W], Cin [L, W, 2])."""
    dev = c["sig0"].device
    rows = dict(c)
    if folded:
        rows["c28A"], rows["c21A"] = c["c28Ar"], c["c21Ar"]
        rows["gidA"] = 1 - c["maskA"]
        rows["gidB"] = 1 - c["maskB"]
        rows["mr"], rows["mur"], rows["twomr"] = c["mrv"], c["murv"], c["twomrv"]
    else:
        rows["gidA"] = torch.zeros(k, dtype=_I32, device=dev)
        rows["gidB"] = torch.zeros(kb, dtype=_I32, device=dev)
        rows["mr"] = c["scal"][0:1]
        rows["mur"] = c["scalf"][0:1] if f32 else c["scal"][1:2]
        rows["twomr"] = c["scal"][3:4]
    rowc = torch.zeros((len(_ROW_IDS), W), dtype=_I32, device=dev)
    for i, key in enumerate(_ROW_IDS):
        v = _bits(rows[key])
        rowc[i, : v.shape[0]] = v
    L = c["CinA"].shape[0]
    cin = torch.zeros((L, W, 2), dtype=_I32, device=dev)
    cin[:, :k, 0] = c["CinA"]
    cin[:, :kb, 1] = c["CinB"]
    return rowc, cin


def _group(consts, g):
    """Group ``g`` of a constant set (leading axis dropped, types kept)."""
    return {key: v[g] for key, v in consts.items() if isinstance(v, torch.Tensor)}


def _kernel_pack(consts):
    """The device-side form of a constant set, built once and cached in the
    dict: per group the per-lane row table and the interleaved Cin weights,
    stacked on a leading group axis ([G, ...]; a folded set is one group
    whose lanes hold two residue systems), with the set's dimensions and
    flavor; :func:`_tc_pack_layout` adds the weight fragments of a layout.
    Raises for sets the compiled kernels do not cover."""
    pack = consts.get("_pack")
    if pack is not None:
        return pack
    G = _num_groups(consts)
    folded = "maskB" in consts
    f32 = consts["muA"].dtype == _F32
    k = consts["sig0"].shape[-1]
    kb = consts["modsBx"].shape[-1]
    lane_systems = 2 if folded else 1
    if folded and (not f32 or G != 1):
        raise NotImplementedError(
            "the compiled folded kernel covers one f32-reciprocal folded set; "
            "integer-Barrett folded sets are not compiled"
        )
    lean = _is_lean(consts)
    W = -(-max(kb + lane_systems, k + lane_systems) // 32) * 32
    max_w = KERNEL_MAX_THREADS_FOLDED if folded else KERNEL_MAX_THREADS
    if W > max_w:
        raise NotImplementedError(
            f"{W} lanes exceed the {max_w} of the "
            f"{'CRT-folded' if folded else 'RNS'} kernels"
            + (": wider keys take the grouped layout" if folded else "")
        )
    groups = [_pack_group(_group(consts, g), folded, f32, k, kb, W) for g in range(G)]
    rowc, cin = (torch.stack(t).contiguous() for t in zip(*groups))
    pack = dict(k=k, kb=kb, W=W, G=G, f32=f32, lean=lean, rowc=rowc, Cin=cin)
    consts["_pack"] = pack
    trace.count("kernels.packs_built")
    return pack


def _single_system_pack(consts, name):
    """:func:`_kernel_pack` for the fixed-base kernels: one residue system
    (either reduction flavor)."""
    p = _kernel_pack(consts)
    if p["G"] != 1 or "maskB" in consts:
        raise NotImplementedError(f"{name} runs one residue system a launch")
    return p


# ---------------------------------------------------------------------------
# the tensor-core form: packing, and the tiling in plain PyTorch
# ---------------------------------------------------------------------------
#
# mma.sync.m16n8k32 (s8 x s8 -> s32), fragments as the PTX ISA defines them
# (g = lane / 4, t = lane % 4 of a warp):
#   A (16 x 32, row-major) registers r = 0..3, bytes e: tile row g + 8 (r & 1),
#       contraction 16 (r >> 1) + 4 t + e
#   B (32 x 8, column-major) registers r = 0..1, bytes e: column g,
#       contraction 16 r + 4 t + e
#   C (16 x 8) registers 0..3: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
# Tile rows g / g + 8 are the low / high digits of batch row 8 mt + g; tile
# columns 2t / 2t + 1 the Tlo / Thi weights of lane 4 nt + t of a CTA's
# quarter.  So C holds ll, lo*Thi, hi*Tlo, hh of one (row, lane).


def _tc_frag_index():
    """PTX fragment layouts as index arrays over (thread, register, byte):
    A tile row and contraction, B contraction and column."""
    th, r, e = np.meshgrid(np.arange(32), np.arange(4), np.arange(4), indexing="ij")
    g, t = th // 4, th % 4
    a_row = g + 8 * (r & 1)
    a_k = 16 * (r >> 1) + 4 * t + e
    th, r, e = np.meshgrid(np.arange(32), np.arange(2), np.arange(4), indexing="ij")
    b_k = 16 * r + 4 * (th % 4) + e
    b_col = th // 4
    return a_row, a_k, b_k, b_col


def _pack_tc_planes(Tlo, Thi, W, cluster=TC_CLUSTER):
    """int8 planes [k, cols] -> the B fragments of every CTA of a cluster:
    int32 [cluster, KC, NT, 32, 2] (KC = ceil(k / 32) contraction chunks,
    NT = W / (4 cluster) n-tiles of four lanes a CTA).  Word (c, kc, nt, 4g +
    t, r) holds, byte e, plane g % 2 of lane c W/cluster + 4 nt + g // 2 at
    contraction row 32 kc + 16 r + 4 t + e (zero beyond the planes)."""
    k, cols = Tlo.shape
    KC = -(-k // 32)
    NT = W // (4 * cluster)
    P = torch.zeros((2, KC * 32, W), dtype=torch.int8, device=Tlo.device)
    P[0, :k, :cols] = Tlo
    P[1, :k, :cols] = Thi
    # [p, kc, r, t, e, c, nt, h] -> [c, kc, nt, h, p, t, r, e]; thread 4g + t
    # with g = 2h + p
    P = P.view(2, KC, 2, 4, 4, cluster, NT, 4).permute(5, 1, 6, 7, 0, 3, 2, 4)
    return P.contiguous().view(_I32).reshape(cluster, KC, NT, 32, 2)


def _tc_alpha_tiles(T1, kb):
    """T1's B fragments [TC_CLUSTER, KC, NT, 32, 2] -> those of its n-tiles
    kb / 4 and kb / 4 + 1 (zero past the last), [KC, 2, 32, 2]: the Kawamura
    alpha columns kb.. kb + G - 1, which every CTA of a cluster holds a copy
    of to compute alpha itself."""
    C, KC, NT = T1.shape[:3]
    flat = T1.permute(1, 0, 2, 3, 4).reshape(KC, C * NT, 32, 2)  # global n-tiles
    out = torch.zeros((KC, 2, 32, 2), dtype=T1.dtype, device=T1.device)
    for i in range(2):
        if kb // 4 + i < C * NT:
            out[:, i] = flat[:, kb // 4 + i]
    return out.contiguous()


def tc_nl(halves):
    """n-tiles a warp owns (= lanes a thread) in a layout of ``halves``."""
    return TC_NL * halves


def tc_layout(W, kernel, G=1):
    """(CTAs a cluster, m-tiles a cluster, lanes, halves) of the tensor-core
    layout in which ``kernel`` (a key of :data:`TC_KERNEL_LAYOUTS`) runs a set
    of ``W`` lanes (:func:`_kernel_pack`) and ``G`` groups: the first of its
    layouts that holds the set with its lanes padded to whole warps of a half
    of a CTA (a multiple of 4 * CTAs * :func:`tc_nl`).  K3 runs one group.
    Raises for anything else."""
    if kernel == "rns_modexp2f" and G != 1:
        raise NotImplementedError("the folded tensor-core kernel runs one constant group")
    names = TC_KERNEL_LAYOUTS[kernel]
    for name in names:
        cluster, mt, max_w, halves = TC_LAYOUTS[name]
        step = 4 * cluster * tc_nl(halves)
        padded = -(-W // step) * step
        if padded <= max_w:
            return cluster, mt, padded, halves
    raise NotImplementedError(
        f"{W} lanes exceed the {TC_LAYOUTS[names[-1]][2]} of the tensor-core {kernel}")


def _tc_pack(consts, kernel):
    """The tensor-core form of a constant set for ``kernel`` (:func:`tc_layout`;
    ``"rns_modexp2f"`` takes the folded sets, the others one-system ones):
    :func:`_tc_pack_layout` of its layout.  Raises for sets the kernel does
    not take."""
    p = _kernel_pack(consts)
    folded = "maskB" in consts
    if folded != (kernel == "rns_modexp2f"):
        raise ValueError(f"{kernel} takes {'one-system' if folded else 'CRT-folded'} "
                         "constant sets")
    return _tc_pack_layout(consts, tc_layout(p["W"], kernel, p["G"]))


def _tc_pack_layout(consts, layout):
    """The tensor-core form of a constant set for ``layout`` = (CTAs a
    cluster, m-tiles, lanes[, halves]; one half if not given), built once a
    layout and cached in the dict (layouts of one cluster size and width
    share their tensors: the B fragments are laid out by n-tile, whichever
    warp reads them): per group T1 / T2 as B fragments
    (:func:`_pack_tc_planes`) and T1's alpha tiles, stacked on a leading
    group axis, with the row table, Cin, dimensions and flavor of
    :func:`_kernel_pack` at the layout's width."""
    packs = consts.setdefault("_tc_pack", {})
    layout = tuple(layout) + (1,) * (4 - len(layout))
    if layout in packs:
        return packs[layout]
    cluster, mt, W, halves = layout
    for (c2, _, w2, _), other in packs.items():
        if (c2, w2) == (cluster, W):
            packs[layout] = dict(other, mt=mt, halves=halves)
            return packs[layout]
    p = _kernel_pack(consts)
    folded = "maskB" in consts
    G = p["G"]
    if W == p["W"]:
        rowc, cin = p["rowc"], p["Cin"]
    else:  # the padded width: the row table and Cin at its stride
        groups = [_pack_group(_group(consts, g), folded, p["f32"], p["k"], p["kb"], W)
                  for g in range(G)]
        rowc, cin = (torch.stack(t).contiguous() for t in zip(*groups))

    def planes(ext):
        return [_pack_tc_planes(consts[f"T{ext}lo"][g], consts[f"T{ext}hi"][g], W, cluster)
                for g in range(G)]

    T1 = planes(1)
    tcp = dict(
        k=p["k"], kb=p["kb"], W=W, G=G, f32=p["f32"], lean=p["lean"], cluster=cluster,
        mt=mt, halves=halves, rowc=rowc, Cin=cin, KC=-(-p["k"] // 32),
        T1=torch.stack(T1).contiguous(),
        T1a=torch.stack([_tc_alpha_tiles(t, p["kb"]) for t in T1]).contiguous(),
        T2=torch.stack(planes(2)).contiguous(),
    )
    packs[layout] = tcp
    trace.count("kernels.packs_built")
    return tcp


def tc_digit_fragments(x, KC):
    """Values x [rows, k] (< 2^14; rows a multiple of 8) -> the A fragments
    of their 7-bit digits, int32 [rows / 8, KC, 32, 4], as the kernel pushes
    them (contraction positions k..32 KC - 1 hold zero)."""
    R, k = x.shape
    D = torch.zeros((2, R, KC * 32), dtype=torch.uint8, device=x.device)
    D[0, :, :k] = (x & DIGIT_MASK).to(torch.uint8)
    D[1, :, :k] = (x >> DIGIT_BITS).to(torch.uint8)
    # [p, mt, g, kc, rh, t, e] -> [mt, kc, g, t, rh, p, e]: register r = 2 rh + p
    D = D.view(2, R // 8, 8, KC, 2, 4, 4).permute(1, 3, 2, 5, 4, 0, 6)
    return D.contiguous().view(_I32).reshape(R // 8, KC, 32, 4)


def tc_place(tcp, rank, thread):
    """Where thread ``thread`` of the CTA of rank ``rank`` stands in the
    tiling of ``tcp`` (:func:`_tc_pack`), as csrc/rns_mont_mul_tc.cuh place()
    puts it: its half h, warp v within the half, g and t of its warp lane, its
    first lane j0 of the set (its lanes j0 + 4 nl, nl < NL) and the m-tiles
    of its half (mt0 .. mt0 + nmt - 1; rows 8 mt + g of the cluster)."""
    C, W, MT, halves = tcp["cluster"], tcp["W"], tcp["mt"], tcp["halves"]
    Wc, NL = W // C, tc_nl(halves)
    hn = 4 * Wc // halves
    h = thread // hn
    v = (thread - h * hn) // 32
    lane = thread % 32
    mth = -(-MT // halves)
    return dict(h=h, v=v, g=lane // 4, t=lane % 4, j0=rank * Wc + 4 * NL * v + lane % 4,
                NL=NL, mt0=h * mth, nmt=min(mth, MT - h * mth))


def tc_elements(tcp):
    """Every (row, lane) element of one cluster as the kernel's threads own
    them (:func:`tc_place`): int64 arrays, one entry per (CTA, thread, nl, u)
    of the threads' loops, of the owner (half, CTA rank, warp in its half,
    thread, nl, u), the cluster row and set lane, and the accumulator
    fragment that holds it (m-tile, n-tile of the CTA, g, t)."""
    return _tc_elements(tcp["cluster"], tcp["mt"], tcp["W"], tcp.get("halves", 1))


@functools.lru_cache(maxsize=None)
def _tc_elements(C, MT, W, halves):
    tcp = dict(cluster=C, mt=MT, W=W, halves=halves)
    cols = {key: [] for key in ("half", "rank", "warp", "thread", "nl", "u", "row", "lane",
                                "mt", "nt", "g", "t")}
    for rank in range(C):
        for thread in range(4 * W // C):
            q = tc_place(tcp, rank, thread)
            for nl in range(q["NL"]):
                lane = q["j0"] + 4 * nl
                for u in range(q["nmt"]):
                    mt = q["mt0"] + u
                    for key, val in (("half", q["h"]), ("rank", rank), ("warp", q["v"]),
                                     ("thread", thread), ("nl", nl), ("u", u),
                                     ("row", 8 * mt + q["g"]), ("lane", lane), ("mt", mt),
                                     ("nt", (lane - rank * (W // C)) // 4), ("g", q["g"]),
                                     ("t", q["t"])):
                        cols[key].append(val)
    return {key: torch.tensor(val, dtype=_I64) for key, val in cols.items()}


def tc_extend_plain(A, Bf, tcp=None):
    """The tensor-core extension in plain PyTorch: A fragments [MT, KC, 32, 4]
    and B fragments [C, KC, NT, 32, 2] -> the accumulator fragments read back
    per (row, lane): (ll, mid, hh), each int64 [8 MT, C NT 4], lane
    c W/C + 4 nt + t taken from CTA c, n-tile nt, thread t.  With ``tcp``
    (:func:`_tc_pack`), read back by the owners of :func:`tc_elements`, one
    cluster of ``tcp["mt"]`` m-tiles after another (rows past 8 MT dropped),
    each (row, lane) exactly once."""
    a_row, a_k, b_k, b_col = _tc_frag_index()
    MT, KC = A.shape[:2]
    C, _, NT = Bf.shape[:3]
    ab = A.contiguous().view(torch.int8).view(MT, KC, 32, 4, 4).to(_I64)
    At = torch.zeros((MT, KC, 16, 32), dtype=_I64, device=A.device)
    At[:, :, torch.from_numpy(a_row), torch.from_numpy(a_k)] = ab
    bb = Bf.contiguous().view(torch.int8).view(C, KC, NT, 32, 2, 4).to(_I64)
    Bt = torch.zeros((C, KC, NT, 32, 8), dtype=_I64, device=A.device)
    Bt[:, :, :, torch.from_numpy(b_k), torch.from_numpy(b_col)] = bb
    Ct = torch.einsum("akmx,cknxy->acnmy", At, Bt)  # [MT, C, NT, 16, 8]
    c0, c1 = Ct[..., :8, 0::2], Ct[..., :8, 1::2]
    c2, c3 = Ct[..., 8:, 0::2], Ct[..., 8:, 1::2]
    if tcp is None:
        def lanes(v):  # [MT, C, NT, g, t] -> [8 MT, C NT 4]
            return v.permute(0, 3, 1, 2, 4).reshape(MT * 8, C * NT * 4)

        return lanes(c0), lanes(c1 + c2), lanes(c3)
    e = tc_elements(tcp)
    outs = [torch.full((MT * 8, C * NT * 4), -1, dtype=_I64) for _ in range(3)]
    seen = torch.zeros((MT * 8, C * NT * 4), dtype=_I64)
    for q in range(-(-MT // tcp["mt"])):
        M = q * tcp["mt"] + e["mt"]
        keep = M < MT
        M, rows, lanes_ = M[keep], (8 * q * tcp["mt"] + e["row"])[keep], e["lane"][keep]
        idx = (M, e["rank"][keep], e["nt"][keep], e["g"][keep], e["t"][keep])
        for out, v in zip(outs, (c0, c1 + c2, c3)):
            out[rows, lanes_] = v[idx]
        seen.index_put_((rows, lanes_), torch.ones_like(rows), accumulate=True)
    if not bool((seen == 1).all()):
        raise AssertionError("the tiling does not own every (row, lane) exactly once")
    return tuple(outs)


def mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB, canonical_out=False, g=0):
    """:func:`mont_mul2_plain` with both base extensions walked through the
    tensor-core tiling of ``tcp`` (:func:`_tc_pack`; ``c`` is its group
    ``g``): digit fragments, the B fragments of every CTA, one m16n8k32
    product per (m-tile, CTA, n-tile, contraction chunk), the accumulators
    read back by the thread that owns each (row, lane) (:func:`tc_elements`:
    its half, warp, lane nl and m-tile u).  Operands [rows, lanes] int64 with
    rows a multiple of 8."""
    def sums(x, ext):
        ncols = c[f"T{ext}lo"].shape[-1]
        A = tc_digit_fragments(x, tcp["KC"])
        return tuple(v[:, :ncols] for v in tc_extend_plain(A, tcp[f"T{ext}"][g], tcp))

    return mont_mul2_plain(c, xA, xB, yA, yB, canonical_out=canonical_out, sums=sums)


def tc_lane_owner(tcp, lane, row=0):
    """(CTA rank, warp, n-tile of the warp, thread column t) that owns
    ``lane`` of the set at cluster row ``row``: a CTA owns W / cluster lanes,
    a warp :func:`tc_nl` n-tiles of four lanes of its half's rows, thread
    column t lane t of each; the warps of half h follow those of half h - 1."""
    C, W, halves = tcp["cluster"], tcp["W"], tcp.get("halves", 1)
    Wc, NL = W // C, tc_nl(halves)
    jl = lane % Wc
    h = 0 if halves == 1 else (row % (8 * tcp["mt"])) // 8 // -(-tcp["mt"] // halves)
    return lane // Wc, h * (Wc // (4 * NL)) + jl // (4 * NL), (jl // 4) % NL, lane % 4


def tc_exchange_expected(tcp, rank, half, G):
    """What the mbarriers of half ``half`` of the CTA of rank ``rank`` wait
    for a product in a layout of two halves, as csrc/rns_mont_mul_tc.cuh
    digit_bytes / digit_arrivals / alpha2_bytes count it: the bytes of each
    digit buffer (sigma's and z_B's alike), its arrivals (its own arm and
    one from every other CTA without a lane of the contraction), and the bytes
    of alpha' (``G`` redundant lanes)."""
    C, W, MT, halves = tcp["cluster"], tcp["W"], tcp["mt"], tcp["halves"]
    Wc, KC = W // C, tcp["KC"]
    mth = -(-MT // halves)
    nmt = min(mth, MT - half * mth)

    def contraction(r):
        return max(0, min(r * Wc + Wc, 32 * KC) - r * Wc)

    return dict(digit_bytes=16 * nmt * (32 * KC - contraction(rank)),
                arrivals=1 + sum(r != rank and contraction(r) == 0 for r in range(C)),
                alpha2_bytes=32 * nmt * sum(j // Wc != rank
                                            for j in range(tcp["k"], tcp["k"] + G)))


def tc_exchange_pushed(tcp, sender, half, G):
    """A walk of what the CTA of rank ``sender`` pushes for half ``half`` a
    product, store by store as csrc/rns_mont_mul_tc.cuh share_digits and the
    epilogue of extension 2 issue them: {receiver rank: (digit bytes a digit
    buffer, arrivals on its digit barriers, alpha' bytes)}."""
    C, W, MT, halves = tcp["cluster"], tcp["W"], tcp["mt"], tcp["halves"]
    Wc, KC, k = W // C, tcp["KC"], tcp["k"]
    lo, hi = sender * Wc, sender * Wc + Wc
    kc0 = lo >> 5
    nkc = min((hi - 1) >> 5, KC - 1) - kc0 + 1
    out = {r: [0, 0, 0] for r in range(C) if r != sender}
    if nkc <= 0:
        for r in out:
            out[r][1] += 1
    else:
        threads = 4 * Wc // halves
        mth = -(-MT // halves)
        items = min(mth, MT - half * mth) * nkc * 32
        for ht in range(threads):
            for i in range(ht, items, threads):
                th = i & 31
                q = (kc0 + (i >> 5) % nkc) * 32 + 4 * (th & 3)
                h0, h1 = lo <= q < hi, lo <= q + 16 < hi
                for r in out:
                    out[r][0] += 16 if h0 and h1 else 8 if h0 or h1 else 0
    for thread in range(4 * Wc):
        place = tc_place(tcp, sender, thread)
        if place["h"] != half:
            continue
        for nl in range(place["NL"]):
            if k <= place["j0"] + 4 * nl < k + G:
                for r in out:
                    out[r][2] += 4 * place["nmt"]
    return {r: tuple(v) for r, v in out.items()}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _same_device(ref, *others):
    for name, t in others:
        if t.device != ref.device:
            raise ValueError(
                f"{name} lies on {t.device}, expected {ref.device}"
            )


def _fb_table2_args(gA, gB, consts):
    """Checks of :func:`fb_table2`; returns (NP, k)."""
    G, NP, k = gA.shape
    _check(gA, "gA", _I32)
    _check(gB, "gB", _I32, (G, NP, k + 1))
    _same_device(gA, ("gB", gB), ("consts", consts["sig0"]))
    if G != 1 or _num_groups(consts) != 1 or consts["sig0"].shape[-1] != k:
        raise ValueError("fb_table2: one residue system matching consts expected")
    return NP, k


def fb_table2(gA, gB, consts):
    """K1: fixed-base table from Montgomery-form g_i = base^(2^(8 i)):
    gA [1, NP, k], gB [1, NP, k+1] (scaled B side) int32 ->
    ([1, 256, NP, k], [1, 256, NP, k+1]) int32, entry j of row i being
    g_i^j in Montgomery form with canonical residues (in either reduction
    flavor of ``consts``).  Runs the tensor-core kernel on every set of up
    to :data:`TC_WIDE_MAX_W` lanes and raises for any other."""
    with trace.span("kernels.k1"):
        NP, k = _fb_table2_args(gA, gB, consts)
        if gA.device.type == "cpu":
            return fb_table2_plain(gA, gB, consts)
        _build.need_cuda("fb_table2", gA)
        _single_system_pack(consts, "fb_table2")
        p = _tc_pack(consts, "fb_table2")
        tabA = torch.empty((1, FB_TABLE, NP, k), dtype=_I32, device=gA.device)
        tabB = torch.empty((1, FB_TABLE, NP, k + 1), dtype=_I32, device=gA.device)
        with torch.cuda.device(gA.device):
            err = _build.load().fb_table2_tc_launch(
                gA.data_ptr(), gB.data_ptr(), p["rowc"].data_ptr(),
                p["T1"].data_ptr(), p["T2"].data_ptr(), p["T1a"].data_ptr(), tabA.data_ptr(),
                tabB.data_ptr(), NP, FB_TABLE, k, k + 1, p["W"],
                int(p["f32"]), int(p["lean"]), _build.current_stream_ptr(),
            )
        _build.check_launch(err, "fb_table2")
        LAUNCHES["fb_table2"] += 1
        return tabA, tabB


def _fb_modexp2_args(tab, wins, consts):
    """Checks of :func:`fb_modexp2`; returns (NP, B, k)."""
    NP = tab.shape[0]
    k = consts["sig0"].shape[-1]
    if _num_groups(consts) != 1:
        raise ValueError("fb_modexp2: one residue system expected")
    if wins.ndim != 3 or wins.shape[0] != 1:
        raise ValueError("wins: expected [1, B, NP]")
    B = wins.shape[1]
    _check(wins, "wins", torch.uint8, (1, B, NP))
    W = fb_planes_width(k)
    _check(tab, "tab", _I32, (NP, 2, FB_CHUNKS, W // 4, 32, 2))
    _same_device(tab, ("wins", wins), ("consts", consts["sig0"]))
    return NP, B, k


def fb_modexp2(tab, wins, consts, mont_out=False):
    """K2: base^e with a precomputed table.  tab: the planes of
    :func:`fb_gather_table`, [NP, 2, FB_CHUNKS, W / 4, 32, 2] int32; wins
    [1, B, NP] uint8 exponent bytes, LS byte first.  Returns [1, B, 2k+1]
    int32 residues of a value <= 2N — or, with ``mont_out``, of base^e * M_A
    mod N (<= 3N, Montgomery form).

    Runs the tensor-core kernel on every set of up to :data:`TC_WIDE_MAX_W`
    lanes (:func:`tc_layout`) and raises for any other.  Its gather is the
    reference's one-hot product: every byte of a step's planes is read,
    whatever the exponent bytes (see csrc/fb_modexp2.cu)."""
    with trace.span("kernels.k2"):
        NP, B, k = _fb_modexp2_args(tab, wins, consts)
        if tab.device.type == "cpu":
            return fb_modexp2_plain(tab, wins, consts, mont_out=mont_out)
        _build.need_cuda("fb_modexp2", tab)
        _single_system_pack(consts, "fb_modexp2")
        p = _tc_pack(consts, "fb_modexp2")
        out = torch.empty((1, B, 2 * k + 1), dtype=_I32, device=tab.device)
        with torch.cuda.device(tab.device):
            err = _build.load().fb_modexp2_tc_launch(
                tab.data_ptr(), wins.data_ptr(), p["rowc"].data_ptr(),
                p["T1"].data_ptr(), p["T2"].data_ptr(), p["T1a"].data_ptr(), out.data_ptr(),
                B, NP, int(bool(mont_out)), k, k + 1, p["W"],
                int(p["f32"]), int(p["lean"]), _build.current_stream_ptr(),
            )
        _build.check_launch(err, "fb_modexp2")
        LAUNCHES["fb_modexp2"] += 1
        return out


def _rns_modexp2f_args(base_limbs, windows, consts):
    """Checks of :func:`rns_modexp2f`; returns (B, L, NW, ka, kb)."""
    if "maskB" not in consts:
        raise ValueError("rns_modexp2f needs folded constants")
    B, L = base_limbs.shape
    ka = consts["sig0"].shape[-1]
    kb = consts["modsBx"].shape[-1]
    _check(base_limbs, "base_limbs", _I32, (B, consts["CinA"].shape[-2]))
    NW = windows.shape[-1]
    _check(windows, "windows", _I32, (2, NW))
    _same_device(base_limbs, ("windows", windows), ("consts", consts["sig0"]))
    return B, L, NW, ka, kb


def rns_modexp2f(base_limbs, windows, consts):
    """K3: base^e over the CRT-folded lane layout (fold_group_consts2 with
    ``shared_input=True, f32_mu=True``): the decrypt hot path.

    base_limbs [B, L] int32: one shared limb vector per row (the full
    n^2-width ciphertext; the per-group mod-p^2/q^2 folds ride the Cin
    weights).  windows [2, NW] int32: the groups' shared exponents, MS
    4-bit window first.  Returns [B, 4k+2] int32 residues in folded lane
    order [A_p | A_q | B_p | B_q | mr_p | mr_q].  Runs the tensor-core
    kernel, which covers every folded set (keys up to 2048 bits); its table
    select reads all 16 entries of a row's table whatever the windows of
    p - 1 and q - 1 (see csrc/rns_modexp2f.cu)."""
    with trace.span("kernels.k3"):
        B, L, NW, ka, kb = _rns_modexp2f_args(base_limbs, windows, consts)
        if base_limbs.device.type == "cpu":
            return rns_modexp2f_plain(base_limbs, windows, consts)
        _build.need_cuda("rns_modexp2f", base_limbs)
        p = _tc_pack(consts, "rns_modexp2f")
        if L > KERNEL_MAX_LIN_FOLDED:
            raise NotImplementedError(
                f"{L} input limbs exceed the folded kernel's {KERNEL_MAX_LIN_FOLDED}"
            )
        dev = base_limbs.device
        out = torch.empty((B, ka + kb), dtype=_I32, device=dev)
        # per-row 16-entry power table, 16-bit residues, [B, W, 16] words: too
        # large for shared memory, so it is global scratch that L2 serves
        tab = torch.empty((B, p["W"], _TABLE), dtype=_I32, device=dev)
        with torch.cuda.device(dev):
            err = _build.load().rns_modexp2f_tc_launch(
                base_limbs.data_ptr(), windows.data_ptr(), p["rowc"].data_ptr(),
                p["T1"].data_ptr(), p["T2"].data_ptr(), p["T1a"].data_ptr(),
                p["Cin"].data_ptr(), tab.data_ptr(), out.data_ptr(), B, L, NW, ka, kb, p["W"],
                _build.current_stream_ptr(),
            )
        _build.check_launch(err, "rns_modexp2f")
        if p["halves"] == 2:
            KERNEL_FORMS["rns_modexp2f_tc_split"] += 1
        LAUNCHES["rns_modexp2f"] += 1
        return out


def _rns_modexp2_args(base_limbs, windows, consts, shared):
    """Checks of :func:`rns_modexp2`; returns (G, Gb, B, L, NW, k, kb)."""
    if "maskB" in consts:
        raise ValueError("rns_modexp2 needs stacked (not folded) constants")
    if base_limbs.ndim != 3:
        raise ValueError("base_limbs: expected [G, B, L]")
    G = _num_groups(consts)
    Gb, B, L = base_limbs.shape
    k = consts["sig0"].shape[-1]
    kb = consts["modsBx"].shape[-1]
    if Gb not in (1, G):
        raise ValueError(f"base_limbs: {Gb} groups, the constants have {G}")
    _check(base_limbs, "base_limbs", _I32, (Gb, B, consts["CinA"].shape[-2]))
    NW = windows.shape[-1]
    _check(windows, "windows", _I32, (G, NW) if shared else (G, B, NW))
    _same_device(base_limbs, ("windows", windows), ("consts", consts["sig0"]))
    return G, Gb, B, L, NW, k, kb


def rns_modexp2(base_limbs, windows, consts, shared=False):
    """K5: base^e mod N over a [G, B, L] batch of canonical 15-bit limbs,
    one residue system per group (``stack_group_consts2``, either reduction
    flavor).

    base_limbs [G, B, L] int32 — or [1, B, L] with G > 1 groups of
    constants: every group then reads the same rows (the grouped CRT decrypt
    feeds the full ciphertext to both the p^2 and the q^2 system).
    windows: 4-bit windows, most significant first, int32: [G, NW] when
    ``shared`` (one exponent per group, the same for all rows), else
    [G, B, NW] per row.  Returns [G, B, 2k+1] int32 residues (A | B | m_r
    lanes, B side unscaled) of a value <= 2N.

    Runs the tensor-core kernel, which takes every set of up to
    :data:`TC_WIDE_MAX_W` lanes (:func:`tc_layout`), and raises for any other.
    In every mode its table select reads all 16 entries of a row's table,
    whatever the windows (lambda, p - 1 and q - 1, plaintext scalars,
    obfuscator exponents: see csrc/rns_modexp2.cu)."""
    with trace.span("kernels.k5"):
        G, Gb, B, L, NW, k, kb = _rns_modexp2_args(base_limbs, windows, consts, shared)
        if base_limbs.device.type == "cpu":
            return rns_modexp2_plain(base_limbs, windows, consts, shared=shared)
        _build.need_cuda("rns_modexp2", base_limbs)
        p = _tc_pack(consts, "rns_modexp2")
        if L > KERNEL_MAX_LIN:
            raise NotImplementedError(
                f"{L} input limbs exceed the kernel's {KERNEL_MAX_LIN}"
            )
        dev = base_limbs.device
        out = torch.empty((G, B, k + kb), dtype=_I32, device=dev)
        # per-row 16-entry power table, 16-bit residues, [G, B, W, 16] words:
        # global scratch that L2 serves while it fits
        tab = torch.empty((G, B, p["W"], _TABLE), dtype=_I32, device=dev)
        with torch.cuda.device(dev):
            err = _build.load().rns_modexp2_tc_launch(
                base_limbs.data_ptr(), windows.data_ptr(), p["rowc"].data_ptr(),
                p["T1"].data_ptr(), p["T2"].data_ptr(), p["T1a"].data_ptr(),
                p["Cin"].data_ptr(), tab.data_ptr(), out.data_ptr(), G, B, L, NW, k, kb,
                p["W"], int(p["f32"]), int(p["lean"]), int(bool(shared)), int(Gb == G),
                _build.current_stream_ptr(),
            )
        _build.check_launch(err, "rns_modexp2")
        if p["halves"] == 2:
            KERNEL_FORMS["rns_modexp2_tc_split"] += 1
        LAUNCHES["rns_modexp2"] += 1
        MODEXP2_FORMS["grouped" if G > 1 else "shared" if shared else "var"] += 1
        return out
