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

They share one device function (``csrc/rns_mont_mul.cuh``), whose plain
version is :func:`mont_mul2_plain`.  A wrapper takes the plain version only
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

import numpy as np
import torch

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

#: Limits of the kernels as compiled (csrc/rns_mont_mul.cuh, rns_modexp2f.cu,
#: rns_modexp2.cu).
KERNEL_MAX_THREADS = 320
KERNEL_MAX_LIN = 288
KERNEL_ROWS = 8


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


def _mm_terms(x, Tlo, Thi, c28, c21, ncols, lean):
    """Deferred-reduction base extension: the 2^14-radix fold of x @ T over
    the first ``ncols`` columns, plus the raw (ll, mid, hh) plane sums."""
    xlo = x & DIGIT_MASK
    xhi = x >> DIGIT_BITS
    ll = dot_exact(xlo, Tlo)
    mid = dot_exact(xlo, Thi) + dot_exact(xhi, Tlo)
    hh = dot_exact(xhi, Thi)
    raw = (ll, mid, hh)
    ll, mid, hh = ll[..., :ncols], mid[..., :ncols], hh[..., :ncols]
    if lean:
        t = (
            ll
            + (mid << DIGIT_BITS)
            + ((hh & _MASK14) << MOD_BITS)
            + (hh >> MOD_BITS) * c28
        )
    else:
        t = (
            (hh >> MOD_BITS) * c28
            + ((hh & _MASK14) << MOD_BITS)
            + (mid >> MOD_BITS) * c21
            + ((mid & _MASK14) << DIGIT_BITS)
            + ll
        )
    return t, raw


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


def mont_mul2_plain(c, xA, xB, yA, yB, canonical_out=False):
    """Plain version of the kernels' Montgomery product (``c`` from
    :func:`_plain_consts`; int64 operands [rows, lanes], broadcastable).

    xA [rows, k] A-side residues; xB [rows, kb] SCALED B-side residues
    with the redundant lane(s) last.  Returns (rA, zB) of x*y*M_A^{-1} mod
    N (< 3N).  Works on stacked (one system) and folded (two systems side
    by side) constants, in both reduction flavors."""
    k = c["sig0"].shape[-1]
    folded = "maskB" in c
    f32 = c["muA"].dtype == _F32
    lean = f32 and c["T1lo"].shape[-2] <= 320
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
    tB, (ll, mid, hh) = _mm_terms(
        sigma, c["T1lo"], c["T1hi"], c["c28B"], c["c21B"], kp1, lean
    )
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
    tA, _ = _mm_terms(
        zB[:, :k], c["T2lo"], c["T2hi"], c28A, c21A, c28A.shape[-1], lean
    )
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


def fb_modexp2_plain(tab, wins, consts, mont_out=False):
    """Plain version of :func:`fb_modexp2`."""
    c = _plain_consts(consts)
    k = c["sig0"].shape[-1]
    NP = tab.shape[0]
    w = wins[0].to(_I64)  # [B, NP]
    accA = accB = None
    for i in range(NP):
        sel = tab[i][w[:, i]].to(_I64)  # [B, k + kb]
        if i == 0:
            accA, accB = sel[:, :k], sel[:, k:]
        else:
            accA, accB = mont_mul2_plain(c, accA, accB, sel[:, :k], sel[:, k:])
    if not mont_out:
        pA = torch.ones((1, k), dtype=_I64, device=tab.device)
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


def fb_gather_table(tabA, tabB):
    """Table pair ([1,256,NP,k], [1,256,NP,k+1]) -> the gather layout of
    :func:`fb_modexp2`: one int32 word per residue, [NP, 256, 2k+1] with
    the A lanes first.  (The reference splits into int8 lo/hi planes for a
    one-hot matrix product; an indexed load needs neither.)"""
    return torch.cat([tabA[0], tabB[0]], dim=-1).transpose(0, 1).contiguous()


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


def _pack_planes(Tlo, Thi, W):
    """int8 planes [k, cols] -> int32 [ceil(k/4), W, 2]: four contraction
    rows per word (row 4*i4 + e in byte e), lo and hi interleaved."""
    k, cols = Tlo.shape
    k4 = -(-k // 4)
    out = torch.zeros((k4 * 4, W, 2), dtype=torch.int8, device=Tlo.device)
    out[:k, :cols, 0] = Tlo
    out[:k, :cols, 1] = Thi
    # [k4, 4, W, 2] -> [k4, W, 2, 4] bytes -> int32 (little-endian)
    out = out.view(k4, 4, W, 2).permute(0, 2, 3, 1).contiguous()
    return out.view(_I32).reshape(k4, W, 2)


def _pack_group(c, folded, f32, k, kb, W):
    """Device-side form of ONE group ``c`` (leading axis dropped) of a
    constant set: (rowc [NROWS, W], T1, T2 [k4, W, 2], Cin [L, W, 2])."""
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
    return (
        rowc,
        _pack_planes(c["T1lo"], c["T1hi"], W),
        _pack_planes(c["T2lo"], c["T2hi"], W),
        cin,
    )


def _kernel_pack(consts):
    """The device-side form of a constant set, built once and cached in the
    dict: per group the per-lane row table, the packed weight planes and the
    interleaved Cin weights, stacked on a leading group axis ([G, ...]; a
    folded set is one group whose lanes hold two residue systems).  Raises
    for sets the compiled kernels do not cover."""
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
    if f32 and consts["T1lo"].shape[-2] > KERNEL_MAX_THREADS:
        raise NotImplementedError(
            "the f32 non-lean fold (contractions beyond "
            f"{KERNEL_MAX_THREADS} lanes) is not compiled: keys wider than "
            "2048 bits are not ported yet (ROADMAP Queue 1, wide keys)"
        )
    W = -(-max(kb + lane_systems, k + lane_systems) // 32) * 32
    if W > KERNEL_MAX_THREADS:
        raise NotImplementedError(
            f"{W} lanes exceed the kernels' {KERNEL_MAX_THREADS}: keys wider "
            "than 2048 bits are not ported yet (ROADMAP Queue 1, wide keys)"
        )
    groups = [
        _pack_group(
            {key: v[g] for key, v in consts.items() if isinstance(v, torch.Tensor)},
            folded, f32, k, kb, W,
        )
        for g in range(G)
    ]
    rowc, T1, T2, cin = (torch.stack(t).contiguous() for t in zip(*groups))
    pack = dict(k=k, kb=kb, W=W, G=G, f32=f32, rowc=rowc, T1=T1, T2=T2, Cin=cin)
    consts["_pack"] = pack
    return pack


def _single_system_pack(consts, name):
    """:func:`_kernel_pack` for the fixed-base kernels: one integer-Barrett
    residue system."""
    p = _kernel_pack(consts)
    if p["f32"] or p["G"] != 1 or "maskB" in consts:
        raise NotImplementedError(
            f"{name} runs one residue system in the integer-Barrett flavor"
        )
    return p


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


def fb_table2(gA, gB, consts):
    """K1: fixed-base table from Montgomery-form g_i = base^(2^(8 i)):
    gA [1, NP, k], gB [1, NP, k+1] (scaled B side) int32 ->
    ([1, 256, NP, k], [1, 256, NP, k+1]) int32, entry j of row i being
    g_i^j in Montgomery form with canonical residues."""
    G, NP, k = gA.shape
    _check(gA, "gA", _I32)
    _check(gB, "gB", _I32, (G, NP, k + 1))
    _same_device(gA, ("gB", gB), ("consts", consts["sig0"]))
    if G != 1 or _num_groups(consts) != 1 or consts["sig0"].shape[-1] != k:
        raise ValueError("fb_table2: one residue system matching consts expected")
    if gA.device.type == "cpu":
        return fb_table2_plain(gA, gB, consts)
    p = _single_system_pack(consts, "fb_table2")
    tabA = torch.empty((1, FB_TABLE, NP, k), dtype=_I32, device=gA.device)
    tabB = torch.empty((1, FB_TABLE, NP, k + 1), dtype=_I32, device=gA.device)
    lib = _build.load()
    with torch.cuda.device(gA.device):
        err = lib.fb_table2_launch(
            gA.data_ptr(), gB.data_ptr(), p["rowc"].data_ptr(),
            p["T1"].data_ptr(), p["T2"].data_ptr(), tabA.data_ptr(),
            tabB.data_ptr(), NP, FB_TABLE, k, k + 1, p["W"],
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "fb_table2")
    LAUNCHES["fb_table2"] += 1
    return tabA, tabB


def fb_modexp2(tab, wins, consts, mont_out=False):
    """K2: base^e with a precomputed table.  tab [NP, 256, 2k+1] int32
    (:func:`fb_gather_table`); wins [1, B, NP] uint8 exponent bytes, LS byte
    first.  Returns [1, B, 2k+1] int32 residues of a value <= 2N — or, with
    ``mont_out``, of base^e * M_A mod N (<= 3N, Montgomery form).

    The table row read for a byte is addressed by that byte, which is
    secret on the encrypt path (see csrc/fb_modexp2.cu)."""
    NP, T, Wt = tab.shape
    k = consts["sig0"].shape[-1]
    if _num_groups(consts) != 1:
        raise ValueError("fb_modexp2: one residue system expected")
    _check(tab, "tab", _I32, (NP, FB_TABLE, 2 * k + 1))
    if wins.ndim != 3 or wins.shape[0] != 1:
        raise ValueError("wins: expected [1, B, NP]")
    B = wins.shape[1]
    _check(wins, "wins", torch.uint8, (1, B, NP))
    _same_device(tab, ("wins", wins), ("consts", consts["sig0"]))
    if tab.device.type == "cpu":
        return fb_modexp2_plain(tab, wins, consts, mont_out=mont_out)
    p = _single_system_pack(consts, "fb_modexp2")
    out = torch.empty((1, B, Wt), dtype=_I32, device=tab.device)
    lib = _build.load()
    with torch.cuda.device(tab.device):
        err = lib.fb_modexp2_launch(
            tab.data_ptr(), wins.data_ptr(), p["rowc"].data_ptr(),
            p["T1"].data_ptr(), p["T2"].data_ptr(), out.data_ptr(),
            B, NP, int(bool(mont_out)), k, k + 1, p["W"],
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "fb_modexp2")
    LAUNCHES["fb_modexp2"] += 1
    return out


def rns_modexp2f(base_limbs, windows, consts):
    """K3: base^e over the CRT-folded lane layout (fold_group_consts2 with
    ``shared_input=True, f32_mu=True``): the decrypt hot path.

    base_limbs [B, L] int32: one shared limb vector per row (the full
    n^2-width ciphertext; the per-group mod-p^2/q^2 folds ride the Cin
    weights).  windows [2, NW] int32: the groups' shared exponents, MS
    4-bit window first.  Returns [B, 4k+2] int32 residues in folded lane
    order [A_p | A_q | B_p | B_q | mr_p | mr_q]."""
    if "maskB" not in consts:
        raise ValueError("rns_modexp2f needs folded constants")
    B, L = base_limbs.shape
    ka = consts["sig0"].shape[-1]
    kb = consts["modsBx"].shape[-1]
    _check(base_limbs, "base_limbs", _I32, (B, consts["CinA"].shape[-2]))
    NW = windows.shape[-1]
    _check(windows, "windows", _I32, (2, NW))
    _same_device(base_limbs, ("windows", windows), ("consts", consts["sig0"]))
    if base_limbs.device.type == "cpu":
        return rns_modexp2f_plain(base_limbs, windows, consts)
    p = _kernel_pack(consts)
    if L > KERNEL_MAX_LIN:
        raise NotImplementedError(
            f"{L} input limbs exceed the kernel's {KERNEL_MAX_LIN} "
            "(ROADMAP Queue 1, wide keys)"
        )
    dev = base_limbs.device
    out = torch.empty((B, ka + kb), dtype=_I32, device=dev)
    # per-row 16-entry power table: too large for shared memory, so it is
    # global scratch that L2 serves
    tab = torch.empty((B, _TABLE, 2, p["W"]), dtype=_I32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.rns_modexp2f_launch(
            base_limbs.data_ptr(), windows.data_ptr(), p["rowc"].data_ptr(),
            p["T1"].data_ptr(), p["T2"].data_ptr(), p["Cin"].data_ptr(),
            tab.data_ptr(), out.data_ptr(), B, L, NW, ka, kb, p["W"],
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "rns_modexp2f")
    LAUNCHES["rns_modexp2f"] += 1
    return out


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

    With per-row windows the table entry a row reads is addressed by that
    row's window (see csrc/rns_modexp2.cu)."""
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
    if base_limbs.device.type == "cpu":
        return rns_modexp2_plain(base_limbs, windows, consts, shared=shared)
    p = _kernel_pack(consts)
    if L > KERNEL_MAX_LIN:
        raise NotImplementedError(
            f"{L} input limbs exceed the kernel's {KERNEL_MAX_LIN} "
            "(ROADMAP Queue 1, wide keys)"
        )
    dev = base_limbs.device
    out = torch.empty((G, B, k + kb), dtype=_I32, device=dev)
    # per-row 16-entry power table: global scratch that L2 serves
    tab = torch.empty((G, B, _TABLE, 2, p["W"]), dtype=_I32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.rns_modexp2_launch(
            base_limbs.data_ptr(), windows.data_ptr(), p["rowc"].data_ptr(),
            p["T1"].data_ptr(), p["T2"].data_ptr(), p["Cin"].data_ptr(),
            tab.data_ptr(), out.data_ptr(), G, B, L, NW, k, kb, p["W"],
            int(p["f32"]), int(bool(shared)), int(Gb == G),
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "rns_modexp2")
    LAUNCHES["rns_modexp2"] += 1
    MODEXP2_FORMS["grouped" if G > 1 else "shared" if shared else "var"] += 1
    return out
