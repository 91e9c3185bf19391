"""RNS (residue number system) Montgomery arithmetic — host constants and
the plain PyTorch device math.

Counterpart of the JAX package's ``ops/rns.py``.  Algorithm:
Bajard-Imbert RNS Montgomery multiplication over two bases of 14-bit
primes A, B (k moduli each) plus one redundant modulus m_r; a value
x < 3N is a [batch, 2k+1] tensor of residues.  The host half
(:class:`RNSContext`) is the same code as the reference's and yields
bit-identical constants; the kernels of ops/cuda_rns2.py derive theirs
from it.

The device half here (``rns_mont_mul``, ``rns_mont_exp``, ``limbs_to_rns``,
``rns_to_limbs``) is the math the reference leaves to XLA outside its
kernels: plain tensor code whose matrix products go through
:func:`ops.bigint.dot_exact` (float32 products of 7-bit digit planes,
exact).  Tensors at function boundaries are ``int32``; the arithmetic
runs in ``int64``.  The f32-reciprocal constants travel as ``float32``
tensors and ``barrett_reduce`` dispatches on that dtype, as the
reference does.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import trace
from .bigint import _sub_borrow64, dot_exact
from .limbs import LIMB_BITS, WINDOW_BITS, int_to_limbs
from .montgomery import _canonicalize64, _shift_in_zero

_I64 = torch.int64
_I32 = torch.int32
_F32 = torch.float32

MOD_BITS = 14  # moduli are primes < 2^14 (pool spans (2^12, 2^14))
DIGIT_BITS = 7  # matmul operands split into 7-bit digits (exact in bf16)
DIGIT_MASK = (1 << DIGIT_BITS) - 1
GUARD_FACTOR = 9  # M_A, M_B >= GUARD_FACTOR * N  (supports the < 3N invariant)
ALPHA_MARGIN = 1.0 / 16.0  # Kawamura floor-estimate safety offset

#: Pool floor.  create() allocates largest-first, so a context only
#: reaches below 2^13 for very wide moduli (>= ~5.9k bits — 3072/4096-bit
#: keys' n^2; the reference's own QAT envelope reaches 8192-bit operands,
#: module/heqat/include/heqat/bnops.h:16-20).  Such "wide-pool" contexts
#: REQUIRE the f32-reciprocal kernel reduction (is_wide_pool /
#: ops/cuda_rns2.red_mu): the integer-Barrett quotient-error bound
#: v/2^28 + 2^14/m + 2 outgrows the 4m/2m/m conditional-subtract chain
#: once m < 2^13, while the f32 flavor's {0,1} error holds for any
#: m > 2^12.
POOL_MIN_BITS = 12


def _sieve_primes(lo: int, hi: int):
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return [int(p) for p in np.nonzero(sieve)[0] if p >= lo]


@functools.lru_cache(maxsize=None)
def _prime_pool():
    return _sieve_primes((1 << POOL_MIN_BITS) + 1, 1 << MOD_BITS)


def is_wide_pool(ctx: "RNSContext") -> bool:
    """Whether ``ctx`` allocated any modulus below 2^13 (see POOL_MIN_BITS:
    these contexts must run the f32-reciprocal reduction flavor)."""
    return int(ctx.mods.min()) < (1 << 13)


def _barrett_consts(ms: np.ndarray) -> np.ndarray:
    """floor(2^28 / m) for each modulus (fits 16 bits)."""
    return (np.uint64(1 << 28) // ms.astype(np.uint64)).astype(np.uint32)


def inv_f32(mods: np.ndarray) -> np.ndarray:
    """f32 reciprocal reduction constants (1 - 2^-20)/m: the truncated
    quotient q = i32(f32(v) * mu) is in {q_true-1, q_true} for v < 2^31
    and any m > 2^12 (the 2^-20 downward bias dominates the rounding
    errors), so ONE conditional subtract canonicalizes."""
    return ((1.0 - 2.0**-20) / np.asarray(mods, np.float64)).astype(
        np.float32
    )


def _alloc_bases(nbits: int, product_bits: Optional[int] = None):
    """Greedy largest-first base allocation: (M_A, A, M_B, B, m_r).

    The ONE allocator behind both :meth:`RNSContext.create` and the
    width gate (:func:`rns_supported`), so the two cannot drift.  The
    base-product target is QUANTIZED to a 16-bit grid: with the raw
    target 9*N, the moduli count k — and with it every kernel shape — would flip at prime-count boundaries
    depending on the key's exact magnitude, so two same-bit-size keys
    would get different kernel shapes.  Rounding ceil(log2(9N)) <=
    nbits+4 up to a multiple of 16 makes k a function of the key's size
    class only, at a cost of at most one extra modulus.  Raises
    ValueError when the pool cannot serve the width."""
    pool = sorted(_prime_pool(), reverse=True)
    tbits = -(-(nbits + GUARD_FACTOR.bit_length()) // 16) * 16
    target = 1 << tbits
    if product_bits is not None:
        target = max(target, 1 << product_bits)

    def take(start):
        prod, chosen, i = 1, [], start
        while prod < target:
            if i >= len(pool):
                raise ValueError("prime pool exhausted; modulus too large")
            prod *= pool[i]
            chosen.append(pool[i])
            i += 1
        return prod, chosen, i

    MA, A, i1 = take(0)
    MB, Bb, i2 = take(i1)
    # pad the smaller base so both have k moduli (+1 prime for m_r)
    if i2 + abs(len(A) - len(Bb)) >= len(pool):
        raise ValueError("prime pool exhausted; modulus too large")
    while len(A) < len(Bb):
        MA *= pool[i2]
        A.append(pool[i2])
        i2 += 1
    while len(Bb) < len(A):
        MB *= pool[i2]
        Bb.append(pool[i2])
        i2 += 1
    mr = pool[i2]
    if len(A) >= mr:
        raise ValueError("alpha' must fit the redundant modulus")
    return MA, A, MB, Bb, mr


def _pool_can_serve(nbits: int) -> bool:
    """Whether :meth:`RNSContext.create` would succeed for an ``nbits``
    modulus (runs the exact shared allocator)."""
    try:
        _alloc_bases(nbits)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def rns_max_modulus_bits() -> int:
    """Largest modulus bit-width the prime pool can serve.

    Found by bisection over :func:`_pool_can_serve` (the exact
    simulation of create()'s allocator).  Above this the engines fall
    back to the width-generic CIOS kernel backend
    (models/engine._width_backend)."""
    lo, hi = 16, 1 << 16
    while lo < hi:  # invariant: serve(lo) true, serve(hi) false
        mid = (lo + hi + 1) // 2
        if _pool_can_serve(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def rns_supported(nbits: int) -> bool:
    """Whether the RNS backend can represent an ``nbits`` modulus."""
    return nbits <= rns_max_modulus_bits()


@dataclass(frozen=True)
class RNSContext:
    """Host-side constants for RNS Montgomery arithmetic modulo N."""

    N: int
    k: int  # moduli per base
    K: int  # total residues = 2k + 1
    MA: int
    MB: int
    mr: int
    # device constant arrays (numpy; device_consts() makes the tensors)
    mods: np.ndarray  # [K] all moduli: A | B | m_r
    barrett: np.ndarray  # [K] floor(2^28/m)
    neg_Ninv_A: np.ndarray  # [k]   -N^{-1} mod a_i
    MAi_inv_A: np.ndarray  # [k]   (M_A/a_i)^{-1} mod a_i
    sigma_c_A: np.ndarray  # [k]   (-N^{-1} * (M_A/a_i)^{-1}) mod a_i (fused)
    T1ext: np.ndarray  # [k+1, k+1] T1 plus a last row of (-M_A) mod (b_j|m_r)
    inv_a_f32: np.ndarray  # [k]   1/a_i as f32 (Kawamura)
    T1: np.ndarray  # [k, k+1]  (M_A/a_i) mod (b_j | m_r)
    MA_mod_B: np.ndarray  # [k+1] M_A mod (b_j | m_r)
    N_B: np.ndarray  # [k+1] N mod (b_j | m_r)
    MAinv_B: np.ndarray  # [k+1] M_A^{-1} mod (b_j | m_r)
    MBj_inv_B: np.ndarray  # [k]   (M_B/b_j)^{-1} mod b_j
    T2: np.ndarray  # [k, k]  (M_B/b_j) mod a_i
    T2r: np.ndarray  # [k]    (M_B/b_j) mod m_r
    MBinv_mr: int  # M_B^{-1} mod m_r
    MB_mod_A: np.ndarray  # [k]   M_B mod a_i
    # conversions
    Cin: np.ndarray  # [L, K] 2^(15*l) mod m  (standard limbs -> residues)
    Aout_limbs: np.ndarray  # [k, Lout] limbs of M_A/a_i (RNS -> integer)
    MA_limbs: np.ndarray  # [Lout] limbs of M_A
    Lin: int
    Lout: int
    # Montgomery domain constants, as residue vectors [K]
    mont_sq: np.ndarray  # M_A^2 mod N
    mont_one: np.ndarray  # M_A mod N
    plain_one: np.ndarray  # 1

    @classmethod
    def create(
        cls,
        N: int,
        in_limbs: Optional[int] = None,
        product_bits: Optional[int] = None,
    ) -> "RNSContext":
        """``product_bits`` forces the base product above 2**product_bits so
        two same-size moduli (CRT's p^2 and q^2) get identical prime bases
        and hence stackable constant shapes for the grouped kernel."""
        with trace.span("engine.rns_context"):
            return cls._create(N, in_limbs, product_bits)

    @classmethod
    def _create(cls, N: int, in_limbs: Optional[int], product_bits: Optional[int]):
        if N <= 0 or N % 2 == 0:
            raise ValueError("RNS modulus must be positive and odd")
        nbits = N.bit_length()
        # the ONE shared allocator (also behind rns_supported's gate):
        # greedy largest-first with the quantized target — see there
        MA, A, MB, Bb, mr = _alloc_bases(nbits, product_bits)
        k = len(A)
        assert k == len(Bb)

        A_np = np.array(A, np.uint32)
        B_np = np.array(Bb, np.uint32)
        Bx = Bb + [mr]  # extension targets of base A
        Bx_np = np.array(Bx, np.uint32)

        MAi = [MA // a for a in A]
        MBj = [MB // b for b in Bb]

        Lin = in_limbs if in_limbs is not None else -(-nbits // LIMB_BITS)
        Lout = -(-(MA.bit_length() + k.bit_length() + 1) // LIMB_BITS) + 1

        mods = np.concatenate([A_np, B_np, np.array([mr], np.uint32)])
        ctx = cls(
            N=N,
            k=k,
            K=2 * k + 1,
            MA=MA,
            MB=MB,
            mr=mr,
            mods=mods,
            barrett=_barrett_consts(mods),
            neg_Ninv_A=np.array([(-pow(N, -1, a)) % a for a in A], np.uint32),
            MAi_inv_A=np.array(
                [pow(MAi[i] % A[i], -1, A[i]) for i in range(k)], np.uint32
            ),
            sigma_c_A=np.array(
                [
                    (-pow(N, -1, a) * pow(MAi[i] % a, -1, a)) % a
                    for i, a in enumerate(A)
                ],
                np.uint32,
            ),
            T1ext=np.array(
                [[MAi[i] % m for m in Bx] for i in range(k)]
                + [[(-MA) % m for m in Bx]],
                np.uint32,
            ),
            inv_a_f32=(1.0 / A_np.astype(np.float64)).astype(np.float32),
            T1=np.array(
                [[MAi[i] % m for m in Bx] for i in range(k)], np.uint32
            ),
            MA_mod_B=np.array([MA % m for m in Bx], np.uint32),
            N_B=np.array([N % m for m in Bx], np.uint32),
            MAinv_B=np.array([pow(MA % m, -1, m) for m in Bx], np.uint32),
            MBj_inv_B=np.array(
                [pow(MBj[j] % Bb[j], -1, Bb[j]) for j in range(k)], np.uint32
            ),
            T2=np.array([[MBj[j] % a for a in A] for j in range(k)], np.uint32),
            T2r=np.array([MBj[j] % mr for j in range(k)], np.uint32),
            MBinv_mr=int(pow(MB % mr, -1, mr)),
            MB_mod_A=np.array([MB % a for a in A], np.uint32),
            # Limb weights are taken mod N first: row l converts limb l
            # with weight (2^(15 l) mod N) mod m.  For limbs below N's
            # width this equals 2^(15 l) mod m exactly; rows ABOVE N's
            # width implicitly reduce the represented value mod N, so a
            # caller may feed limbs WIDER than N (e.g. CRT decrypt feeds
            # the full n^2-width ciphertext into the p^2/q^2 systems and
            # the "ct mod p^2" fold happens inside this one conversion
            # matmul).  The represented value V satisfies V ≡ x (mod N),
            # V <= x, and V < Lin * 2^15 * N — create() callers size
            # product_bits so M_A comfortably exceeds that bound.
            Cin=np.array(
                [
                    [pow(2, LIMB_BITS * l, N) % int(m) for m in mods]
                    for l in range(Lin)
                ],
                np.uint32,
            ),
            Aout_limbs=np.stack(
                [int_to_limbs(MAi[i], Lout) for i in range(k)]
            ),
            MA_limbs=int_to_limbs(MA, Lout),
            Lin=Lin,
            Lout=Lout,
            mont_sq=cls._to_residues(MA * MA % N, mods),
            mont_one=cls._to_residues(MA % N, mods),
            plain_one=cls._to_residues(1, mods),
        )
        return ctx

    @staticmethod
    def _to_residues(x: int, mods: np.ndarray) -> np.ndarray:
        return np.array([x % int(m) for m in mods], np.uint32)

    def to_residues(self, x: int) -> np.ndarray:
        return self._to_residues(x, self.mods)

    def device_consts(self, device) -> dict:
        """All constants as tensors on ``device`` (int32; the reduction
        constants are float32 for wide-pool contexts, which must run the
        f32-reciprocal flavor — barrett_reduce dispatches on the dtype)."""
        def f(a):
            a = np.asarray(a)
            if a.dtype == np.float32:
                return torch.from_numpy(a.copy()).to(device)
            return torch.from_numpy(a.astype(np.int32)).to(device)

        return dict(
            mods=f(self.mods),
            barrett=f(
                inv_f32(self.mods) if is_wide_pool(self) else self.barrett
            ),
            neg_Ninv_A=f(self.neg_Ninv_A),
            MAi_inv_A=f(self.MAi_inv_A),
            inv_a_f32=f(self.inv_a_f32),
            T1=f(self.T1),
            sigma_c_A=f(self.sigma_c_A),
            T1ext=f(self.T1ext),
            MA_mod_B=f(self.MA_mod_B),
            N_B=f(self.N_B),
            MAinv_B=f(self.MAinv_B),
            MBj_inv_B=f(self.MBj_inv_B),
            T2=f(self.T2),
            T2r=f(self.T2r),
            MBinv_mr=f(np.uint32(self.MBinv_mr)),
            MB_mod_A=f(self.MB_mod_A),
            Cin=f(self.Cin),
            Aout_limbs=f(self.Aout_limbs),
            MA_limbs=f(self.MA_limbs),
            mont_sq=f(self.mont_sq),
            mont_one=f(self.mont_one),
            plain_one=f(self.plain_one),
        )


# ---------------------------------------------------------------------------
# stage primitives (int64 inside; the underscore forms take and return
# int64, the public forms int32)
# ---------------------------------------------------------------------------


def _barrett64(v, m, mu):
    if mu.dtype == _F32:
        q = (v.to(_F32) * mu).to(_I64)
        r = v - q * m
        return torch.where(r >= m, r - m, r)
    q = ((v >> MOD_BITS) * mu) >> MOD_BITS
    r = v - q * m
    r = torch.where(r >= 4 * m, r - 4 * m, r)
    r = torch.where(r >= 2 * m, r - 2 * m, r)
    r = torch.where(r >= m, r - m, r)
    return r


def _mu64(mu):
    return mu if mu.dtype == _F32 else mu.to(_I64)


def barrett_reduce(v, m, mu):
    """v mod m, dispatched on ``mu``'s dtype:

    * integer ``mu`` = floor(2^28/m): integer Barrett for v < 2^30 and
      m in (2^13, 2^14); quotient error < 7, so the 4m/2m/m
      conditional-subtract chain canonicalizes.
    * float32 ``mu`` = (1 - 2^-20)/m (:func:`inv_f32`): reciprocal flavor
      (v < 2^31, any m > 2^12): int -> f32 round-to-nearest, one multiply,
      truncate, ONE conditional subtract.
    """
    return _barrett64(v.to(_I64), m.to(_I64), _mu64(mu)).to(_I32)


def _mulmod64(x, y, m, mu):
    return _barrett64(x * y, m, mu)


def mulmod(x, y, m, mu):
    """(x*y) mod m for x, y < 2^14."""
    return _mulmod64(x.to(_I64), y.to(_I64), m.to(_I64), _mu64(mu)).to(_I32)


def _digit_split(x):
    return x & DIGIT_MASK, x >> DIGIT_BITS


def _exact_matmul64(x, T):
    xlo, xhi = _digit_split(x)
    Tlo, Thi = _digit_split(T)
    s_ll = dot_exact(xlo, Tlo)
    mid = dot_exact(xlo, Thi) + dot_exact(xhi, Tlo)
    s_hh = dot_exact(xhi, Thi)
    return s_ll + (mid << DIGIT_BITS) + (s_hh << (2 * DIGIT_BITS))


def exact_matmul(x, T):
    """Exact integer product x @ T for x [B, k] < 2^14, T [k, J] < 2^14
    (NOT reduced; < 2^28 + 2^22, returned as int64)."""
    return _exact_matmul64(x.to(_I64), T.to(_I64))


def _matmul_mod64(x, T, m, mu):
    xlo, xhi = _digit_split(x)
    Tlo, Thi = _digit_split(T)
    s_ll = dot_exact(xlo, Tlo)
    mid = dot_exact(xlo, Thi) + dot_exact(xhi, Tlo)
    s_hh = dot_exact(xhi, Thi)
    t = _barrett64((s_hh << DIGIT_BITS) + mid, m, mu)
    return _barrett64((t << DIGIT_BITS) + s_ll, m, mu)


def matmul_mod(x, T, m, mu):
    """(x @ T) mod m, columnwise moduli m [J], exactly."""
    return _matmul_mod64(
        x.to(_I64), T.to(_I64), m.to(_I64), _mu64(mu)
    ).to(_I32)


def _consts64(c):
    """The constant dict with integer tensors widened to int64."""
    return {
        key: (v if v.dtype == _F32 else v.to(_I64)) for key, v in c.items()
    }


def _rns_mont_mul64(x, y, c):
    k = c["T1"].shape[0]
    mods, mu = c["mods"], c["barrett"]
    mA, muA = mods[:k], mu[:k]
    mBx, muBx = mods[k:], mu[k:]

    s = _mulmod64(x, y, mods, mu)  # [B, K]
    s_A, s_Bx = s[..., :k], s[..., k:]
    sigma = _mulmod64(s_A, c["sigma_c_A"], mA, muA)  # [B, k]

    # Kawamura alpha estimate (may undershoot by exactly 1, never overshoot)
    frac = torch.sum(sigma.to(_F32) * c["inv_a_f32"], dim=-1)
    alpha = torch.clamp(torch.floor(frac - ALPHA_MARGIN), min=0.0).to(_I64)

    x_ext = torch.cat([sigma, alpha[..., None]], dim=-1)  # [B, k+1]
    q_hat = _matmul_mod64(x_ext, c["T1ext"], mBx, muBx)  # [B, k+1]

    t = _barrett64(s_Bx + q_hat * c["N_B"], mBx, muBx)
    r_Bx = _mulmod64(t, c["MAinv_B"], mBx, muBx)  # [B, k+1]
    r_B, r_mr = r_Bx[..., :k], r_Bx[..., k]

    mB, muB = mods[k : 2 * k], mu[k : 2 * k]
    m_r, mu_r = mods[2 * k], mu[2 * k]
    sigma2 = _mulmod64(r_B, c["MBj_inv_B"], mB, muB)  # [B, k]
    ext_r = _matmul_mod64(sigma2, c["T2r"][:, None], m_r, mu_r)[..., 0]
    diff = torch.where(ext_r >= r_mr, ext_r - r_mr, ext_r + m_r - r_mr)
    alpha2 = _mulmod64(diff, c["MBinv_mr"], m_r, mu_r)  # [B], exact alpha'
    ext_A = _matmul_mod64(sigma2, c["T2"], mA, muA)  # [B, k]
    corr_A = _mulmod64(alpha2[..., None], c["MB_mod_A"], mA, muA)
    r_A = torch.where(ext_A >= corr_A, ext_A - corr_A, ext_A + mA - corr_A)
    return torch.cat([r_A, r_Bx], dim=-1)  # [B, K]


def rns_mont_mul(x, y, c):
    """One RNS Montgomery multiply: x, y [B, K] residues of values < 3N;
    returns residues of x*y*M_A^{-1} mod N (a representative < 3N).
    ``c`` is the dict from RNSContext.device_consts().

    Note the float sum of the alpha estimate runs over k terms in the
    library's summation order; the estimate's one-sided margin makes the
    REPRESENTED value independent of that order only up to the documented
    +M_A*N slack, so callers compare canonical limbs after finalize, not
    these residues, across implementations."""
    return _rns_mont_mul64(x.to(_I64), y.to(_I64), _consts64(c)).to(_I32)


def _limbs_to_rns64(x, c):
    mods, mu = c["mods"], c["barrett"]
    Cin = c["Cin"]  # [L, K]
    d0 = x & DIGIT_MASK
    d1 = (x >> DIGIT_BITS) & DIGIT_MASK
    d2 = x >> (2 * DIGIT_BITS)  # 1 bit (2 for the redundant digit 2**15)
    Tlo, Thi = _digit_split(Cin)
    acc = torch.zeros(x.shape[:-1] + (Cin.shape[1],), dtype=_I64, device=x.device)
    for shift, d in ((0, d0), (DIGIT_BITS, d1), (2 * DIGIT_BITS, d2)):
        lo = dot_exact(d, Tlo)
        hi = dot_exact(d, Thi)
        v = _barrett64((hi << DIGIT_BITS) + lo, mods, mu)  # < m
        acc = _barrett64(acc + (v << shift), mods, mu)
    return acc


def limbs_to_rns(x, c):
    """Standard 15-bit limbs [B, L] -> residues [B, K] (exact)."""
    return _limbs_to_rns64(x.to(_I64), _consts64(c)).to(_I32)


def _rns_to_limbs64(x_rns, c):
    k = c["T1"].shape[0]
    mods, mu = c["mods"], c["barrett"]
    mA, muA = mods[:k], mu[:k]
    m_r, mu_r = mods[2 * k], mu[2 * k]

    x_A = x_rns[..., :k]
    x_mr = x_rns[..., 2 * k]
    sigma = _mulmod64(x_A, c["MAi_inv_A"], mA, muA)  # [B, k]

    # exact alpha via m_r:  alpha = (sum sigma_i*(M_A/a_i) - x) / M_A mod m_r
    ext_r = _matmul_mod64(sigma, c["T1"][:, -1:], m_r, mu_r)[..., 0]
    diff = torch.where(ext_r >= x_mr, ext_r - x_mr, ext_r + m_r - x_mr)
    MAinv_mr = c["MAinv_B"][-1]
    alpha = _mulmod64(diff, MAinv_mr, m_r, mu_r)  # [B] < k

    # T = sum_i sigma_i * limbs(M_A/a_i) via digit planes, accumulated into
    # limb columns and carry-resolved
    slo, shi = _digit_split(sigma)
    A_l = c["Aout_limbs"]  # [k, Lout] limbs < 2^15
    Llo = A_l & DIGIT_MASK
    Lmid = (A_l >> DIGIT_BITS) & DIGIT_MASK
    Lhi = A_l >> (2 * DIGIT_BITS)
    acc = None
    for shift_s, sd in ((0, slo), (DIGIT_BITS, shi)):
        for shift_l, Ld in ((0, Llo), (DIGIT_BITS, Lmid), (2 * DIGIT_BITS, Lhi)):
            p = dot_exact(sd, Ld)
            col, s = divmod(shift_s + shift_l, LIMB_BITS)
            lo_part = (p & ((1 << (LIMB_BITS - s)) - 1)) << s
            hi_part = p >> (LIMB_BITS - s)
            term = _shift_in_zero(lo_part, col) + _shift_in_zero(hi_part, col + 1)
            acc = term if acc is None else acc + term
    big = _canonicalize64(acc)  # [B, Lout] canonical limbs of sum sigma*MAi

    # subtract alpha * M_A  (alpha < k <= 2^13: one scalar-x-vector product)
    prod = alpha[..., None] * c["MA_limbs"]  # < 2^28
    lo = prod & ((1 << LIMB_BITS) - 1)
    hi = prod >> LIMB_BITS
    sub = _canonicalize64(lo + _shift_in_zero(hi))
    diff_l, _ = _sub_borrow64(big, sub)
    return diff_l  # borrow is zero: value >= 0


def rns_to_limbs(x_rns, c):
    """Residues [B, K] -> canonical 15-bit limbs [B, Lout] of the exact
    value (< 3N; callers conditionally subtract N afterwards)."""
    return _rns_to_limbs64(x_rns.to(_I64), _consts64(c)).to(_I32)


# ---------------------------------------------------------------------------
# windowed exponentiation (plain torch, the reference's XLA path)
# ---------------------------------------------------------------------------


def rns_mont_exp(x_rns, windows, c):
    """x^e via fixed 4-bit windows, all in RNS.

    x_rns: [B, K] residues of x < N; windows [B, NW] or [1, NW] (most
    significant window first, :func:`~.limbs.ints_to_windows`).  Returns
    residues of a representative of x^e mod N, value < 2N.  Montgomery
    entry by ``mont_sq``, a table of x^0..x^15 (Montgomery form) built by 15
    products, four squarings and one product a window, exit by a product
    with ``plain_one``.  A window picks its table entry by the one-hot sum
    over all 16 entries: no index or address is taken from it."""
    cc = _consts64(c)
    x = x_rns.to(_I64)
    B, K = x.shape
    nw = windows.shape[-1]
    wins = windows.to(_I64).expand(B, nw)
    a = _rns_mont_mul64(x, cc["mont_sq"][None, :], cc)  # to Montgomery form
    one = cc["mont_one"][None, :].expand(B, K)
    entries = [one]
    for _ in range((1 << WINDOW_BITS) - 1):
        entries.append(_rns_mont_mul64(entries[-1], a, cc))
    table = torch.stack(entries)  # [16, B, K]
    digits = torch.arange(1 << WINDOW_BITS, dtype=_I64, device=x.device)[:, None]
    acc = one
    for i in range(nw):
        for _ in range(WINDOW_BITS):
            acc = _rns_mont_mul64(acc, acc, cc)
        onehot = (wins[None, :, i] == digits).to(_I64)  # [16, B]
        sel = torch.sum(table * onehot[..., None], dim=0)
        acc = _rns_mont_mul64(acc, sel, cc)
    # leave the Montgomery domain: value < 3N/M_A + 2N, so < 2N + 1
    return _rns_mont_mul64(acc, cc["plain_one"][None, :], cc).to(_I32)
