"""Batched fixed-limb big-integer helper ops (non-modexp paths).

Counterpart of the JAX package's ``ops/bigint.py`` for the operations the
ported paths use: ``mul_shared`` (n*m+1 embedding and the CRT recombine
u*p), ``mul_low`` (Hensel exact division of the L-function), the
borrow-lookahead subtractions, the small additions, and ``mod_fold`` /
``mod_fold_combine`` (ct mod p^2, q^2 of the CIOS CRT decrypt).

It also holds :func:`dot_exact`, the one exact integer matrix product
every library-matmul site of the port goes through (here, and the base
extensions and conversions of ops/rns.py).
"""

from __future__ import annotations

import torch

from .limbs import LIMB_BITS, LIMB_MASK
from .montgomery import (
    _canonicalize64,
    _carry_prefix,
    _cond_sub_n64,
    _shift_in_zero,
    mont_mul,
)

_I64 = torch.int64
_I32 = torch.int32

#: Largest digit a :func:`dot_exact` operand may hold.
DOT_DIGIT_MAX = 127
#: Largest contraction length for which a float32 product of 7-bit digit
#: planes is exact: 127^2 * K < 2^24.
DOT_MAX_K = (1 << 24) // (DOT_DIGIT_MAX * DOT_DIGIT_MAX)  # 1040


def dot_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product a @ b of digit planes (entries 0..127) as an
    int64 tensor.

    CUDA has no integer matmul that returns 32-bit sums and ``int8 @ int8``
    wraps on the CPU, so the product runs in float32: every partial sum is
    an integer below 127^2 * K < 2^24 and therefore exact in any summation
    order, provided TF32 is off (checked, as is K)."""
    K = a.shape[-1]
    if K != b.shape[-2] or K > DOT_MAX_K:
        raise ValueError(f"dot_exact: contraction length {K} (limit {DOT_MAX_K})")
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "dot_exact needs full float32 matmuls: allow_tf32 must be False "
            "and the float32 matmul precision 'highest'"
        )
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(_I64)


def _planes3(v: torch.Tensor):
    """digits <= 2**15 -> 7/7/1(2)-bit planes."""
    return (v & 127, (v >> 7) & 127, v >> 14)


def _mul_shared64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    La = a.shape[-1]
    Lx = x.shape[-1]
    Lo = La + Lx
    dev = x.device
    # Toeplitz weights T[l, j] = a[j - l] (0 outside [0, La))
    jj = torch.arange(Lo, device=dev)[None, :]
    ll = torch.arange(Lx, device=dev)[:, None]
    idx = jj - ll
    valid = (idx >= 0) & (idx < La)
    T = torch.where(valid, a[idx.clamp(0, La - 1)], torch.zeros((), dtype=_I64, device=dev))
    xp = _planes3(x)
    Tp = _planes3(T)
    # group the 9 plane products by total shift s = 7*(i+j)
    S = [None] * 5
    for i in range(3):
        for j in range(3):
            prod = dot_exact(xp[i], Tp[j])
            s = i + j
            S[s] = prod if S[s] is None else S[s] + prod
    # recombine: value = sum_s S_s * 2^(7s), split at limb boundaries
    acc = torch.zeros(x.shape[:-1] + (Lo,), dtype=_I64, device=dev)
    for s, plane in enumerate(S):
        col, r = divmod(7 * s, LIMB_BITS)
        lo_part = (plane & ((1 << (LIMB_BITS - r)) - 1)) << r
        hi_part = plane >> (LIMB_BITS - r)
        acc = acc + _shift_in_zero(lo_part, col) + _shift_in_zero(hi_part, col + 1)
    return _canonicalize64(acc)


def mul_shared(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full product of shared ``a`` [La] with batched ``x`` [..., Lx] as
    canonical limbs [..., La+Lx].  ``a`` canonical; ``x`` digits may be
    redundant up to 2**15 inclusive.  One exact matmul against a Toeplitz
    matrix of a's limbs (7-bit digit planes through :func:`dot_exact`)."""
    return _mul_shared64(a.to(_I64), x.to(_I64)).to(_I32)


def mul_low(a: torch.Tensor, x: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Low ``out_limbs`` limbs of a*x, i.e. a*x mod 2**(15*out_limbs)."""
    full = mul_shared(a, x[..., :out_limbs])
    return full[..., :out_limbs]


def add_scalar(x: torch.Tensor, c: int) -> torch.Tensor:
    """x + c for a small constant c (adds into limb 0, then canonicalizes)."""
    x64 = x.to(_I64).clone()
    x64[..., 0] += c
    return _canonicalize64(x64).to(_I32)


def add_carry(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, canonical output (carry out of the top limb must be zero)."""
    return _canonicalize64(x.to(_I64) + y.to(_I64)).to(_I32)


def _sub_borrow64(x: torch.Tensor, y: torch.Tensor):
    y_b = y.expand_as(x)
    g = (x < y_b).to(_I64)
    p = (x == y_b).to(_I64)
    B = _carry_prefix(g, p)
    b_in = _shift_in_zero(B)
    diff = (x - y_b - b_in) & LIMB_MASK
    return diff, B[..., -1]


def sub_borrow(x: torch.Tensor, y: torch.Tensor):
    """(x - y) mod 2**(15L) with the final borrow flag; canonical inputs."""
    diff, borrow = _sub_borrow64(x.to(_I64), y.to(_I64))
    return diff.to(_I32), borrow.to(_I32)


def sub_mod(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(x - y) mod m for canonical x, y < m (shared modulus limbs m)."""
    diff, borrow = _sub_borrow64(x.to(_I64), y.to(_I64))
    plus_m = _canonicalize64(diff + m.to(_I64))
    return torch.where((borrow == 1)[..., None], plus_m, diff).to(_I32)


def sub_scalar(x: torch.Tensor, c: int) -> torch.Tensor:
    """x - c for small constant 0 <= c < 2**15; x must be >= c."""
    c_l = torch.zeros((x.shape[-1],), dtype=_I64, device=x.device)
    c_l[:1].fill_(c)  # on the device: a store from the host would wait for it
    diff, _ = _sub_borrow64(x.to(_I64), c_l)
    return diff.to(_I32)


def mod_fold(x: torch.Tensor, n: torch.Tensor, n0inv, r2: torch.Tensor) -> torch.Tensor:
    """Reduce double-width ``x`` [..., 2L] to ``x mod m`` represented in
    [..., L] limbs with value < R (not fully reduced: safe as a ``mont_exp``
    base, whose first to-Montgomery multiply tolerates any value < R).

    Uses x = x_hi * 2**(15L) + x_lo and x_hi * 2**(15L) mod m ==
    montmul(x_hi, R^2 mod m): one Montgomery multiply plus an add."""
    L = n.shape[-1]
    folded = mont_mul(x[..., L:], r2, n, n0inv)  # x_hi * R mod m
    return mod_fold_combine(folded, x[..., :L], n)


def mod_fold_combine(folded: torch.Tensor, x_lo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Tail of :func:`mod_fold` given folded = x_hi * R mod m (< 2m, digits
    <= 2**15) and the canonical low half x_lo.  Split out so the Montgomery
    product can run in its kernel (ops/paillier_ops.decrypt_crt_op).  ``n``
    is [L], or [G, 1, L] against grouped [G, B, L] operands."""
    L = n.shape[-1]
    s = folded.to(_I64) + x_lo.to(_I64)
    ext = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    ext = _canonicalize64(ext)  # value < R + 2m, fits L+1 limbs
    n64 = n.to(_I64)
    n_ext = torch.cat([n64, torch.zeros_like(n64[..., :1])], dim=-1)
    ext = _cond_sub_n64(_cond_sub_n64(ext, n_ext), n_ext)  # < R, top limb zero
    return ext[..., :L].to(_I32)
