"""Batched Montgomery modular arithmetic on 15-bit limbs in plain PyTorch.

Counterpart of the JAX package's ``ops/montgomery.py``.  Numbers are
[batch, L] integer tensors of 15-bit limbs (ops/limbs.py).  Tensors at
function boundaries are ``int32`` (every value on these paths fits 31
bits); the arithmetic runs in ``int64`` and is cast back.  Where the
reference relies on unsigned 32-bit wrap-around followed by a mask
(``cond_sub_n``, ``sub_borrow``) the int64 form applies the same mask to a
possibly negative value: two's-complement ``&`` gives the same low bits.

``mont_mul``, ``mont_mod_mul`` and ``mont_exp`` are the plain versions of the
CIOS kernels (ops/cuda_modexp.py) and, together, the ``"plain"`` backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, limbs_for_bits

_I64 = torch.int64
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Host-side per-modulus constants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MontConstants:
    """Precomputed Montgomery constants for one modulus (host side)."""

    modulus: int
    nbits: int
    num_limbs: int
    n0inv: int  # -modulus^{-1} mod 2^15
    n_limbs: np.ndarray  # [L] uint32
    r2_limbs: np.ndarray  # [L] uint32, R^2 mod modulus
    one_limbs: np.ndarray  # [L] uint32, R mod modulus (Montgomery form of 1)

    @classmethod
    def create(cls, modulus: int, nbits: Optional[int] = None) -> "MontConstants":
        if modulus <= 0 or modulus % 2 == 0:
            raise ValueError("Montgomery modulus must be positive and odd")
        if nbits is None:
            nbits = modulus.bit_length()
        L = limbs_for_bits(nbits)
        R = 1 << (LIMB_BITS * L)
        assert R > 4 * modulus, "GUARD_BITS invariant violated"
        n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) & LIMB_MASK
        return cls(
            modulus=modulus,
            nbits=nbits,
            num_limbs=L,
            n0inv=n0inv,
            n_limbs=int_to_limbs(modulus, L),
            r2_limbs=int_to_limbs(R * R % modulus, L),
            one_limbs=int_to_limbs(R % modulus, L),
        )

    def as_device_args(self, device):
        """(n, n0inv, r2, one): int32 tensors on ``device``, n0inv an int."""
        return (
            to_i32(self.n_limbs, device),
            int(self.n0inv),
            to_i32(self.r2_limbs, device),
            to_i32(self.one_limbs, device),
        )


def to_i32(a, device) -> torch.Tensor:
    """Host array of values < 2^31 -> int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Carry handling (int64 inside)
# ---------------------------------------------------------------------------


def _shift_in_zero(c: torch.Tensor, by: int = 1) -> torch.Tensor:
    """[..., L] -> values moved ``by`` limbs up (zeros enter at limb 0)."""
    if by == 0:
        return c
    out = torch.zeros_like(c)
    if by < c.shape[-1]:
        out[..., by:] = c[..., :-by]
    return out


def _carry_round64(x: torch.Tensor) -> torch.Tensor:
    return (x & LIMB_MASK) + _shift_in_zero(x >> LIMB_BITS)


def carry_round(x: torch.Tensor) -> torch.Tensor:
    """One redundant carry round: digit_j := (digit_j & M) + (digit_{j-1} >> 15)."""
    return _carry_round64(x.to(_I64)).to(_I32)


def carry_round2(x: torch.Tensor) -> torch.Tensor:
    """Two redundant carry rounds (the JAX package's ``carry_round2``,
    ops/montgomery.py:129-130): digits up to ~2**26 come down to <= 2**15."""
    return carry_round(carry_round(x))


def _carry_prefix(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of the carry/borrow recurrence
    ``c_out = g | (p & c_in)`` along the last axis (log-depth doubling
    steps; g, p are 0/1 tensors).  Returns the carry OUT of each limb."""
    L = g.shape[-1]
    d = 1
    while d < L:
        g = g | (p & _shift_in_zero(g, d))
        p = p & _shift_in_zero(p, d)
        d *= 2
    return g


def _canonicalize64(x: torch.Tensor) -> torch.Tensor:
    t = _carry_round64(_carry_round64(_carry_round64(x)))  # digits <= 2**15
    g = t >> LIMB_BITS
    r = t & LIMB_MASK
    p = (r == LIMB_MASK).to(_I64)
    c = _shift_in_zero(_carry_prefix(g, p))
    return (r + c) & LIMB_MASK


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Full carry propagation to canonical (< 2**15) limbs.  Digits up to
    2**32-1 are accepted (int64 input for anything above 2**31-1)."""
    return _canonicalize64(x.to(_I64)).to(_I32)


def _cond_sub_n64(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    n_b = n.expand_as(x)
    g = (x < n_b).to(_I64)
    p = (x == n_b).to(_I64)
    B = _carry_prefix(g, p)
    b_in = _shift_in_zero(B)
    diff = (x - n_b - b_in) & LIMB_MASK
    keep = (B[..., -1:] == 1)
    return torch.where(keep, x, diff)


def cond_sub_n(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """If x >= n subtract n, else keep x.  ``x`` must be canonical limbs."""
    return _cond_sub_n64(x.to(_I64), n.to(_I64)).to(_I32)


# ---------------------------------------------------------------------------
# Montgomery multiplication (redundant-digit CIOS)
# ---------------------------------------------------------------------------


def _mont_mul64(a, b, n, n0inv):
    L = a.shape[-1]
    batch_shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc = torch.zeros(batch_shape + (L + 1,), dtype=_I64, device=a.device)
    b0 = b[..., 0]
    for i in range(L):
        ai = a[..., i : i + 1]
        t0 = acc[..., 0] + ai[..., 0] * b0
        mi = (t0 * n0inv) & LIMB_MASK
        p1 = ai * b
        p2 = mi[..., None] * n
        lo = (p1 & LIMB_MASK) + (p2 & LIMB_MASK)
        hi = (p1 >> LIMB_BITS) + (p2 >> LIMB_BITS)
        acc[..., :L] += lo
        acc[..., 1:] += hi
        carry0 = acc[..., 0] >> LIMB_BITS
        acc = torch.cat([acc[..., 1:], torch.zeros_like(acc[..., :1])], dim=-1)
        acc[..., 0] += carry0
    return _carry_round64(_carry_round64(acc))[..., :L]


def _n0(n0inv):
    """n0inv as something that broadcasts against [..., batch]: an int, or
    a per-group tensor [G] against [G, B]."""
    if isinstance(n0inv, torch.Tensor):
        n0inv = n0inv.to(_I64)
        if n0inv.ndim == 1:
            n0inv = n0inv[:, None]
    return n0inv


def mont_mul(a, b, n, n0inv) -> torch.Tensor:
    """Batched Montgomery product  a*b*R^{-1} mod n  (value < 2n).

    a, b: [..., L] digits <= 2**15 (slightly redundant OK).
    n:    [L] (or broadcastable) canonical limbs of the odd modulus.
    n0inv: -n^{-1} mod 2**15 (int, or [G] tensor for grouped [G, B, L]).
    Output digits <= 2**15.  No conditional subtraction."""
    return _mont_mul64(
        a.to(_I64), b.to(_I64), n.to(_I64), _n0(n0inv)
    ).to(_I32)


def mont_mod_mul(a, b, n, n0inv, r2) -> torch.Tensor:
    """Plain modular product a*b mod n (both operands in ordinary form):
    montmul(montmul(a, r2), b), canonical and fully reduced (< n)."""
    n64 = n.to(_I64)
    n0 = _n0(n0inv)
    a_m = _mont_mul64(a.to(_I64), r2.to(_I64), n64, n0)
    res = _mont_mul64(a_m, b.to(_I64), n64, n0)
    return _cond_sub_n64(_canonicalize64(res), n64).to(_I32)


# ---------------------------------------------------------------------------
# Fixed-window exponentiation
# ---------------------------------------------------------------------------


def _select_pow(table: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Constant-time table lookup: table [T, ..., L], w [...] -> [..., L].

    One-hot multiply-accumulate instead of a gather: uniform work whatever
    the (secret) window value."""
    T = table.shape[0]
    ks = torch.arange(T, dtype=_I64, device=w.device).reshape((T,) + (1,) * w.ndim)
    onehot = (w[None] == ks).to(_I64)[..., None]  # [T, ..., 1]
    return (table * onehot).sum(dim=0)


def mont_exp(base, windows, n, n0inv, r2, mont_one) -> torch.Tensor:
    """Batched  base^e mod n,  e given as 4-bit windows (MS window first).

    base:    [..., L] limbs, value < R (digits <= 2**15); [L] when shared.
    windows: [..., NW] values in [0, 16); broadcasts against base's batch.
    n, r2, mont_one: [L], or [G, 1, L] for grouped [G, B, L] operands with
    n0inv a [G] tensor.  Returns canonical limbs of the fully reduced
    result (< n).

    The plain version of the windowed CIOS modexp kernel
    (ops/cuda_modexp.modexp) and the whole ``"plain"`` backend: the same
    16-entry power table, 4 squarings and one product per window, leave
    Montgomery form, carry resolve and conditional subtract."""
    L = base.shape[-1]
    nw = windows.shape[-1]
    windows = windows.to(_I64)
    n64, r2_64, one64 = n.to(_I64), r2.to(_I64), mont_one.to(_I64)
    n0 = _n0(n0inv)
    batch_shape = torch.broadcast_shapes(base.shape[:-1], windows.shape[:-1])

    a = _mont_mul64(base.to(_I64), r2_64, n64, n0)  # to Montgomery form, < 2n
    one_b = one64.expand(batch_shape + (L,))
    # The power table is built at the BASE's batch shape: a shared base (the
    # DJN hs) gets one table for the whole batch.  Left-pad its batch dims
    # with 1s so that the one-hot select broadcasts against the full batch.
    a = a.reshape((1,) * (len(batch_shape) - (a.ndim - 1)) + tuple(a.shape))
    powers = [one64.expand(a.shape), a]
    for _ in range(2, 16):
        powers.append(_mont_mul64(powers[-1], a, n64, n0))
    table = torch.stack(powers)  # [16, *base_batch, L]

    acc = one_b
    for k in range(nw):
        for _ in range(4):
            acc = _mont_mul64(acc, acc, n64, n0)
        w = windows[..., k].expand(batch_shape)
        acc = _mont_mul64(acc, _select_pow(table, w), n64, n0)

    # leave Montgomery form: multiply by plain 1
    plain_one = torch.zeros((L,), dtype=_I64, device=base.device)
    plain_one[0] = 1
    res = _mont_mul64(acc, plain_one, n64, n0)
    return _cond_sub_n64(_canonicalize64(res), n64).to(_I32)
