"""Fixed-shape limb representation of big integers for the GPU kernels.

Own copy of the JAX package's ``ops/limbs.py``, numpy codecs only.  This is the replacement for the reference's heap-allocated
``BigNumber`` (reference: ipcl/bignum.cpp:1-565).  Instead of variable-length
32-bit word vectors managed by ipp-crypto, every big integer lives in a
fixed-shape integer tensor of W-bit limbs (W = 15), least-significant limb
first.  The 15-bit radix is chosen so that

  * a product of two (slightly redundant, <= 2**15) limbs fits exactly in a
    uint32 lane (the analog of AVX512-IFMA's 52-bit limbs in 64-bit registers,
    reference: ipcl/mod_exp.cpp:508-516), and
  * a column of ~2**10 such partial products can be accumulated in uint32
    without any carry propagation inside the Montgomery inner loop.

All host <-> limb conversions are vectorised numpy (bit un/packing), so large
ciphertext batches convert without per-element Python loops.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

# Limb width in bits.  See module docstring for why 15.
LIMB_BITS = 15
LIMB_MASK = (1 << LIMB_BITS) - 1
# Guard bits so that R = 2**(LIMB_BITS * L) > 4 * modulus, required by the
# "Montgomery multiplication without final subtraction" bound (values < 2n).
GUARD_BITS = 4

# Window width for fixed-window modular exponentiation.
WINDOW_BITS = 4
WINDOW_MASK = (1 << WINDOW_BITS) - 1


def limbs_for_bits(nbits: int) -> int:
    """Number of 15-bit limbs for a modulus of ``nbits`` bits (with guard)."""
    return -(-(nbits + GUARD_BITS) // LIMB_BITS)


def num_windows(ebits: int) -> int:
    """Number of 4-bit exponent windows covering ``ebits`` bits (>= 1)."""
    return max(1, -(-ebits // WINDOW_BITS))


# ---------------------------------------------------------------------------
# int <-> limb array codecs (vectorised over a batch)
# ---------------------------------------------------------------------------


def ints_to_limbs(xs: Sequence[int], num_limbs: int) -> np.ndarray:
    """Pack non-negative Python ints into a [batch, num_limbs] uint32 array.

    Little-endian limb order (limb 0 = least significant 15 bits).
    """
    if any(x < 0 for x in xs):
        raise ValueError("ints_to_limbs: negative values not supported")
    batch = len(xs)
    nbytes = -(-(num_limbs * LIMB_BITS) // 8)
    buf = bytearray(batch * nbytes)
    for i, x in enumerate(xs):
        if x < 0:
            raise ValueError("ints_to_limbs: negative values not supported")
        buf[i * nbytes : (i + 1) * nbytes] = int(x).to_bytes(nbytes, "little")
    bits = np.unpackbits(
        np.frombuffer(bytes(buf), dtype=np.uint8).reshape(batch, nbytes),
        axis=1,
        bitorder="little",
    )[:, : num_limbs * LIMB_BITS]
    bits = bits.reshape(batch, num_limbs, LIMB_BITS).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(LIMB_BITS, dtype=np.uint32))[None, None, :]
    return (bits * weights).sum(axis=2, dtype=np.uint32)


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Pack one int into a [num_limbs] uint32 limb vector."""
    return ints_to_limbs([x], num_limbs)[0]


def limbs_to_ints(limbs: np.ndarray) -> List[int]:
    """Inverse of :func:`ints_to_limbs`.  Accepts [batch, L] (canonical limbs)."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    if limbs.ndim == 1:
        limbs = limbs[None]
    batch, L = limbs.shape
    if np.any(limbs > LIMB_MASK):
        raise ValueError("limbs_to_ints: limbs not canonical (>= 2**15)")
    bits = (
        (limbs[:, :, None] >> np.arange(LIMB_BITS, dtype=np.uint64)[None, None, :]) & 1
    ).astype(np.uint8)
    bits = bits.reshape(batch, L * LIMB_BITS)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros((batch, pad), np.uint8)], axis=1)
    data = np.packbits(bits, axis=1, bitorder="little")
    return [int.from_bytes(row.tobytes(), "little") for row in data]


def limbs_to_int(limbs: np.ndarray) -> int:
    return limbs_to_ints(limbs)[0]


# ---------------------------------------------------------------------------
# exponent window codec
# ---------------------------------------------------------------------------


def ints_to_windows(xs: Sequence[int], ebits: int) -> np.ndarray:
    """Exponents -> [batch, NW] uint32 array of 4-bit windows, MOST significant
    window first (the order consumed by the left-to-right fixed-window
    exponentiation in ops/montgomery.py).

    ``ebits`` is rounded up to a whole number of windows; leading windows of
    short exponents are zero, which the exponentiation treats as multiplies by
    one (constant-shape, constant-time behaviour mirroring the reference's
    pad-to-longest policy in ipcl/mod_exp.cpp:480-516).
    """
    nw = num_windows(ebits)
    batch = len(xs)
    totbits = nw * WINDOW_BITS
    for x in xs:
        if x < 0:
            raise ValueError("ints_to_windows: negative exponent")
        if x >> totbits:
            raise ValueError("ints_to_windows: exponent wider than ebits")
    nbytes = -(-totbits // 8)
    buf = bytearray(batch * nbytes)
    for i, x in enumerate(xs):
        x = int(x)
        if x < 0:
            raise ValueError("ints_to_windows: negative exponent")
        if x >> totbits:
            raise ValueError("ints_to_windows: exponent wider than ebits")
        buf[i * nbytes : (i + 1) * nbytes] = x.to_bytes(nbytes, "little")
    bits = np.unpackbits(
        np.frombuffer(bytes(buf), dtype=np.uint8).reshape(batch, nbytes),
        axis=1,
        bitorder="little",
    )[:, :totbits]
    bits = bits.reshape(batch, nw, WINDOW_BITS).astype(np.uint8)
    weights = (np.uint8(1) << np.arange(WINDOW_BITS, dtype=np.uint8))[None, None, :]
    wins = (bits * weights).sum(axis=2, dtype=np.uint8)
    return wins[:, ::-1].copy()  # most-significant window first (uint8)


def ints_to_bytes_le(xs: Sequence[int], nbytes: int) -> np.ndarray:
    """Exponents -> [batch, nbytes] uint8, LEAST-significant byte first.

    The wire format of the fixed-base kernel (ops/cuda_rns2.py):
    byte i is the 8-bit window of weight 2^(8*i)."""
    batch = len(xs)
    buf = bytearray(batch * nbytes)
    for i, x in enumerate(xs):
        buf[i * nbytes : (i + 1) * nbytes] = int(x).to_bytes(nbytes, "little")
    return np.frombuffer(bytes(buf), np.uint8).reshape(batch, nbytes)


def max_bitlength(xs: Iterable[int]) -> int:
    return max((int(x).bit_length() for x in xs), default=1)


# ---------------------------------------------------------------------------
# packed transfers: two 15-bit limbs per uint32 word (halves host<->device
# traffic, which dominates end-to-end time on narrow interconnects)
# ---------------------------------------------------------------------------


def pack_pairs_np(limbs: np.ndarray) -> np.ndarray:
    """[..., L] canonical 15-bit limbs -> [..., ceil(L/2)] packed uint32."""
    limbs = np.asarray(limbs, np.uint32)
    L = limbs.shape[-1]
    if L % 2:
        pad = np.zeros(limbs.shape[:-1] + (1,), np.uint32)
        limbs = np.concatenate([limbs, pad], axis=-1)
    return limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(LIMB_BITS))


def unpack_pairs_np(packed: np.ndarray, num_limbs: int) -> np.ndarray:
    """Inverse of :func:`pack_pairs_np`."""
    packed = np.asarray(packed, np.uint32)
    lo = packed & np.uint32(LIMB_MASK)
    hi = packed >> np.uint32(LIMB_BITS)
    out = np.empty(packed.shape[:-1] + (2 * packed.shape[-1],), np.uint32)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out[..., :num_limbs]
