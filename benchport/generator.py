"""The one generator of traffic: every input of a run, drawn from ``--seed``
and the parameters of a traffic file.

All draws go through NumPy's SeedSequence keyed by (seed, stream, index),
so the same seed gives the same inputs in any order of calls, and any whole
number is a seed (it is taken mod 2^64).  The streams:

* ``PLAIN``: pools of plaintexts of ``plain_bits`` bits;
* ``CIPHER``: pools of elements of Z_{n^2}, drawn uniform with no pow();
* ``SEED``: the 11 words (ChaCha20 key and nonce) of batch i's obfuscators;
* ``ROWS``: the rows of batch i whose answers are kept for the check;
* ``CHECK``: which kept answers are compared;
* ``KEY``: the key's own draws (the DJN base hs).
"""

from __future__ import annotations

import numpy as np

PLAIN, CIPHER, SEED, ROWS, CHECK, KEY = range(6)
#: Indices of the batches that warm up (set-up), apart from the window's
WARM_BASE = 1 << 40


def _rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream, index])


def uniform_ints(rng: np.random.Generator, count: int, bits: int, modulus=None):
    """``count`` Python ints of ``bits`` bits (reduced mod ``modulus`` when
    given), from one bulk draw of bytes."""
    nbytes = -(-bits // 8)
    raw = rng.integers(0, 256, size=count * nbytes, dtype=np.uint8).tobytes()
    mask = (1 << bits) - 1
    out = [int.from_bytes(raw[k * nbytes : (k + 1) * nbytes], "little") & mask
           for k in range(count)]
    if modulus is not None:
        out = [v % modulus for v in out]
    return out


def key_int(seed: int, bits: int) -> int:
    """One draw of ``bits`` bits for the key (stream KEY)."""
    return uniform_ints(_rng(seed, KEY), 1, bits)[0]


def plain_pool(seed: int, traffic: dict):
    """``pool_batches`` batches of ``batch`` plaintexts of ``plain_bits``
    bits each."""
    B, bits = traffic["batch"], traffic["plain_bits"]
    return [uniform_ints(_rng(seed, PLAIN, k), B, bits) for k in range(traffic["pool_batches"])]


def cipher_pool(seed: int, traffic: dict, n: int):
    """``pool_batches`` batches of ``batch`` elements of Z_{n^2}, each drawn
    from 64 bits more than n^2 has and reduced: a unit of Z*_{n^2}, and so a
    valid ciphertext, except with odds ~2^-1000."""
    B, n2 = traffic["batch"], n * n
    return [uniform_ints(_rng(seed, CIPHER, k), B, n2.bit_length() + 64, n2)
            for k in range(traffic["pool_batches"])]


def seed_words(seed: int, i: int) -> np.ndarray:
    """The 11 uint32 words (256-bit key, 96-bit nonce) of batch i's
    obfuscator seed."""
    return _rng(seed, SEED, i).integers(0, 1 << 32, size=11, dtype=np.uint64).astype(np.uint32)


def kept_rows(seed: int, i: int, B: int, per_batch: int = 1):
    """Rows of batch i whose answers are kept: ``per_batch`` distinct
    uniform rows, and the batch's last row (the ragged tile of a kernel) on
    every fourth batch and its first on every fourth from the second."""
    rows = {int(r) for r in _rng(seed, ROWS, i).choice(B, size=min(per_batch, B), replace=False)}
    if i % 4 == 1:
        rows.add(B - 1)
    if i % 4 == 3:
        rows.add(0)
    return sorted(rows)


def check_sample(seed: int, kept, count: int):
    """``count`` of the ``kept`` (batch, row) pairs, drawn from the seed."""
    kept = sorted(kept)
    if len(kept) <= count:
        return kept
    pick = _rng(seed, CHECK).choice(len(kept), size=count, replace=False)
    return [kept[k] for k in sorted(pick)]
