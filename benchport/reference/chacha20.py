"""RFC 8439 ChaCha20 block function in NumPy, and the map from a seed's
keystream to the obfuscator randoms of one batch.

The keystream is the RFC's: state = 4 constants, 8 key words, a 32-bit
block counter, 3 nonce words; 20 rounds; each block serialised as 16
little-endian words.  The map from keystream to randoms is a frozen copy of
what the measured program does with an 11-word seed (key words 0-7, nonce
words 8-10, counter from 0): row i of a batch reads bytes
[i * nbytes, (i + 1) * nbytes) of the keystream, least significant first.
A later change of that map in the program is a change of its results, and
this copy is what catches it.
"""

from __future__ import annotations

import numpy as np

_CONSTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _quarter(s: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def blocks(key_words, nonce_words, nblocks: int, counter: int = 0) -> np.ndarray:
    """``nblocks`` keystream blocks from block ``counter`` on, as a
    [nblocks, 64] uint8 array.  ``key_words``: 8 uint32, ``nonce_words``: 3."""
    key = np.asarray(key_words, np.uint32).reshape(8)
    nonce = np.asarray(nonce_words, np.uint32).reshape(3)
    init = np.empty((16, nblocks), np.uint32)
    init[0:4] = _CONSTS[:, None]
    init[4:12] = key[:, None]
    init[12] = (np.arange(nblocks, dtype=np.uint64) + counter).astype(np.uint32)
    init[13:16] = nonce[:, None]
    s = init.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter(s, 0, 4, 8, 12)
            _quarter(s, 1, 5, 9, 13)
            _quarter(s, 2, 6, 10, 14)
            _quarter(s, 3, 7, 11, 15)
            _quarter(s, 0, 5, 10, 15)
            _quarter(s, 1, 6, 11, 12)
            _quarter(s, 2, 7, 8, 13)
            _quarter(s, 3, 4, 9, 14)
        s += init
    return np.ascontiguousarray(s.T).astype("<u4").view(np.uint8).reshape(nblocks, 64)


def row_bytes(seed_words, rows, nbytes: int) -> np.ndarray:
    """[len(rows), nbytes] uint8: the bytes that rows ``rows`` of a batch
    read from the keystream of ``seed_words`` (11 uint32)."""
    seed = np.asarray(seed_words, np.uint32).reshape(11)
    rows = np.asarray(rows, np.int64).reshape(-1)
    out = np.empty((rows.size, nbytes), np.uint8)
    for j, i in enumerate(rows):
        lo, hi = int(i) * nbytes, (int(i) + 1) * nbytes
        first, last = lo // 64, (hi - 1) // 64
        ks = blocks(seed[:8], seed[8:11], last - first + 1, counter=first).reshape(-1)
        out[j] = ks[lo - 64 * first : hi - 64 * first]
    return out


def djn_exponents(seed_words, rows, randbits: int):
    """The DJN obfuscator exponents r of rows ``rows``: a row of NP bytes,
    NP = max(8, ceil(ceil(randbits / 8) / 8) * 8), bytes beyond randbits
    zeroed, read as a little-endian integer."""
    nbytes = -(-randbits // 8)
    np_bytes = max(8, -(-nbytes // 8) * 8)
    by = row_bytes(seed_words, rows, np_bytes)
    mask = (1 << randbits) - 1
    return [int.from_bytes(b.tobytes(), "little") & mask for b in by]


def normal_bases(seed_words, rows, nbits: int):
    """The normal-mode obfuscator bases r of rows ``rows``: unreduced
    integers of 2 * nbits + 3 bits (the program raises them to n mod n^2,
    where r and r mod n give the same result)."""
    ebits = 2 * nbits + 3
    by = row_bytes(seed_words, rows, -(-ebits // 8))
    mask = (1 << ebits) - 1
    return [int.from_bytes(b.tobytes(), "little") & mask for b in by]
