"""Randomness for key material and obfuscators.

Own copy of the JAX package's ``utils/rng.py``.  The OS CSPRNG
(``secrets`` / ``os.urandom``) is the only source of randomness:

* **key material**: drawn directly from the OS CSPRNG on the host.
* **fresh obfuscators (hot path)**: a per-call OS-CSPRNG key+nonce
  (:class:`DeviceSeed`, 44 bytes) expanded ON DEVICE by an RFC 8439
  ChaCha20 keystream (ops/paillier_ops._chacha20_blocks) — a vetted
  cryptographic DRBG in the role of the reference's ippsPRNGen DRBG
  seeded from rdseed (ipcl/utils/common.cpp:52-77).  The host uploads
  44 bytes a call instead of the obfuscator byte matrix (256 KB for a
  2048-bit key's batch of 2048).  ``PAILLIER_TORCH_HOST_RNG=1``
  (:func:`use_device_rng`) selects the bytes-direct path instead: the
  OS CSPRNG draws the exponent bytes (DJN) or the bases (normal mode) on
  the host and the engines upload them.
* **deterministic test vectors**: explicit injection via
  ``PublicKey.set_random`` (the analog of the reference's ``setRandom``
  hook, ipcl/pub_key.cpp:92-95).
"""

from __future__ import annotations

import os
import secrets
from typing import List

import numpy as np


class DeviceSeed:
    """A per-call OS-entropy ChaCha20 key+nonce (uint32[11]: 256-bit key,
    96-bit nonce) for on-device obfuscator expansion.

    Engines evaluate an RFC 8439 ChaCha20 keystream on the accelerator —
    a vetted CSPRNG construction, deliberately not ``torch.Generator``
    (whose generators are not cryptographic).  Paths that cannot expand on
    the device (hybrid batch splits, the backends other than ``"rns"``)
    call :meth:`materialize` for an equivalent fresh host draw instead.
    Under a mesh every entry expands a seed row of its own."""

    __slots__ = ("data",)

    def __init__(self, data=None):
        """A fresh seed, or the given 11 words (one row of a mesh's seed
        rows, models/engine.PublicEngine._seed_rows)."""
        if data is None:
            self.data = np.frombuffer(os.urandom(44), np.uint32).copy()
        else:
            self.data = np.asarray(data, np.uint32).reshape(11).copy()

    def materialize(self, count: int, nbits: int):
        return batch_random_bytes(count, nbits)


def use_device_rng() -> bool:
    """Whether fresh obfuscators expand on the device (the default; see the
    module docstring).  ``PAILLIER_TORCH_HOST_RNG=1`` turns it off."""
    return os.environ.get("PAILLIER_TORCH_HOST_RNG") != "1"


def random_bits(nbits: int) -> int:
    """Uniform integer in [0, 2**nbits)."""
    return secrets.randbits(nbits)


def batch_random_bits(count: int, nbits: int) -> List[int]:
    """``count`` independent uniform integers in [0, 2**nbits).

    Bulk-reads the OS CSPRNG once instead of per-element syscalls."""
    nbytes = -(-nbits // 8)
    buf = os.urandom(count * nbytes)
    mask = (1 << nbits) - 1
    return [
        int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") & mask
        for i in range(count)
    ]


def batch_random_bytes(count: int, nbits: int):
    """``count`` uniform integers in [0, 2**nbits) as a [count, ceil(nbits/8)]
    uint8 array, LEAST-significant byte first — the exponent wire format of
    the fixed-base kernel."""
    nbytes = -(-nbits // 8)
    arr = np.frombuffer(os.urandom(count * nbytes), np.uint8).reshape(
        count, nbytes
    )
    top = nbits % 8
    if top:
        arr = arr.copy()
        arr[:, -1] &= (1 << top) - 1
    return arr
