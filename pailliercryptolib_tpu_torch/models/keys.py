"""PublicKey / PrivateKey / KeyPair — Paillier scheme semantics.

Counterpart of the JAX package's ``models/keys.py``.  Host-side key
objects holding arbitrary-precision integers, with cached device engines
for all batched math.  Semantics mirror the reference (ipcl/pub_key.cpp,
ipcl/pri_key.cpp) including the DJN variant, the deterministic-randomness
test hooks, and the CRT decrypt path — but all hot math runs as batched
programs on one torch device (``device``, default ``"cuda"``) instead of
per-element ipp calls.  Keys up to 4096 bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from ..utils import rng as _rng
from ..utils import trace
from .engine import PrivateEngine, PublicEngine, resolve_device
from .texts import CipherText, PlainText


class PublicKey:
    """Paillier public key (reference: ipcl/pub_key.cpp:18-164).

    Holds n, g = n+1, n^2; optionally the DJN obfuscator base
    hs = (-r^2)^n mod n^2 with half-width obfuscator exponents.
    """

    def __init__(
        self,
        n: int,
        bits: Optional[int] = None,
        enable_DJN: bool = False,
        *,
        hs: Optional[int] = None,
        randbits: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n = int(n)
        self.bits = int(bits) if bits is not None else self.n.bit_length()
        self.g = self.n + 1
        self.nsquare = self.n * self.n
        self.enable_djn_flag = False
        self.hs = 0
        self.randbits = 0
        self._test_r: List[int] = []
        self._testv = False
        self._engine_cache: Optional[PublicEngine] = None
        if hs is not None:
            # create(n, bits, hs, randbits) path (ipcl/pub_key.cpp:156-162)
            self.enable_djn_flag = True
            self.hs = int(hs)
            self.randbits = int(randbits if randbits is not None else self.bits >> 1)
        elif enable_DJN:
            self.enable_djn()

    # -- DJN setup (ipcl/pub_key.cpp:32-49) ---------------------------------

    def enable_djn(self) -> None:
        while True:
            rand = _rng.random_bits(self.n.bit_length() + 128)
            rmod = rand % self.n
            if math.gcd(rand, self.n) == 1:
                break
        h = (-(rmod * rmod)) % self.n
        self.hs = pow(h, self.n, self.nsquare)
        self.randbits = self.bits >> 1
        self.enable_djn_flag = True
        if self._engine_cache is not None:
            self._engine_cache.set_hs(self.hs, self.randbits)

    def set_djn(self, hs: int, randbits: int) -> None:
        """Install externally computed DJN parameters (ipcl/pub_key.cpp:131-137)."""
        if self.enable_djn_flag:
            return
        self.hs = int(hs)
        self.randbits = int(randbits)
        self.enable_djn_flag = True
        if self._engine_cache is not None:
            self._engine_cache.set_hs(self.hs, self.randbits)

    # -- deterministic test hooks (ipcl/pub_key.cpp:92-97) ------------------

    def set_random(self, r: Sequence[int]) -> None:
        self._test_r.extend(int(v) for v in r)
        self._testv = True

    def set_hs(self, hs: int) -> None:
        self.hs = int(hs)
        if self._engine_cache is not None:
            self._engine_cache.set_hs(self.hs)

    # -- engine -------------------------------------------------------------

    @property
    def _engine(self) -> PublicEngine:
        if self._engine_cache is None:
            self._engine_cache = PublicEngine(
                self.n, self.bits, self.hs if self.enable_djn_flag else None,
                self.randbits, device=self.device,
            )
        return self._engine_cache

    # -- encryption (ipcl/pub_key.cpp:99-129) -------------------------------

    def encrypt(
        self, pt: Union[PlainText, Sequence[int], int], make_secure: bool = True
    ) -> CipherText:
        if not isinstance(pt, PlainText):
            pt = PlainText(pt)
        size = len(pt)
        if size == 0:
            raise ValueError("encrypt: Cannot encrypt empty PlainText")
        # m >= n embeds identically to m mod n: n*m+1 = n*(m mod n)+1 mod n^2.
        m = [v % self.n for v in pt.texts]
        if not make_secure:
            return CipherText(self, self._engine.encrypt_noobf_dev(m))
        r = self._draw_randoms(size, op="encrypt")
        if self.enable_djn_flag:
            ct = self._engine.encrypt_djn_dev(m, r)
        else:
            ct = self._engine.encrypt_normal_dev(m, r)
        return CipherText(self, ct)

    def _draw_randoms(self, size: int, op: str = "encrypt"):
        """Obfuscator randoms: injected test values (consumed FIFO) or a
        CSPRNG draw (ipcl/pub_key.cpp:56-77).  Fresh draws are a
        DeviceSeed (on-device ChaCha20 expansion) on the paths the engines
        expand on the device: DJN always, normal mode for ``op="encrypt"``.
        With ``PAILLIER_TORCH_HOST_RNG=1`` (utils/rng.use_device_rng) they
        are host draws instead: DJN exponents as a [size, nbytes] uint8
        matrix (the fixed-base kernel's wire format), normal-mode bases as
        ints."""
        if self._testv:
            if len(self._test_r) < size:
                raise ValueError("setRandom: not enough injected obfuscator values")
            r = [int(v) for v in self._test_r[:size]]
            del self._test_r[:size]  # consume: each injected r is used once
            if not self._test_r:
                self._testv = False
            return r
        if self.enable_djn_flag:
            if _rng.use_device_rng():
                # 44-byte seed, expanded on device (utils/rng.DeviceSeed)
                return _rng.DeviceSeed()
            # bytes-direct CSPRNG draw (the fixed-base kernel's wire format)
            return _rng.batch_random_bytes(size, self.randbits)
        if op == "encrypt" and _rng.use_device_rng():
            return _rng.DeviceSeed()
        # r uniform in [1, n-1] (ipcl/pub_key.cpp:74-77)
        return [v % (self.n - 1) + 1 for v in _rng.batch_random_bits(size, self.bits)]

    def apply_obfuscator(self, ct: CipherText) -> CipherText:
        """Re-obfuscate an existing ciphertext: ct * hs^r (DJN) or ct * r^n
        (normal) mod n^2 — the standalone obfuscation API of the reference
        (ipcl/pub_key.cpp:82-90).  Returns a new CipherText decrypting to the
        same plaintext; the randomness is fresh (or injected via set_random)."""
        if len(ct) == 0:
            raise ValueError("applyObfuscator: empty CipherText")
        r = self._draw_randoms(len(ct), op="obfuscate")
        out = self._engine.obfuscate_dev(ct.device_payload(), r)
        return CipherText(self, out)

    # -- misc ---------------------------------------------------------------

    def is_djn(self) -> bool:
        return self.enable_djn_flag

    def get_hs(self) -> int:
        return self.hs if self.enable_djn_flag else 0

    def get_rand_bits(self) -> int:
        return self.randbits if self.enable_djn_flag else -1

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.n == other.n

    def __repr__(self) -> str:
        return f"PublicKey(bits={self.bits}, DJN={self.enable_djn_flag})"


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class PrivateKey:
    """Paillier private key with CRT decrypt (reference: ipcl/pri_key.cpp).

    All scalar precomputation (CRT tables, lambda, x, hp/hq) runs on host
    Python ints; batched decryption runs on device.
    """

    def __init__(
        self, pk_or_n: Union[PublicKey, int], p: int, q: int, device=None
    ):
        if isinstance(pk_or_n, PublicKey):
            self.public_key: Optional[PublicKey] = pk_or_n
            self.n = pk_or_n.n
            if device is None:
                device = pk_or_n.device
        else:
            self.public_key = None
            self.n = int(pk_or_n)
        self.device = resolve_device("cuda" if device is None else device)
        p, q = int(p), int(q)
        if p * q != self.n:
            raise ValueError("PrivateKey ctor: Public key does not match p * q.")
        if p == q:
            raise ValueError("PrivateKey ctor: p and q are same")
        self.p, self.q = (q, p) if q < p else (p, q)
        self.nsquare = self.n * self.n
        self.g = self.n + 1
        self.enable_crt = True
        self.pminusone = self.p - 1
        self.qminusone = self.q - 1
        self.psquare = self.p * self.p
        self.qsquare = self.q * self.q
        with trace.span("keys.private_key"):
            self.pinverse = pow(self.p, -1, self.q)
            self.hp = self._compute_hfun(self.p, self.psquare)
            self.hq = self._compute_hfun(self.q, self.qsquare)
            self.lam = _lcm(self.pminusone, self.qminusone)
            self.x = pow(
                (pow(self.g, self.lam, self.nsquare) - 1) // self.n, -1, self.n
            )
        self._engine_cache: Optional[PrivateEngine] = None

    def _compute_hfun(self, a: int, b: int) -> int:
        """h = L_a(g^(a-1) mod b)^{-1} mod a (ipcl/pri_key.cpp:159-167)."""
        pm = pow(self.g % b, a - 1, b)
        lcrt = (pm - 1) // a
        return pow(lcrt, -1, a)

    @property
    def _engine(self) -> PrivateEngine:
        if self._engine_cache is None:
            self._engine_cache = PrivateEngine(
                self.n, self.p, self.q, self.lam, self.x, self.hp, self.hq,
                device=self.device,
            )
        return self._engine_cache

    def decrypt(self, ct: CipherText) -> PlainText:
        if ct.public_key is not None and ct.public_key.n != self.n:
            raise ValueError("decrypt: The value of N in public key mismatch.")
        if len(ct) == 0:
            raise ValueError("decrypt: Cannot decrypt empty CipherText")
        if self.enable_crt:
            out = self._engine.decrypt_crt_dev(ct.device_payload())
        else:
            out = self._engine.decrypt_raw_dev(ct.device_payload())
        return PlainText(out)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PrivateKey)
            and self.n == other.n
            and self.p == other.p
            and self.q == other.q
        )

    def __repr__(self) -> str:
        return f"PrivateKey(bits={self.n.bit_length()}, crt={self.enable_crt})"


@dataclass
class KeyPair:
    """Keypair container (reference: ipcl.hpp:19-37)."""

    pub_key: PublicKey
    priv_key: PrivateKey
