"""Traffic op ``decrypt``: batches of ciphertexts, uniform elements of
Z*_{n^2} handed over as host ints, decrypted by the CRT.

The program's entry: ``PrivateEngine.decrypt_crt_dev`` (models/engine.py)
on host ints, so the upload is part of the call, then ``DevLimbs.fetch``:
the call chain under ``PrivateKey.decrypt``.  The key's constants (lambda,
x, hp, hq) are the program's own, from its ``PrivateKey``.  The reference:
``pow()`` by the CRT (reference/paillier.py).
"""

from __future__ import annotations

from .. import generator
from ..reference import paillier


class Op:
    def __init__(self, key, config, traffic, seed, device):
        self.key, self.config, self.traffic = key, config, traffic
        self.seed, self.device = seed, device
        self.eng = None
        self.pool = None

    def key_setup(self):
        """The engine with its constants (the p^2 / q^2 RNS contexts)."""
        from pailliercryptolib_tpu_torch.models.engine import PrivateEngine
        from pailliercryptolib_tpu_torch.models.keys import PrivateKey

        k = self.key
        sk = PrivateKey(k.n, k.p, k.q, device=self.device)
        self.eng = PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                                 backend=self.config["backend"], device=self.device)
        self.eng.rns_crt

    def make_inputs(self):
        self.pool = generator.cipher_pool(self.seed, self.traffic, self.key.n)

    def ciphertexts(self, i):
        return self.pool[i % len(self.pool)]

    def submit(self, i):
        return self.eng.decrypt_crt_dev(self.ciphertexts(i))

    @staticmethod
    def fetch(handle):
        return handle.fetch()

    def release(self):
        self.eng = None

    def reference(self, control: bool):
        return paillier.control_decrypt_crt_row if control else paillier.decrypt_crt_row

    def job(self, i, row):
        return (self.key.p, self.key.q, self.ciphertexts(i)[row])
