"""Traffic op ``encrypt``: batches of plaintexts encrypted under the
configuration's key, DJN or normal mode, with the obfuscator randoms
expanded on the device from a 44-byte seed a batch.

The program's entry: ``PublicEngine.encrypt_djn_dev`` / ``encrypt_normal_dev``
(models/engine.py), then ``DevLimbs.fetch``: the call chain under
``PublicKey.encrypt`` and ``CipherText.texts``.  The reference: ``pow()``
over the seed's ChaCha20 keystream (reference/paillier.py).
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
        """The engine with its constants (RNS contexts; for DJN the
        fixed-base table), built at its first use."""
        from pailliercryptolib_tpu_torch.models.engine import PublicEngine

        k = self.key
        self.eng = PublicEngine(k.n, k.nbits, k.hs, k.randbits,
                                backend=self.config["backend"], device=self.device)
        self.eng.rns
        if k.djn:
            self.eng.fixedbase
            self.eng.fb_mask

    def make_inputs(self):
        self.pool = generator.plain_pool(self.seed, self.traffic)

    def plaintexts(self, i):
        return self.pool[i % len(self.pool)]

    def submit(self, i):
        from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

        r = DeviceSeed(generator.seed_words(self.seed, i))
        m = self.plaintexts(i)
        if self.key.djn:
            return self.eng.encrypt_djn_dev(m, r)
        return self.eng.encrypt_normal_dev(m, r)

    @staticmethod
    def fetch(handle):
        return handle.fetch()

    def release(self):
        self.eng = None

    def reference(self, control: bool):
        if self.key.djn:
            return paillier.control_encrypt_djn_row if control else paillier.encrypt_djn_row
        return paillier.control_encrypt_normal_row if control else paillier.encrypt_normal_row

    def job(self, i, row):
        """The reference's arguments for row ``row`` of batch i."""
        k, words, m = self.key, generator.seed_words(self.seed, i), self.plaintexts(i)[row]
        if k.djn:
            return (k.n, k.hs, k.randbits, words, row, m)
        return (k.n, words, row, m)
