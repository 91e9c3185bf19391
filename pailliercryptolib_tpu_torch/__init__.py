"""pailliercryptolib_tpu_torch — the PyTorch/CUDA port of pailliercryptolib_tpu.

A second package beside the JAX one, for one NVIDIA Hopper GPU: tensors are
torch tensors on an explicit ``device`` (default ``"cuda"``), and every
kernel the JAX package wrote in Pallas is a CUDA C++ kernel written by hand
for sm_90a (``csrc/``), compiled at first use (``ops/_build.py``).  It
imports ``torch`` and ``numpy`` only.

Ported so far, for keys up to 4096 bits (the reference's cap): keygen, DJN
and normal-mode encryption, CRT and RAW decryption, CT+CT, CT+PT, CT*PT and
``apply_obfuscator``, on the ``"rns"`` (default), ``"cios"`` and ``"plain"``
backends; the batched ``modexp`` on Python ints; the hybrid batch split
(``HybridMode``, ``set_hybrid_mode`` / ``set_hybrid_ratio`` /
``set_hybrid_off``); and serialization in the reference's cereal layout
(``utils.serialize``, not exported at this level, as in the JAX package).

    >>> import pailliercryptolib_tpu_torch as ptorch
    >>> key = ptorch.generate_keypair(2048, enable_DJN=True)  # device="cuda"
    >>> ct = key.pub_key.encrypt(ptorch.PlainText([1, 2, 3]))
    >>> key.priv_key.decrypt(ct).texts
    [1, 2, 3]
"""

from .models.keygen import generate_keypair, get_prime
from .models.keys import KeyPair, PrivateKey, PublicKey
from .models.texts import BaseText, CipherText, PlainText
from .ops.api import modexp
from .ops.dispatch import (
    HybridMode,
    get_hybrid_mode,
    get_hybrid_ratio,
    set_hybrid_mode,
    set_hybrid_off,
    set_hybrid_ratio,
)

__version__ = "0.1.0"

__all__ = [
    "BaseText",
    "CipherText",
    "KeyPair",
    "PlainText",
    "PrivateKey",
    "PublicKey",
    "generate_keypair",
    "get_prime",
    "modexp",
    "HybridMode",
    "get_hybrid_mode",
    "get_hybrid_ratio",
    "set_hybrid_mode",
    "set_hybrid_off",
    "set_hybrid_ratio",
    "__version__",
]
