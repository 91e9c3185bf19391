"""pailliercryptolib_tpu_torch — the PyTorch/CUDA port of pailliercryptolib_tpu.

A second package beside the JAX one, for one NVIDIA Hopper GPU: tensors are
torch tensors on an explicit ``device`` (default ``"cuda"``), and every
kernel the JAX package wrote in Pallas is a CUDA C++ kernel written by hand
for sm_90a (``csrc/``), compiled at first use (``ops/_build.py``).  It
imports ``torch`` and ``numpy`` only.

Ported so far: keygen, DJN encryption and CRT decryption for keys up to
2048 bits.  Other entry points raise ``NotImplementedError``.

    >>> import pailliercryptolib_tpu_torch as ptorch
    >>> key = ptorch.generate_keypair(2048, enable_DJN=True)  # device="cuda"
    >>> ct = key.pub_key.encrypt(ptorch.PlainText([1, 2, 3]))
    >>> key.priv_key.decrypt(ct).texts
    [1, 2, 3]
"""

from .models.keygen import generate_keypair, get_prime
from .models.keys import KeyPair, PrivateKey, PublicKey
from .models.texts import BaseText, CipherText, PlainText

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
    "__version__",
]
