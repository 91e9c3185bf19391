"""Carry state across from the JAX package: constants and keys.

The functions take numpy arrays and Python ints only, so this module (like
the whole port) imports nothing of JAX; the tests, which import both
packages, hand the JAX package's values over through it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.keys import KeyPair, PrivateKey, PublicKey
from .ops.cuda_rns2 import fb_pack_planes


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype in (np.uint32, np.uint64, np.int64):
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def consts_from_jax(d: dict, device="cpu") -> dict:
    """A dict of numpy arrays from the JAX package -> the port's tensors:
    ``stack_group_consts2`` / ``fold_group_consts2`` output or
    ``RNSContext.device_consts()`` (unsigned 32-bit arrays become int32,
    int8 planes and float32 constants keep their type — the f32-reciprocal
    ``mu`` rows of the CRT sets and of every wide-pool set, i.e. n^2 of
    3072- and 4096-bit keys, stay float32, so the port reads the set's
    reduction flavor and fold off the carried-over arrays as it does off
    its own)."""
    return {key: _tensor(v, device) for key, v in d.items()}


def fb_table_from_jax(planes, device="cpu") -> torch.Tensor:
    """The JAX package's ``fb_table_stage`` planes (tAlo, tAhi, tBlo, tBhi),
    each [1, NP, 256, w] int8, recombined as ``lo + (hi << 7)`` and packed
    into the port's table of ``fb_modexp2`` (the B fragments of its one-hot
    gather, ``ops/cuda_rns2.fb_pack_planes``)."""
    tAlo, tAhi, tBlo, tBhi = (np.asarray(p, np.int32)[0] for p in planes)
    tab = np.concatenate([tAlo + (tAhi << 7), tBlo + (tBhi << 7)], axis=-1)
    return fb_pack_planes(_tensor(tab, device))


def mont_consts_from_jax(n, n0inv, r2, one, device="cpu"):
    """The JAX package's ``MontConstants.as_device_args()`` (as numpy arrays,
    or stacks of them for G moduli) -> the port's int32 tensors
    ``(n, n0inv, r2, one)``, with ``n0inv`` as a ``[G]`` tensor (``[1]`` for
    one modulus), the form the grouped kernels take."""
    n0 = np.asarray(n0inv).reshape(-1)
    return (_tensor(n, device), _tensor(n0, device), _tensor(r2, device),
            _tensor(one, device))


def keys_from_ints(
    n: int, p: int, q: int, hs: Optional[int], randbits: Optional[int],
    device="cuda",
) -> KeyPair:
    """The port's key objects from a JAX-package key's integers (``hs`` and
    ``randbits`` of a DJN key; ``hs=None`` for a normal-mode key)."""
    pk = PublicKey(n, n.bit_length(), hs=hs, randbits=randbits, device=device)
    sk = PrivateKey(pk, p, q, device=device)
    return KeyPair(pk, sk)
