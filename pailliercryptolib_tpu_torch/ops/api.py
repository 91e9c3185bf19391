"""Public batched-modexp API on Python ints (the ipcl::modExp equivalent).

Counterpart of the JAX package's ``ops/api.py``.  Mirrors the reference's
top-level dispatch function
(`ipcl::modExp(vector<BigNumber>, vector<BigNumber>, vector<BigNumber>)`,
ipcl/mod_exp.hpp:72-83): accepts scalars or equal-length lists, supports a
*vector of moduli* by grouping elements that share a modulus into one
batched device call each (the reference pads chunks of 8 to the widest
operand instead, ipcl/mod_exp.cpp:480-516).

Moduli must be odd (a Montgomery-arithmetic requirement, as in the
reference's ippsMontExp backend).  Batches are not padded: the kernel masks
a ragged last row tile itself.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Union

import numpy as np

from . import dispatch
from .limbs import ints_to_limbs, ints_to_windows, limbs_to_ints, num_windows
from .montgomery import MontConstants, to_i32

IntOrList = Union[int, Sequence[int]]


@functools.lru_cache(maxsize=64)
def _mont_cache(modulus: int) -> MontConstants:
    return MontConstants.create(modulus)


def _modexp_group(bases: List[int], exps: List[int], m: int, backend: str, device):
    ctx = _mont_cache(m)
    L = ctx.num_limbs
    ebits = max(1, max(e.bit_length() for e in exps))
    nw = max(8, -(-num_windows(ebits) // 8) * 8)
    base_a = to_i32(ints_to_limbs([b % m for b in bases], L), device)
    wins = to_i32(ints_to_windows(exps, nw * 4), device)
    n, n0inv, r2, one = ctx.as_device_args(device)
    out = dispatch.modexp_backend(base_a, wins, n, n0inv, r2, one, backend)
    return limbs_to_ints(out.cpu().numpy().astype(np.uint32))


def modexp(
    base: IntOrList, exp: IntOrList, mod: IntOrList, backend: str = None,
    device="cuda",
) -> Union[int, List[int]]:
    """base^exp mod mod, elementwise over equal-length vectors (or scalars).

    Per-element moduli are supported: elements are grouped by modulus value
    and each unique modulus runs as one batched device call.  ``backend`` is
    ``"cios"`` or ``"plain"``; by default the process's backend
    (ops/dispatch.default_backend), with ``"rns"`` turned into ``"cios"``:
    a one-shot call should not build RNS contexts.  ``device`` as for the
    engines: ``"cuda"`` raises without a GPU.
    """
    from ..models.engine import resolve_device

    scalar = isinstance(base, int) and isinstance(exp, int) and isinstance(mod, int)
    bases = [base] if isinstance(base, int) else [int(v) for v in base]
    size = len(bases)
    exps = [exp] * size if isinstance(exp, int) else [int(v) for v in exp]
    mods = [mod] * size if isinstance(mod, int) else [int(v) for v in mod]
    if not (len(exps) == size and len(mods) == size):
        raise ValueError("modExp: input vector sizes mismatch")
    for m in mods:
        if m <= 0 or m % 2 == 0:
            raise ValueError("modExp: moduli must be positive odd integers")
    backend = dispatch.check_backend(backend) if backend else dispatch.default_backend()
    if backend == "rns":
        backend = "cios"
    device = resolve_device(device)

    groups = {}
    for i, m in enumerate(mods):
        groups.setdefault(m, []).append(i)

    out: List[int] = [0] * size
    for m, idxs in groups.items():
        res = _modexp_group(
            [bases[i] for i in idxs], [exps[i] for i in idxs], m, backend, device
        )
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out[0] if scalar else out
