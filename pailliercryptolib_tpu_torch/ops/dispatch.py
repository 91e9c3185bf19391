"""Backend dispatch for the batched modexp primitive.

Counterpart of the JAX package's ``ops/dispatch.py``: the analog of the
reference's single dispatch seam ``ipcl::modExp`` (ipcl/mod_exp.cpp:680-737),
which routes between the QAT offload runtime and the AVX512 multi-buffer
CPU path with a tunable hybrid ratio.  Here the backends are:

* ``"rns"``    the residue-number-system kernels (ops/cuda_rns2.py), the
               default; the engines run it without passing through here
* ``"cios"``   the 15-bit-limb CIOS Montgomery kernels (ops/cuda_modexp.py):
               a complete second implementation of every operation, and
               width-generic (the JAX package's ``"pallas"``)
* ``"plain"``  plain PyTorch (ops/montgomery.py) on the engine's device (the
               JAX package's ``"xla"``): only when asked for by name, or
               for the tail of a batch under a hybrid ratio below 1

plus the IPCL-compatible hybrid-mode knobs (``set_hybrid_mode`` /
``set_hybrid_ratio`` / ``set_hybrid_off``, mod_exp.hpp:16-48): a fractional
split of the batch between a kernel backend and the plain one, kept as an
API and policy seam.

The routers take CPU or CUDA tensors.  On a CPU tensor the ``"cios"``
wrappers run their plain versions; on a CUDA tensor they launch or raise.
"""

from __future__ import annotations

import enum
import os
import threading

from .cuda_modexp import mod_mul, modexp, mont_raw
from .montgomery import mont_exp, mont_mod_mul, mont_mul, to_i32

BACKENDS = ("rns", "cios", "plain")


class HybridMode(enum.IntEnum):
    """Mirrors ipcl::HybridMode (mod_exp.hpp:15-29) value-for-value, with the
    member names of the JAX package; a member's value is the percent of the
    batch routed to the *primary* backend (the engine's kernel backend, the
    reference's QAT analog); the rest runs on the plain fallback (the
    reference's IPP analog, the JAX package's XLA path)."""

    OPTIMAL = 95  # per-op tuned ratios, workload-size gated
    FULL = 100  # reference "QAT": everything on the kernel backend
    PREF_KERNEL90 = 90
    PREF_KERNEL80 = 80
    PREF_KERNEL70 = 70
    PREF_KERNEL60 = 60
    HALF = 50
    PREF_XLA60 = 40
    PREF_XLA70 = 30
    PREF_XLA80 = 20
    PREF_XLA90 = 10
    XLA = 0  # reference "IPP": everything on the plain fallback
    UNDEFINED = -1  # manual ratio in force (set_hybrid_ratio)


#: Workload size above which OPTIMAL mode applies the per-op ratio
#: (ipcl/utils/common.hpp:18: IPCL_WORKLOAD_SIZE_THRESHOLD).
WORKLOAD_SIZE_THRESHOLD = 128

#: Per-op OPTIMAL ratios: fraction of the batch on the kernel backend.  No
#: split has been measured on the H100 yet; until one is, everything stays
#: on the kernel backend.
OPTIMAL_RATIOS = {"encrypt": 1.0, "decrypt": 1.0, "multiply": 1.0}
HYBRID_RATIO_FULL = 1.0


class _HybridParams(threading.local):
    def __init__(self):
        self.mode: HybridMode = HybridMode.OPTIMAL
        self.ratio: float = 1.0


_params = _HybridParams()


def set_hybrid_mode(mode: HybridMode) -> None:
    _params.mode = mode
    _params.ratio = max(int(mode), 0) / 100.0


def set_hybrid_ratio(ratio: float, reset_mode: bool = True) -> None:
    """Route ``ratio`` of every batch to the kernel backend (the reference's
    setHybridRatio, mod_exp.cpp:35-42)."""
    if not 0.0 <= ratio <= 1.0:
        raise ValueError("hybrid ratio must be in [0, 1]")
    _params.ratio = ratio
    if reset_mode:
        _params.mode = HybridMode.UNDEFINED


def set_hybrid_off() -> None:
    """Back to the single-backend default (OPTIMAL policy).  The reference's
    setHybridOff disables its accelerator (ratio 0); here the accelerator IS
    the platform, so "off" means "no manual split"."""
    _params.mode = HybridMode.OPTIMAL
    _params.ratio = 1.0


def get_hybrid_ratio() -> float:
    return _params.ratio


def get_hybrid_mode() -> HybridMode:
    return _params.mode


def is_hybrid_optimal() -> bool:
    return _params.mode == HybridMode.OPTIMAL


def hybrid_head_count(op: str, size: int, backend: str) -> int:
    """Rows of a ``size``-row batch to run on the primary (kernel) backend;
    the rest goes to the plain fallback pipeline.

    The reference's split point (ipcl/mod_exp.cpp:688-732) with its per-op
    OPTIMAL policy (isHybridOptimal branches at pub_key.cpp:119-125,
    pri_key.cpp:76-82, ciphertext.cpp:153-159).  Truncation matches the
    reference's static_cast<size_t>(ratio * size).
    """
    if backend == "plain":
        return size  # the primary IS the fallback: nothing to split
    if _params.mode == HybridMode.OPTIMAL:
        ratio = (
            OPTIMAL_RATIOS.get(op, HYBRID_RATIO_FULL)
            if size > WORKLOAD_SIZE_THRESHOLD
            else HYBRID_RATIO_FULL
        )
    else:
        ratio = _params.ratio
    return size if ratio >= 1.0 else int(ratio * size)


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}: expected one of {', '.join(BACKENDS)}"
        )
    return backend


def default_backend() -> str:
    """The backend of this process when none is given: runtime config
    (utils/config.set_config, or the PAILLIER_TORCH_BACKEND environment
    variable it loads) > ``"rns"``."""
    from ..utils.config import get_config

    # Config snapshots the environment once at first access; re-read the
    # variable when no backend is pinned so that a late os.environ change
    # (common in tests) still takes effect per call.
    forced = get_config().backend or os.environ.get("PAILLIER_TORCH_BACKEND")
    return check_backend(forced) if forced else "rns"


def _n0_tensor(n0inv, like):
    """n0inv (an int or a 0-d / [1] tensor) as a [1] int32 tensor."""
    if isinstance(n0inv, int):
        return to_i32([n0inv], like.device)
    return n0inv.reshape(1)


def _n0_scalar(n0inv):
    """n0inv of one modulus (an int or a 0-d / [1] tensor) as something that
    broadcasts against any batch shape."""
    if isinstance(n0inv, int):
        return n0inv
    return n0inv.reshape(())


def _check_routed(backend: str) -> None:
    if backend not in ("cios", "plain"):
        raise ValueError(
            f"backend {backend!r} has no CIOS pipeline: expected 'cios' or 'plain'"
        )


def modexp_backend(base, windows, n, n0inv, r2, one, backend: str):
    """Route one modexp to the chosen backend.

    base: [B, L] or [L] (shared); windows: [B, NW] or [1, NW] (shared);
    n/r2/one: [L]; n0inv an int (or [1] tensor).  Returns canonical [B, L].
    A shared base or exponent is not copied: the kernel reads the one row.
    """
    _check_routed(backend)
    if backend == "plain":
        return mont_exp(base, windows, n, _n0_scalar(n0inv), r2, one)
    if base.ndim == 1:
        base = base[None]
    return modexp(
        base[None], windows[None], n[None], _n0_tensor(n0inv, n), r2[None],
        one[None],
    )[0]


def modexp_backend_grouped(base, windows, n, n0inv, r2, one, backend: str):
    """Grouped variant: base [G, B, L], windows [G, 1|B, NW], consts [G, ...].

    Used by CRT decryption (G=2: the p^2 / q^2 residue systems)."""
    _check_routed(backend)
    if backend == "plain":
        return mont_exp(
            base, windows, n[:, None, :], n0inv, r2[:, None, :], one[:, None, :]
        )
    return modexp(base, windows, n, n0inv, r2, one)


def mod_mul_backend(a, b, n, n0inv, r2, backend: str):
    """Plain modular product a*b mod n, canonical output.  a, b: [B, L] (b may
    be [L], shared); n/r2: [L]; n0inv an int (or [1] tensor)."""
    _check_routed(backend)
    if backend == "plain":
        return mont_mod_mul(a, b, n, _n0_scalar(n0inv), r2)
    return mod_mul(a[None], b, n[None], _n0_tensor(n0inv, n), r2[None])[0]


def mod_mul_backend_grouped(a, b, n, n0inv, r2, backend: str):
    """Grouped variant: a [G, B, L], b [G, B|1, L], consts [G, ...]."""
    _check_routed(backend)
    if backend == "plain":
        return mont_mod_mul(a, b, n[:, None, :], n0inv, r2[:, None, :])
    return mod_mul(a, b, n, n0inv, r2)


def mont_raw_backend_grouped(a, b, n, n0inv, backend: str):
    """Grouped raw Montgomery product a*b*R^{-1} mod n (redundant digits,
    value < 2n).  a [G, B, L], b [G, B|1, L]."""
    _check_routed(backend)
    if backend == "plain":
        return mont_mul(a, b, n[:, None, :], n0inv)
    return mont_raw(a, b, n, n0inv)
