"""CIOS limb kernels for Hopper, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_modexp.py``.  Of its three
kernels this module ports the one the CRT-decrypt tail runs:

====================  ========================  =============================
wrapper               plain version             source
====================  ========================  =============================
``mod_mul``           ``mod_mul_plain``         ``csrc/mod_mul.cu``
====================  ========================  =============================

``mod_mul`` is the grouped modular product a*b mod n on 15-bit limbs: two
redundant-digit CIOS Montgomery products through R^2, a carry resolve and a
conditional subtract (plain form: ops/montgomery.mont_mod_mul).  The
windowed CIOS modexp and the raw Montgomery product of the reference are
not ported yet (ROADMAP K6, K7).

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.  Output is canonical and fully reduced,
so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from . import _build
from .montgomery import mont_mod_mul

_I32 = torch.int32

#: Launch count of the CUDA kernel.
LAUNCHES = {"mod_mul": 0}

#: Widest operand the kernel as compiled takes (csrc/mod_mul.cu).
KERNEL_MAX_L = 160


def mod_mul_plain(a, b, n, n0inv, r2):
    """Plain version of :func:`mod_mul`."""
    return mont_mod_mul(a, b, n[:, None, :], n0inv, r2[:, None, :])


def mod_mul(a, b, n, n0inv, r2):
    """K4: grouped plain modular product a*b mod n, canonical reduced.

    a [G, B, L] int32 canonical limbs; b [G, B, L] or broadcastable to it;
    n, r2 [G, L]; n0inv [G] (all int32).  Returns [G, B, L] int32."""
    if a.ndim != 3:
        raise ValueError("a: expected [G, B, L]")
    G, B, L = a.shape
    for name, t, shape in (
        ("a", a, (G, B, L)), ("n", n, (G, L)), ("r2", r2, (G, L)),
        ("n0inv", n0inv, (G,)),
    ):
        if t.dtype != _I32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name} lies on {t.device}, expected {a.device}")
    if b.dtype != _I32:
        raise TypeError(f"b: expected int32, got {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"b lies on {b.device}, expected {a.device}")
    if a.device.type == "cpu":
        return mod_mul_plain(a, b, n, n0inv, r2)
    if L > KERNEL_MAX_L:
        raise NotImplementedError(
            f"{L} limbs exceed the kernel's {KERNEL_MAX_L}"
        )
    a = a.contiguous()
    b = b.expand(G, B, L).contiguous()
    n, r2, n0inv = n.contiguous(), r2.contiguous(), n0inv.contiguous()
    out = torch.empty((G, B, L), dtype=_I32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.mod_mul_launch(
            a.data_ptr(), b.data_ptr(), n.data_ptr(), n0inv.data_ptr(),
            r2.data_ptr(), out.data_ptr(), G, B, L,
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "mod_mul")
    LAUNCHES["mod_mul"] += 1
    return out
