"""CIOS limb kernels for Hopper, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_modexp.py``: its three
kernels on 15-bit limbs, all built on one device function for the
redundant-digit Montgomery product (``csrc/cios_mont_mul.cuh``).

====================  ========================  =============================
wrapper               plain version             source
====================  ========================  =============================
``mod_mul``           ``mod_mul_plain``         ``csrc/mod_mul.cu``
``modexp``            ``modexp_plain``          ``csrc/modexp.cu``
``mont_raw``          ``mont_raw_plain``        ``csrc/mont_raw.cu``
====================  ========================  =============================

``mod_mul`` is the grouped modular product a*b mod n: two Montgomery
products through R^2, a carry resolve and a conditional subtract (plain
form: ops/montgomery.mont_mod_mul).  ``modexp`` is the grouped windowed
modexp base^e mod n (plain form: ops/montgomery.mont_exp).  ``mont_raw`` is
the grouped raw Montgomery product a*b*R^{-1} mod n with redundant digits
and no final subtract (plain form: ops/montgomery.mont_mul).  Together they
are the ``"cios"`` backend (ops/dispatch.py); ``mod_mul`` also ends the
decrypt paths of the ``"rns"`` backend.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.  ``mod_mul`` and ``modexp`` return canonical,
fully reduced limbs; ``mont_raw`` keeps the plain version's digit schedule:
kernel and plain version agree bit for bit in all three.
"""

from __future__ import annotations

import torch

from . import _build
from .montgomery import mont_exp, mont_mod_mul, mont_mul

_I32 = torch.int32

#: Launch counts of the CUDA kernels.
LAUNCHES = {"mod_mul": 0, "modexp": 0, "mont_raw": 0}

#: Widest operand the kernels as compiled take (csrc/cios_mont_mul.cuh):
#: n^2 of a 4096-bit key.
KERNEL_MAX_L = 547


def _check_consts(a, consts):
    """``a`` [G, B, L] and the per-group constants: int32, on a's device, of
    the shapes given."""
    for name, t, shape in consts:
        if t.dtype != _I32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name} lies on {t.device}, expected {a.device}")


def _strided(name, t, a, shape):
    """``t`` broadcast to ``shape`` as (tensor, group stride, row stride) in
    elements with a unit last stride.  A broadcast dimension keeps its
    stride of 0: the kernel reads the one row for every row."""
    if t.dtype != _I32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != a.device:
        raise ValueError(f"{name} lies on {t.device}, expected {a.device}")
    t = t.expand(shape)
    if shape[-1] > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def _check_width(L: int) -> None:
    if L > KERNEL_MAX_L:
        raise NotImplementedError(
            f"{L} limbs exceed the kernel's {KERNEL_MAX_L}"
        )


def mod_mul_plain(a, b, n, n0inv, r2):
    """Plain version of :func:`mod_mul`."""
    return mont_mod_mul(a, b, n[:, None, :], n0inv, r2[:, None, :])


def mod_mul(a, b, n, n0inv, r2):
    """K4: grouped plain modular product a*b mod n, canonical reduced.

    a [G, B, L] int32 limbs, value < R; b [G, B, L] or broadcastable to it;
    n, r2 [G, L]; n0inv [G] (all int32).  Returns [G, B, L] int32."""
    if a.ndim != 3:
        raise ValueError("a: expected [G, B, L]")
    G, B, L = a.shape
    _check_consts(a, (("a", a, (G, B, L)), ("n", n, (G, L)), ("r2", r2, (G, L)),
                      ("n0inv", n0inv, (G,))))
    b, b_gs, b_bs = _strided("b", b, a, (G, B, L))
    if a.device.type == "cpu":
        return mod_mul_plain(a, b, n, n0inv, r2)
    _check_width(L)
    a = a.contiguous()
    n, r2, n0inv = n.contiguous(), r2.contiguous(), n0inv.contiguous()
    out = torch.empty((G, B, L), dtype=_I32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.mod_mul_launch(
            a.data_ptr(), b.data_ptr(), b_gs, b_bs, n.data_ptr(),
            n0inv.data_ptr(), r2.data_ptr(), out.data_ptr(), G, B, L,
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "mod_mul")
    LAUNCHES["mod_mul"] += 1
    return out


def mont_raw_plain(a, b, n, n0inv):
    """Plain version of :func:`mont_raw`."""
    return mont_mul(a, b, n[:, None, :], n0inv)


def mont_raw(a, b, n, n0inv):
    """K7: grouped raw Montgomery product a*b*R^{-1} mod n.

    a [G, B, L] int32 digits <= 2**15; b [G, B, L] or broadcastable to it;
    n [G, L]; n0inv [G].  Returns [G, B, L] int32 digits <= 2**15 of a value
    < 2n (a representative, not reduced), digit for digit the plain
    version's."""
    if a.ndim != 3:
        raise ValueError("a: expected [G, B, L]")
    G, B, L = a.shape
    _check_consts(a, (("a", a, (G, B, L)), ("n", n, (G, L)),
                      ("n0inv", n0inv, (G,))))
    b, b_gs, b_bs = _strided("b", b, a, (G, B, L))
    if a.device.type == "cpu":
        return mont_raw_plain(a, b, n, n0inv)
    _check_width(L)
    a = a.contiguous()
    n, n0inv = n.contiguous(), n0inv.contiguous()
    out = torch.empty((G, B, L), dtype=_I32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.mont_raw_launch(
            a.data_ptr(), b.data_ptr(), b_gs, b_bs, n.data_ptr(),
            n0inv.data_ptr(), out.data_ptr(), G, B, L,
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "mont_raw")
    LAUNCHES["mont_raw"] += 1
    return out


def modexp_plain(base, windows, n, n0inv, r2, one):
    """Plain version of :func:`modexp`."""
    return mont_exp(
        base, windows, n[:, None, :], n0inv, r2[:, None, :], one[:, None, :]
    )


def modexp(base, windows, n, n0inv, r2, one):
    """K6: grouped windowed modexp base^e mod n, canonical reduced.

    base [G, B, L] int32 limbs (value < R), or broadcastable to it: a shared
    base [G, 1, L] is read by every row, not copied.  windows [G, B, NW] or
    [G, 1, NW] (one exponent for the group's rows), 4-bit windows, most
    significant first.  n, r2, one [G, L]; n0inv [G] (all int32).  Returns
    [G, B, L] int32.  B is the larger of base's and windows' batch sizes."""
    if base.ndim != 3 or windows.ndim != 3:
        raise ValueError("base, windows: expected [G, B|1, L] and [G, B|1, NW]")
    G, L = base.shape[0], base.shape[-1]
    B = max(base.shape[1], windows.shape[1])
    NW = windows.shape[-1]
    _check_consts(base, (("n", n, (G, L)), ("r2", r2, (G, L)), ("one", one, (G, L)),
                         ("n0inv", n0inv, (G,))))
    if base.device.type == "cpu" and windows.device.type == "cpu":
        # unexpanded: a shared base gets one power table for the batch
        return modexp_plain(base, windows, n, n0inv, r2, one)
    base, base_gs, base_bs = _strided("base", base, base, (G, B, L))
    windows, win_gs, win_bs = _strided("windows", windows, base, (G, B, NW))
    _check_width(L)
    n, r2, one = n.contiguous(), r2.contiguous(), one.contiguous()
    n0inv = n0inv.contiguous()
    lib = _build.load()
    out = torch.empty((G, B, L), dtype=_I32, device=base.device)
    # the rows' power tables: scratch, written before it is read
    table = torch.empty(
        (lib.modexp_table_words(G, B, L),), dtype=_I32, device=base.device
    )
    with torch.cuda.device(base.device):
        err = lib.modexp_launch(
            base.data_ptr(), base_gs, base_bs, windows.data_ptr(), win_gs, win_bs,
            n.data_ptr(), n0inv.data_ptr(), r2.data_ptr(), one.data_ptr(),
            out.data_ptr(), table.data_ptr(), G, B, L, NW,
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, "modexp")
    LAUNCHES["modexp"] += 1
    return out
