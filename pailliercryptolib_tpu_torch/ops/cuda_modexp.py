"""CIOS kernels for Hopper, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_modexp.py``: its three
kernels, which take and return 15-bit limbs.

====================  ========================  =============================
wrapper               plain version             source
====================  ========================  =============================
``mod_mul``           ``mod_mul_plain``         ``csrc/mod_mul.cu``
``modexp``            ``modexp_plain``          ``csrc/modexp.cu``
``mont_raw``          ``mont_raw_plain``        ``csrc/mont_raw.cu``
====================  ========================  =============================

``mod_mul`` is the grouped modular product a*b mod n (plain form:
ops/montgomery.mont_mod_mul).  ``modexp`` is the grouped windowed modexp
base^e mod n (plain form: ops/montgomery.mont_exp).  ``mont_raw`` is the
grouped raw Montgomery product a*b*R^{-1} mod n, R = 2^(15 L) (plain form:
ops/montgomery.mont_mul).  Together they are the ``"cios"`` backend
(ops/dispatch.py); ``mod_mul`` also ends the decrypt paths of the ``"rns"``
backend.

All three convert their 15-bit limbs into 32-bit words inside the kernel
and multiply on them (``csrc/cios_mont_mul32.cuh``: L32 = ceil((15 L + 2) /
32) words, a product L32^2 word steps instead of L^2 limb steps), and take
the interface's 15-bit constants: ``modexp`` derives its 32-bit Montgomery
constants from them by doublings; ``mod_mul`` and ``mont_raw`` need none, as
they read an operand already multiplied by 2^d, d = 32 L32 - 15 L (so that
mont32(a 2^d, r2) = a R15 mod n, and mont32(a 2^d, b) = a b R15^-1 mod n).
:func:`modexp_w32_walk`, :func:`mod_mul_w32_walk` and
:func:`mont_raw_w32_walk` walk those schedules — lanes, lazy carries,
ballots — in plain PyTorch for the CPU tests.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.  ``mod_mul`` and ``modexp`` return canonical,
fully reduced limbs, so kernel and plain version agree bit for bit.
``mont_raw``'s contract is a value < 2n congruent to a*b*R^-1 with digits
<= 2^15 (the reference's): the plain version returns the reference's
redundant digits, the kernel the canonical value below n, so the kernel
equals ``cond_sub_n(canonicalize(mont_raw_plain(...)))`` bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from .montgomery import mont_exp, mont_mod_mul, mont_mul

_I32 = torch.int32

#: Launch counts of the CUDA kernels.
LAUNCHES = {"mod_mul": 0, "modexp": 0, "mont_raw": 0}

#: Lanes that work on one row of the 32-bit kernels (csrc/cios_mont_mul32.cuh
#: ``ROW_LANES``: two rows a warp).
ROW_LANES = 16

#: Widest operand the kernels as compiled take (csrc/cios_mont_mul32.cuh
#: ``MAX_L``): n^2 of a 4096-bit key.
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


def _binary_args(a, b, consts):
    """Checks of K4 / K7: ``a`` [G, B, L], ``b`` broadcast to it through its
    strides, the per-group constants; returns (b, b_gs, b_bs)."""
    if a.ndim != 3:
        raise ValueError("a: expected [G, B, L]")
    G, B, L = a.shape
    shapes = {"n": (G, L), "r2": (G, L), "n0inv": (G,)}
    _check_consts(a, [("a", a, (G, B, L))]
                  + [(k, t, shapes[k]) for k, t in consts.items()])
    return _strided("b", b, a, (G, B, L))


def _binary_launch(kernel, a, b, b_gs, b_bs, consts):
    """Launch K4 (``kernel`` "mod_mul": consts n, r2) or K7 ("mont_raw": n)
    on CUDA tensors; the kernels derive their 32-bit n0inv themselves."""
    if a.device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel runs on CUDA tensors")
    G, B, L = a.shape
    _check_width(L)
    a = a.contiguous()
    consts = [t.contiguous() for t in consts]
    out = torch.empty((G, B, L), dtype=_I32, device=a.device)
    with torch.cuda.device(a.device):
        err = getattr(_build.load(), f"{kernel}_launch")(
            a.data_ptr(), b.data_ptr(), b_gs, b_bs,
            *(t.data_ptr() for t in consts), out.data_ptr(), G, B, L,
            _build.current_stream_ptr(),
        )
    _build.check_launch(err, kernel)
    return out


def mod_mul(a, b, n, n0inv, r2):
    """K4: grouped plain modular product a*b mod n, canonical reduced.

    a [G, B, L] int32 limbs of values < R = 2^(15 L); b [G, B, L] or
    broadcastable to it (a shared row is read through a stride of 0), values
    < R; n, r2 [G, L]; n0inv [G] (all int32, the 15-bit constants).  Returns
    [G, B, L] int32.  On CUDA tensors the 32-bit form of the kernel runs at
    every L up to :data:`KERNEL_MAX_L`."""
    with trace.span("kernels.k4"):
        consts = {"n": n, "n0inv": n0inv, "r2": r2}
        b, b_gs, b_bs = _binary_args(a, b, consts)
        if a.device.type == "cpu":
            return mod_mul_plain(a, b, n, n0inv, r2)
        out = _binary_launch("mod_mul", a, b, b_gs, b_bs, (n, r2))
        LAUNCHES["mod_mul"] += 1
        return out


def mont_raw_plain(a, b, n, n0inv):
    """Plain version of :func:`mont_raw`: the reference's redundant digits
    (value < 2n), the canonical value of which the kernel returns."""
    return mont_mul(a, b, n[:, None, :], n0inv)


def mont_raw(a, b, n, n0inv):
    """K7: grouped raw Montgomery product a*b*R^{-1} mod n, R = 2^(15 L).

    a [G, B, L] int32 digits <= 2**15 of values < R; b [G, B, L] or
    broadcastable to it, values < R, a*b < R*n; n [G, L]; n0inv [G].
    Returns [G, B, L] int32 digits <= 2**15 of a value < 2n congruent to
    a*b*R^-1: on CUDA tensors the canonical value < n (the 32-bit kernel),
    on CPU tensors the plain version's redundant digits."""
    with trace.span("kernels.k7"):
        consts = {"n": n, "n0inv": n0inv}
        b, b_gs, b_bs = _binary_args(a, b, consts)
        if a.device.type == "cpu":
            return mont_raw_plain(a, b, n, n0inv)
        out = _binary_launch("mont_raw", a, b, b_gs, b_bs, (n,))
        LAUNCHES["mont_raw"] += 1
        return out


def modexp_plain(base, windows, n, n0inv, r2, one):
    """Plain version of :func:`modexp`."""
    return mont_exp(
        base, windows, n[:, None, :], n0inv, r2[:, None, :], one[:, None, :]
    )


def _modexp_args(base, windows, n, n0inv, r2, one):
    """Checks of :func:`modexp`; returns (G, B, L, NW)."""
    if base.ndim != 3 or windows.ndim != 3:
        raise ValueError("base, windows: expected [G, B|1, L] and [G, B|1, NW]")
    G, L = base.shape[0], base.shape[-1]
    B = max(base.shape[1], windows.shape[1])
    _check_consts(base, (("n", n, (G, L)), ("r2", r2, (G, L)), ("one", one, (G, L)),
                         ("n0inv", n0inv, (G,))))
    return G, B, L, windows.shape[-1]


def modexp(base, windows, n, n0inv, r2, one):
    """K6: grouped windowed modexp base^e mod n, canonical reduced.

    base [G, B, L] int32 limbs (value < R), or broadcastable to it: a shared
    base [G, 1, L] is read by every row, not copied.  windows [G, B, NW] or
    [G, 1, NW] (one exponent for the group's rows), 4-bit windows, most
    significant first.  n, r2, one [G, L]; n0inv [G] (all int32, the 15-bit
    constants).  Returns [G, B, L] int32.  B is the larger of base's and
    windows' batch sizes.  On CUDA tensors the 32-bit form of the kernel
    runs at every L up to :data:`KERNEL_MAX_L`."""
    with trace.span("kernels.k6"):
        G, B, L, NW = _modexp_args(base, windows, n, n0inv, r2, one)
        if base.device.type == "cpu" and windows.device.type == "cpu":
            # unexpanded: a shared base gets one power table for the batch
            return modexp_plain(base, windows, n, n0inv, r2, one)
        if base.device.type != "cuda":
            raise ValueError("modexp: the kernel runs on CUDA tensors")
        base, base_gs, base_bs = _strided("base", base, base, (G, B, L))
        windows, win_gs, win_bs = _strided("windows", windows, base, (G, B, NW))
        _check_width(L)
        n, r2, one = n.contiguous(), r2.contiguous(), one.contiguous()
        lib = _build.load()
        out = torch.empty((G, B, L), dtype=_I32, device=base.device)
        # the rows' power tables: scratch, written before it is read
        table = torch.empty((lib.modexp_table_words(G, B, L),), dtype=_I32, device=base.device)
        with torch.cuda.device(base.device):
            err = lib.modexp_launch(
                base.data_ptr(), base_gs, base_bs, windows.data_ptr(), win_gs, win_bs,
                n.data_ptr(), r2.data_ptr(), one.data_ptr(), out.data_ptr(),
                table.data_ptr(), G, B, L, NW, _build.current_stream_ptr(),
            )
        _build.check_launch(err, "modexp")
        LAUNCHES["modexp"] += 1
        return out


# ---------------------------------------------------------------------------
# The 32-bit schedule of K6, walked in plain PyTorch
# ---------------------------------------------------------------------------
#
# Words are int64 tensors [..., rows, TPI, W] with values below 2^32: word w
# of a row is [..., w // W, w % W], lane-major as in the kernel's registers.  The
# functions mirror csrc/cios_mont_mul32.cuh one for one (shuffles as shifts
# along the lane axis, ballots as bit masks); they are a check of the
# kernel's arithmetic for the CPU tests, not a second implementation of the
# function (that is ops/montgomery.mont_exp).

_I64 = torch.int64
_M32 = 0xFFFFFFFF


def words_for(L: int) -> int:
    """32-bit words of K6's working form for L 15-bit limbs: 4n < 2^(32 L32)
    for every n < 2^(15 L)."""
    return (15 * L + 2 + 31) // 32


def lane_words_for(L: int) -> int:
    """Words a lane holds at L limbs (csrc/cios_mont_mul32.cuh ``w_for``)."""
    return -(-words_for(L) // ROW_LANES)


def _mul64(a, b):
    """(lo, hi) 32-bit halves of a*b for a, b < 2^32 (IMAD.WIDE.U32)."""
    p_lo, p_hi = (a & 0xFFFF) * b, (a >> 16) * b
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return t & _M32, (t >> 32) + (p_hi >> 16)


def _lane_up(v):
    """__shfl_up_sync(v, 1) within a row's lanes, lane 0 getting 0."""
    return torch.nn.functional.pad(v[..., :-1], (1, 0))


def _lane_down(v):
    """__shfl_down_sync(v, 1), the top lane getting 0."""
    return torch.nn.functional.pad(v[..., 1:], (0, 1))


def _lane_carries(g, p):
    """Carries into each lane and out of each row's top lane, from the
    lanes' generate / propagate flags [..., rows, TPI], as the kernel's
    ballot over a warp of 32 / TPI consecutive rows: the warp's flags spread
    one bit apart (row r's lane t at bit r (TPI + 1) + t), the carries of
    U + G with U = G | P in 64-bit integers.  The last warp is padded with
    copies of the last row, as the kernel's idle rows work on it."""
    tpi = g.shape[-1]
    k, rows = 32 // tpi, g.shape[-2]
    pad = -rows % k

    def warps(t):
        t = torch.cat([t, t[..., -1:, :].expand(t.shape[:-2] + (pad, tpi))], -2)
        return t.to(_I64).reshape(t.shape[:-2] + (-1, k, tpi))

    bit = torch.arange(k)[:, None] * (tpi + 1) + torch.arange(tpi)
    G = (warps(g) << bit).sum((-2, -1))
    U = G | (warps(p) << bit).sum((-2, -1))
    c = (U + G) ^ U ^ G  # [..., warps]
    into = ((c[..., None, None] >> bit) & 1).flatten(-3, -2)[..., :rows, :]
    out = ((c[..., None] >> (bit[:, 0] + tpi)) & 1).flatten(-2, -1)[..., :rows]
    return into, out


def _add_carry_in(x, c):
    """x [..., TPI, W] plus c [..., TPI] at each lane's word 0, the carry
    running along the lane; returns the sum and the carry out of each lane."""
    x = x.clone()
    for j in range(x.shape[-1]):
        t = x[..., j] + c
        x[..., j], c = t & _M32, t >> 32
    return x, c


def _resolve(x, cy):
    """Each lane's pending carry ``cy`` added into the lane above:
    canonical words (csrc/cios_mont_mul32.cuh ``resolve``)."""
    x, c = _add_carry_in(x, _lane_up(cy))
    into, _ = _lane_carries(c != 0, (x == _M32).all(-1))
    return _add_carry_in(x, into)[0]


def _mont_mul32(a, b, n, n0inv, L32):
    """a*b*R32^-1 mod n, canonical words of a value < 2n, by the kernel's
    step: one 64-bit column a word, the products' low words into their own
    column and high words into the next, column 0 moved one lane down."""
    tpi, W = a.shape[-2], a.shape[-1]
    shape = torch.broadcast_shapes(a.shape, b.shape, n.shape)
    a_flat = a.reshape(a.shape[:-2] + (tpi * W,))
    col = torch.zeros(shape, dtype=_I64)
    lane0 = torch.zeros(shape, dtype=torch.bool)
    lane0[..., 0, 0] = True
    for i in range(L32):
        ai = a_flat[..., i : i + 1, None]
        p1_lo, p1_hi = _mul64(ai, b)
        mi = _mul64((col[..., :1, :1] + p1_lo[..., :1, :1]) & _M32, n0inv)[0]
        p2_lo, p2_hi = _mul64(mi, n)
        h = p1_hi + p2_hi  # enters the column one word up
        col = col + p1_lo + p2_lo + torch.nn.functional.pad(h[..., :-1], (1, 0))
        low = col[..., 0]
        top = h[..., W - 1] + _lane_down(low)
        col = torch.cat([col[..., 1:], top[..., None]], -1)
        col = col + torch.where(lane0, low[..., :1, None] >> 32, 0)
    carry = torch.zeros(shape[:-1], dtype=_I64)
    out = torch.empty_like(col)
    for j in range(W):
        t = col[..., j] + carry
        out[..., j], carry = t & _M32, t >> 32
    return _resolve(out, carry)


def _cond_sub32(x, n):
    """x - n if x >= n, else x (csrc/cios_mont_mul32.cuh ``cond_sub``)."""
    x, n = torch.broadcast_tensors(x, n)
    d = torch.empty_like(x)
    borrow = torch.zeros(x.shape[:-1], dtype=_I64)
    for j in range(x.shape[-1]):
        t = x[..., j] - n[..., j] - borrow
        d[..., j], borrow = t & _M32, (t < 0).to(_I64)
    into, out = _lane_carries(borrow != 0, (d == 0).all(-1))
    c = into
    for j in range(x.shape[-1]):
        t = d[..., j] - c
        d[..., j], c = t & _M32, (t < 0).to(_I64)
    return torch.where((out == 0)[..., None, None], d, x)


def _dbl_mod(x, n):
    """2x mod n for x < n: a one-bit shift across words and lanes, then the
    conditional subtract."""
    words = x.reshape(x.shape[:-2] + (-1,))
    below = torch.nn.functional.pad(words[..., :-1] >> 31, (1, 0))
    return _cond_sub32((((words << 1) & _M32) | below).reshape(x.shape), n)


def _neg_inv32(n0):
    """-n0^-1 mod 2^32 by the kernel's four Newton steps."""
    x = n0
    for _ in range(4):
        x = _mul64(x, (2 - _mul64(n0, x)[0]) & _M32)[0]
    return (-x) & _M32


def _limbs_to_words(src, tpi, W, shift=0):
    """[..., L] digits (< 2^32 each) times 2^shift -> words [..., TPI, W] by
    the kernel's carrying addition: word w sums the low part of the digits
    that start in it and the high part of those that start in the word
    below."""
    L = src.shape[-1]
    src = src.to(_I64)
    s = torch.zeros(src.shape[:-1] + (tpi * W,), dtype=_I64)
    for w in range(tpi * W):
        lo = max(0, (32 * w - 32 - shift) // 15 + 1)
        for l in range(lo, min(L - 1, (32 * w + 31 - shift) // 15) + 1):
            sh = 15 * l + shift - 32 * w
            s[..., w] += (src[..., l] << sh) & _M32 if sh >= 0 else src[..., l] >> -sh
    s = s.reshape(src.shape[:-1] + (tpi, W))
    carry = torch.zeros(s.shape[:-1], dtype=_I64)
    for j in range(W):
        t = s[..., j] + carry
        s[..., j], carry = t & _M32, t >> 32
    return _resolve(s, carry)


def _words_to_limbs(x, L):
    """Canonical words [..., TPI, W] -> 15-bit limbs [..., L]."""
    words = x.reshape(x.shape[:-2] + (-1,))
    words = torch.nn.functional.pad(words, (0, 1))
    bit = torch.arange(L) * 15
    w, sh = bit >> 5, bit & 31
    v = (words[..., w] >> sh) | ((words[..., w + 1] << (32 - sh)) & _M32)
    return (v & 0x7FFF).to(_I32)


def modexp_w32_walk(base, windows, n, r2, one):
    """The 32-bit K6 walked on the CPU: what :func:`modexp` computes on a
    CUDA tensor, step for step as csrc/modexp.cu ``modexp32_kernel`` does
    it.  Arguments as for :func:`modexp` without n0inv (the kernel derives
    its own); tensors on the CPU.  Returns [G, B, L] int32."""
    G, L = base.shape[0], base.shape[-1]
    B = max(base.shape[1], windows.shape[1])
    NW = windows.shape[-1]
    tpi, L32, W = ROW_LANES, words_for(L), lane_words_for(L)
    d = 32 * L32 - 15 * L
    nn = _limbs_to_words(n[:, None, :], tpi, W)  # [G, 1, TPI, W]
    n0 = _neg_inv32(nn[..., :1, :1])  # [G, 1, 1, 1]
    r2w = _limbs_to_words(r2[:, None, :], tpi, W)
    for _ in range(2 * d):
        r2w = _dbl_mod(r2w, nn)
    x = _limbs_to_words(base.expand(G, B, L), tpi, W)
    am = _mont_mul32(x, r2w, nn, n0, L32)
    onew = _limbs_to_words(one[:, None, :], tpi, W)
    for _ in range(d):
        onew = _dbl_mod(onew, nn)
    table = [onew.expand(am.shape), am]
    for _ in range(2, 16):
        table.append(_mont_mul32(table[-1], am, nn, n0, L32))
    table = torch.stack(table)
    acc = onew.expand(am.shape)
    wins = windows.expand(G, B, NW).to(_I64)
    for k in range(NW):
        for _ in range(4):
            acc = _mont_mul32(acc, acc, nn, n0, L32)
        sel = (wins[..., k][None] == torch.arange(16)[:, None, None])[..., None, None]
        acc = _mont_mul32(acc, (table * sel).sum(0), nn, n0, L32)
    plain_one = torch.zeros_like(acc)
    plain_one[..., 0, 0] = 1
    res = _cond_sub32(_mont_mul32(acc, plain_one, nn, n0, L32), nn)
    return _words_to_limbs(res, L)


def _k47_setup(n, L):
    """Lanes, words a lane, L32, d and n's words / n0inv32 of the 32-bit K4 /
    K7 at L limbs, for n [G, L]."""
    tpi, L32, W = ROW_LANES, words_for(L), lane_words_for(L)
    nn = _limbs_to_words(n[:, None, :], tpi, W)  # [G, 1, TPI, W]
    return tpi, W, L32, 32 * L32 - 15 * L, nn, _neg_inv32(nn[..., :1, :1])


def mod_mul_w32_walk(a, b, n, r2):
    """The 32-bit K4 walked on the CPU: what :func:`mod_mul` computes on a
    CUDA tensor, step for step as csrc/mod_mul.cu ``mod_mul32_kernel`` does
    it — a 2^d and b 2^d in words, x1 = mont32(a 2^d, r2) = a R15 mod n,
    x2 = mont32(b 2^d, x1) = a b mod n (< 3n), two conditional subtracts.
    Arguments as for :func:`mod_mul` without n0inv; CPU tensors.  Returns
    [G, B, L] int32."""
    G, B, L = a.shape
    tpi, W, L32, d, nn, n0 = _k47_setup(n, L)
    x = _limbs_to_words(a, tpi, W, d)
    x1 = _mont_mul32(x, _limbs_to_words(r2[:, None, :], tpi, W), nn, n0, L32)
    y = _limbs_to_words(b.expand(G, B, L), tpi, W, d)
    x2 = _mont_mul32(y, x1, nn, n0, L32)
    return _words_to_limbs(_cond_sub32(_cond_sub32(x2, nn), nn), L)


def mont_raw_w32_walk(a, b, n):
    """The 32-bit K7 walked on the CPU: what :func:`mont_raw` computes on a
    CUDA tensor, step for step as csrc/mont_raw.cu ``mont_raw32_kernel``
    does it — mont32(a 2^d, b) = a b R15^-1 mod n (< 2n), one conditional
    subtract: the canonical value.  Arguments as for :func:`mont_raw`
    without n0inv; CPU tensors.  Returns [G, B, L] int32."""
    G, B, L = a.shape
    tpi, W, L32, d, nn, n0 = _k47_setup(n, L)
    x = _limbs_to_words(a, tpi, W, d)
    y = _limbs_to_words(b.expand(G, B, L), tpi, W)
    return _words_to_limbs(_cond_sub32(_mont_mul32(x, y, nn, n0, L32), nn), L)
