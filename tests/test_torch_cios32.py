"""K6 on 32-bit words, on the CPU: the walk of the kernel's schedule
(``cuda_modexp.modexp_w32_walk`` and its parts — radix conversion of
redundant 15-bit digits, the 32-bit constants derived by doublings, the
product with lazy carries between lanes, the conditional subtract, the way
back to 15-bit limbs) against ``montgomery.mont_exp`` (the kernel's plain
version), Python ``pow()`` and the JAX package's ``pallas_modexp`` in
interpret mode.

Widths: a few limbs, 274 (n^2 of a 2048-bit key) and 547 (the widest the
kernel takes), and both sides of every words-a-lane boundary of the
kernel's dispatch.  Edge cases: bases at or above n with digits of 2^15,
n = 2^(15 L) - 1, no windows, all-zero windows, two groups with different
moduli, n = 1.  Tolerance: none, integer arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops.pallas_modexp import BATCH_TILE, pallas_modexp
from pailliercryptolib_tpu_torch.ops import cuda_modexp as cm

MASK15 = (1 << 15) - 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only cost under test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(torch.int32)


def _consts(ns, L):
    """15-bit constants of moduli ``ns`` at L limbs, stacked as the kernel
    takes them: n, n0inv, r2 = R^2 mod n, one = R mod n (R = 2^(15 L))."""
    R = 1 << (15 * L)
    return (
        np.stack([lb.ints_to_limbs([n], L)[0] for n in ns]),
        np.array([(-pow(n, -1, 1 << 15)) & MASK15 for n in ns], np.uint32),
        np.stack([lb.ints_to_limbs([R * R % n], L)[0] for n in ns]),
        np.stack([lb.ints_to_limbs([R % n], L)[0] for n in ns]),
    )


def _redundant_limbs(values, L, rng):
    """Digits of ``values`` (each < 2^(15 L)) with some digits raised
    to 2^15 by borrowing from the digit above: the same values, digits
    <= 2^15, as the kernels' redundant outputs carry them."""
    rows = []
    for v in values:
        d = [(v >> (15 * i)) & MASK15 for i in range(L)]
        for i in range(L - 1):
            if d[i] == 0 and d[i + 1] > 0 and rng.random() < 0.5:
                d[i], d[i + 1] = 1 << 15, d[i + 1] - 1
        rows.append(d)
    return np.array(rows, np.uint32)


def _gappy(rng, L):
    """A value below 2^(15 (L - 1)) with about a third of its digits zero
    (room for the borrows of _redundant_limbs)."""
    return sum((0 if rng.random() < 0.3 else rng.getrandbits(15)) << (15 * i)
               for i in range(L - 1))


def _value(limbs):
    return sum(int(d) << (15 * i) for i, d in enumerate(limbs))


def _words(x):
    """Canonical words [..., TPI, W] -> Python ints."""
    flat = x.reshape(x.shape[:-2] + (-1,)).tolist()
    return [sum(w << (32 * i) for i, w in enumerate(row)) for row in flat]


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


# ---------------------------------------------------------------------------
# the whole walk against mont_exp, pow() and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,G,rows,ebits", [(90, 2, 6, 16), (4096, 1, 3, 8),
                                               (8190, 1, 2, 4)])
def test_walk_equals_mont_exp_pow_and_pallas(bits, G, rows, ebits):
    """Bases below R with digits of 2^15, some at or above n; exponents with
    0 and 1 among them; G moduli of the same width (limbs 7, 274, 547).  The
    walk runs one group more: n = 2^(15 L) - 1, the largest modulus L limbs
    hold, with bases of digits 2^15 (the d = 32 L32 - 15 L doublings must
    still end below n); the 15-bit form needs 4n < 2^(15 L), so that group is
    held against pow() only."""
    rng = random.Random(bits)
    ns = [_odd(rng, bits) for _ in range(G)]
    L = jmg.MontConstants.create(ns[0]).num_limbs
    jc = _consts(ns, L)
    bases = [[_gappy(rng, L) for _ in range(BATCH_TILE - 1)] + [n + 5] for n in ns]
    exps = [[rng.getrandbits(ebits) for _ in range(BATCH_TILE - 2)] + [0, 1] for _ in ns]
    base = np.stack([_redundant_limbs(b, L, rng) for b in bases])
    assert (base == 1 << 15).any()
    wins = np.stack([lb.ints_to_windows(e, ebits) for e in exps])
    want = np.asarray(pallas_modexp(*(jnp.asarray(a.astype(np.uint32))
                                      for a in (base, wins) + jc), interpret=True))
    pick = list(range(rows - 2)) + [BATCH_TILE - 2, BATCH_TILE - 1]  # with e = 0, 1, base > n
    base, wins, want = base[:, pick], wins[:, pick], want[:, pick]
    top = (1 << (15 * L)) - 1
    tbase = np.full((1, rows, L), 1 << 15, np.uint32)
    tbase[..., -1] = 0
    tbase[0, 1, :3] = (7, 0, 1)
    texps = [rng.getrandbits(ebits) for _ in pick]
    twins = lb.ints_to_windows(texps, ebits)[None]
    n, n0, r2, one = (_t(np.concatenate([a, t])) for a, t in zip(jc, _consts([top], L)))
    got = cm.modexp_w32_walk(_t(np.concatenate([base, tbase])),
                             _t(np.concatenate([wins, twins])), n, r2, one)
    plain = cm.modexp_plain(_t(base), _t(wins), n[:G], n0[:G], r2[:G], one[:G])
    assert got.dtype == torch.int32 and torch.equal(got[:G], plain)
    assert np.array_equal(got[:G].numpy(), want.astype(np.int64))
    for g, (m, bs, es) in enumerate(zip(ns + [top], list(base) + list(tbase),
                                        [[exps[g][i] for i in pick] for g in range(G)]
                                        + [texps])):
        assert [_value(x) for x in got[g].tolist()] == [
            pow(_value(b), e, m) for b, e in zip(bs, es)]


def test_walk_without_windows_and_with_zero_windows():
    """NW = 0 and all-zero windows give 1 mod n; n = 1 gives 0, as the plain
    version does."""
    rng = random.Random(3)
    ns = [_odd(rng, 200), _odd(rng, 200)]
    L = jmg.MontConstants.create(ns[0]).num_limbs
    n, n0, r2, one = (_t(a) for a in _consts(ns, L))
    base = _t(np.stack([lb.ints_to_limbs([rng.randrange(m) for _ in range(3)], L)
                        for m in ns]))
    for nw in (0, 3):
        wins = torch.zeros((2, 1, nw), dtype=torch.int32)
        got = cm.modexp_w32_walk(base, wins, n, r2, one)
        assert torch.equal(got, cm.modexp_plain(base, wins, n, n0, r2, one))
        assert all(_value(x) == 1 for g in range(2) for x in got[g].tolist())
    n, n0, r2, one = (_t(a) for a in _consts([1], 1))
    base = _t([[[5], [0]]])
    wins = _t([[[3, 1]]])
    got = cm.modexp_w32_walk(base, wins, n, r2, one)
    assert got.tolist() == [[[0], [0]]]
    assert torch.equal(got, cm.modexp_plain(base, wins, n, n0, r2, one))


# ---------------------------------------------------------------------------
# the parts, on both sides of every words-a-lane boundary
# ---------------------------------------------------------------------------


def _boundaries():
    """Both sides of every boundary of the kernel's dispatch over words a
    lane (L32 = 32 k and 32 k + 1), and its ends."""
    Ls = {1, cm.KERNEL_MAX_L}
    for L in range(1, cm.KERNEL_MAX_L):
        if cm.lane_words_for(L) != cm.lane_words_for(L + 1):
            Ls |= {L, L + 1}
    return sorted(Ls)


def test_dispatch_boundaries():
    Ls = _boundaries()
    assert Ls[:5] == [1, 34, 35, 68, 69] and Ls[-2:] == [546, 547]
    assert len(Ls) == 33 and cm.ROW_LANES == 16
    assert [cm.lane_words_for(L) for L in Ls] == [1] + [w // 2 for w in range(3, 35)]
    assert cm.words_for(274) == 129 and cm.words_for(547) == 257
    for L in range(1, cm.KERNEL_MAX_L + 1):
        d = 32 * cm.words_for(L) - 15 * L
        assert 2 <= d <= 33  # 4n < R32 for every n < 2^(15 L)


@pytest.mark.parametrize("L", _boundaries())
def test_schedule_parts_at_each_width(L):
    """At L limbs: redundant digits -> words (a carrying addition), n0inv32
    by Newton, R32 mod n and R32^2 mod n by doublings, one product a*b*R32^-1
    with its lazy carries (canonical words of a value < 2n), the conditional
    subtract and the way back to limbs — each against Python ints."""
    rng = random.Random(L)
    tpi, W = cm.ROW_LANES, cm.lane_words_for(L)
    L32 = cm.words_for(L)
    R32 = 1 << (32 * L32)
    # a modulus near the top of the range: the largest values and carries
    n = (1 << (15 * L)) - 1 - 2 * rng.getrandbits(max(1, 15 * L - 8))
    vals = [_gappy(rng, L) if L > 1 else rng.randrange(1 << 15)
            for _ in range(2)] + [(1 << (15 * L)) - 1]
    limbs = _t(_redundant_limbs(vals[:2], L, rng).tolist()
               + [lb.ints_to_limbs([vals[2]], L)[0].tolist()])
    x = cm._limbs_to_words(limbs, tpi, W)
    assert x.shape == (3, tpi, W) and _words(x) == vals
    nn = cm._limbs_to_words(_t(lb.ints_to_limbs([n], L)), tpi, W)
    n0 = cm._neg_inv32(nn[..., :1, :1])
    assert (int(n0) * n + 1) % (1 << 32) == 0
    d = 32 * L32 - 15 * L
    R15 = 1 << (15 * L)
    one = cm._limbs_to_words(_t(lb.ints_to_limbs([R15 % n], L)), tpi, W)
    r2 = cm._limbs_to_words(_t(lb.ints_to_limbs([R15 * R15 % n], L)), tpi, W)
    for _ in range(d):
        one = cm._dbl_mod(one, nn)
    for _ in range(2 * d):
        r2 = cm._dbl_mod(r2, nn)
    assert _words(one) == [R32 % n] and _words(r2) == [R32 * R32 % n]
    # a product at the edge of its input bound: a < R15, b < 2n
    b_vals = [2 * n - 1 - v % n for v in vals]
    b = _words_tensor(b_vals, tpi, W)
    p = cm._mont_mul32(x, b, nn, n0, L32)
    inv = pow(R32, -1, n)
    got = _words(p)
    assert all(v < 2 * n and v % n == a * bb * inv % n
               for v, a, bb in zip(got, vals, b_vals))
    s = cm._cond_sub32(p, nn)
    assert _words(s) == [v - n if v >= n else v for v in got]
    back = cm._words_to_limbs(s, L)
    assert back.dtype == torch.int32
    assert [_value(r) for r in back.tolist()] == _words(s)
    assert int(back.max()) <= MASK15


def _words_tensor(vals, tpi, W):
    """Python ints -> words [len, TPI, W] (int64)."""
    rows = [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(tpi * W)] for v in vals]
    return torch.tensor(rows, dtype=torch.int64).reshape(len(vals), tpi, W)
