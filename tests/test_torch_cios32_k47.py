"""K4 and K7 on 32-bit words, on the CPU: the walks of the kernels'
schedules (``cuda_modexp.mod_mul_w32_walk`` / ``mont_raw_w32_walk``: the
operand read as a 2^d, d = 32 L32 - 15 L, in the radix conversion, the
products with lazy carries between lanes at ``ROW_LANES`` lanes a row,
the conditional subtracts, the way back to 15-bit limbs) against the
kernels' plain versions (``montgomery.mont_mod_mul``, and ``mont_mul``
canonicalised: the 32-bit K7 returns the canonical value), Python ints and
the JAX package's ``pallas_mod_mul`` / ``pallas_mont_raw`` in interpret mode.

Widths: 256-bit moduli, and the paths' 69 / 137 / 274 / 547 limbs.  Edge
cases: a with redundant digits of 2^15, a = 0, a = n - 1, a = R - 1, b
shared by the rows (stride 0) and per row, n = 2^(15 L) - 1.  The shift
by 2^d at every L in 1..547 against host integers.  Tolerance: none,
integer arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops.pallas_modexp import BATCH_TILE, pallas_mod_mul, pallas_mont_raw
from pailliercryptolib_tpu_torch.ops import cuda_modexp as cm
from pailliercryptolib_tpu_torch.ops.montgomery import canonicalize, cond_sub_n

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


def _value(limbs):
    return sum(int(d) << (15 * i) for i, d in enumerate(limbs))


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _consts(ns, L):
    """15-bit constants of moduli ``ns`` at L limbs, stacked as the kernels
    take them: n, n0inv, r2 = R^2 mod n (R = 2^(15 L))."""
    R = 1 << (15 * L)
    return (np.stack([lb.ints_to_limbs([n], L)[0] for n in ns]),
            np.array([(-pow(n, -1, 1 << 15)) & MASK15 for n in ns], np.uint32),
            np.stack([lb.ints_to_limbs([R * R % n], L)[0] for n in ns]))


def _redundant(rng, L):
    """Digits <= 2^15 (some exactly 2^15), the top one zero: a value < R."""
    return [rng.choice((1 << 15, rng.getrandbits(15))) for _ in range(L - 1)] + [0]


def _operands(rng, ns, L, rows):
    """a [G, BATCH_TILE, L]: redundant digits, 0, n - 1, R - 1, then values
    below n; b per row [G, BATCH_TILE, L] below n.  Rows ``pick`` are walked:
    the four edge rows and rows - 4 more."""
    R = 1 << (15 * L)
    a, b = [], []
    for n in ns:
        vals = [0, n - 1, R - 1] + [rng.randrange(n) for _ in range(BATCH_TILE - 4)]
        a.append([_redundant(rng, L)] + lb.ints_to_limbs(vals, L).tolist())
        b.append(lb.ints_to_limbs([rng.randrange(n) for _ in range(BATCH_TILE)], L))
    return np.array(a, np.uint32), np.array(b, np.uint32), list(range(rows))


# (modulus bits, groups, rows walked): a 256-bit modulus, then p / n / n^2 of
# 2048- and 4096-bit keys (69, 137, 274, 547 limbs)
CASES = [(256, 2, 6), (1024, 2, 4), (2048, 2, 3), (4096, 1, 3), (8190, 1, 2)]


@pytest.mark.parametrize("bits,G,rows", CASES)
def test_mod_mul_walk_equals_plain_pallas_and_ints(bits, G, rows):
    """The 32-bit K4 with b per row and b shared (stride 0) against
    mont_mod_mul, pallas_mod_mul (interpret mode) and a*b mod n; at 256 bits
    also on the largest modulus L limbs hold, n = 2^(15 L) - 1."""
    rng = random.Random(bits)
    ns = [_odd(rng, bits) for _ in range(G)]
    L = jmg.MontConstants.create(ns[0]).num_limbs
    a, b, pick = _operands(rng, ns, L, rows)
    n, n0, r2 = _consts(ns, L)
    for shared in (False, True):
        bb = b[:, :1] if shared else b
        want = np.asarray(pallas_mod_mul(
            jnp.asarray(a), jnp.broadcast_to(jnp.asarray(bb), a.shape), jnp.asarray(n),
            jnp.asarray(n0), jnp.asarray(r2), interpret=True))[:, pick]
        ta, tb = _t(a[:, pick]), _t(bb if shared else bb[:, pick])
        got = cm.mod_mul_w32_walk(ta, tb, _t(n), _t(r2))
        assert got.dtype == torch.int32
        assert torch.equal(got, cm.mod_mul_plain(ta, tb.expand(ta.shape), _t(n), _t(n0),
                                                 _t(r2)))
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        for g, m in enumerate(ns):
            bv = [_value(x) for x in tb.expand(ta.shape)[g].tolist()]
            assert [_value(x) for x in got[g].tolist()] == [
                _value(x) * y % m for x, y in zip(a[g, pick], bv)]
    if bits == 256:
        top = (1 << (15 * L)) - 1
        tn, _, tr2 = _consts([top], L)
        ta = _t(a[:1, pick])
        got = cm.mod_mul_w32_walk(ta, ta, _t(tn), _t(tr2))
        assert [_value(x) for x in got[0].tolist()] == [
            _value(x) ** 2 % top for x in a[0, pick]]


@pytest.mark.parametrize("bits,G,rows", CASES)
def test_mont_raw_walk_equals_canonical_plain_pallas_and_ints(bits, G, rows):
    """The 32-bit K7 (b shared, as the CRT fold's r2, and per row) against
    the canonical value of mont_mul's and of pallas_mont_raw's (interpret
    mode) redundant outputs, and a*b*R^-1 mod n: canonical limbs below n."""
    rng = random.Random(bits + 7)
    ns = [_odd(rng, bits) for _ in range(G)]
    L = jmg.MontConstants.create(ns[0]).num_limbs
    R = 1 << (15 * L)
    a, b, pick = _operands(rng, ns, L, rows)
    n, n0, r2 = _consts(ns, L)
    tn = _t(n)[:, None, :]
    for bb in (b, r2[:, None, :]):
        full = np.broadcast_to(bb, a.shape)
        raw = np.asarray(pallas_mont_raw(jnp.asarray(a), jnp.asarray(full), jnp.asarray(n),
                                         jnp.asarray(n0), interpret=True))[:, pick]
        ta = _t(a[:, pick])
        tb = _t(full[:, pick]) if bb is b else _t(bb)
        got = cm.mont_raw_w32_walk(ta, tb, _t(n))
        assert got.dtype == torch.int32 and int(got.max()) <= MASK15
        plain = cm.mont_raw_plain(ta, tb.expand(ta.shape), _t(n), _t(n0))
        assert torch.equal(got, cond_sub_n(canonicalize(plain), tn))
        assert torch.equal(got, cond_sub_n(canonicalize(_t(raw)), tn))
        for g, m in enumerate(ns):
            rinv = pow(R, -1, m)
            bv = [_value(x) for x in tb.expand(ta.shape)[g].tolist()]
            assert [_value(x) for x in got[g].tolist()] == [
                _value(x) * y * rinv % m for x, y in zip(a[g, pick], bv)]


def test_shift_by_d_at_every_width():
    """d = 32 L32 - 15 L at every L in 1..547, with host integers: 2 <= d <=
    33, so that a value < R15 times 2^d fits the L32 words, 4n < R32 and 3n
    < R32 (K4's accumulator bound); and the radix conversion of the largest
    operand, R15 - 1, and of a redundant row, times 2^d, equal the host's
    words (every shift a digit can take against a word boundary)."""
    rng = random.Random(547)
    for L in range(1, cm.KERNEL_MAX_L + 1):
        L32 = cm.words_for(L)
        d = 32 * L32 - 15 * L
        R15, R32 = 1 << (15 * L), 1 << (32 * L32)
        assert 2 <= d <= 33 and (R15 - 1) << d < R32 and 4 * (R15 - 1) < R32
        tpi, W = cm.ROW_LANES, cm.lane_words_for(L)
        rows = [[MASK15] * L, _redundant(rng, L) if L > 1 else [1 << 14]]
        got = cm._limbs_to_words(_t(rows), tpi, W, d)
        flat = got.reshape(2, -1).tolist()
        for row, words in zip(rows, flat):
            v = _value(row) << d
            assert words == [(v >> (32 * i)) & 0xFFFFFFFF for i in range(tpi * W)]
