"""Plain tensor math of the PyTorch/CUDA port against the JAX package on the
same numpy-seeded inputs.  Tolerance: exact integer equality everywhere."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import bigint as jbi
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops import paillier_ops as jpops
from pailliercryptolib_tpu.ops import rns as jrns
from pailliercryptolib_tpu_torch.convert import consts_from_jax
from pailliercryptolib_tpu_torch.ops import bigint as tbi
from pailliercryptolib_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.ops import rns as trns


def _t(a):
    """numpy (values < 2^31) -> the port's int32 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def _eq(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


# ---------------------------------------------------------------------------
# carries / borrows / limb products
# ---------------------------------------------------------------------------


def test_canonicalize_equal():
    r = np.random.default_rng(1)
    x = r.integers(0, 1 << 31, (17, 23), dtype=np.int64)
    x[:, -1] = 0  # the value must fit the limb count
    x[0, :-1] = (1 << 15) - 1  # a full ripple
    x[0, 0] += 1
    assert _eq(tmg.canonicalize(_t(x)), jmg.canonicalize(_j(x)))
    assert _eq(tmg.carry_round(_t(x)), jmg.carry_round(_j(x)))


def test_canonicalize_takes_32bit_digits():
    """Digits up to 2^32 - 1 (int64 in the port, uint32 in the reference)."""
    r = np.random.default_rng(2)
    x = r.integers(0, 1 << 32, (5, 12), dtype=np.int64)
    x[:, -2:] = 0
    got = tmg.canonicalize(torch.from_numpy(x))
    assert _eq(got, jmg.canonicalize(jnp.asarray(x.astype(np.uint32))))


@pytest.mark.parametrize("bits", [120, 500])
def test_cond_sub_n_equal(bits):
    rng = random.Random(bits)
    n = _odd(rng, bits)
    L = lb.limbs_for_bits(bits)
    xs = [rng.randrange(2 * n) for _ in range(30)] + [0, n - 1, n, n + 1, 2 * n - 1]
    x, nl = lb.ints_to_limbs(xs, L), lb.int_to_limbs(n, L)
    got = tmg.cond_sub_n(_t(x), _t(nl))
    assert _eq(got, jmg.cond_sub_n(_j(x), _j(nl)))
    assert lb.limbs_to_ints(got.numpy().astype(np.uint32)) == [
        v - n if v >= n else v for v in xs
    ]


@pytest.mark.parametrize("La,Lx", [(9, 9), (35, 8), (69, 69)])
def test_mul_shared_and_mul_low_equal(La, Lx):
    rng = random.Random(La * 100 + Lx)
    a = rng.getrandbits(15 * La)
    xs = [rng.getrandbits(15 * Lx) for _ in range(11)] + [0, 1, (1 << (15 * Lx)) - 1]
    al, xl = lb.int_to_limbs(a, La), lb.ints_to_limbs(xs, Lx)
    xl[3, 0] = 1 << 15  # a redundant digit, as _raw_encrypt's +1 can make
    got = tbi.mul_shared(_t(al), _t(xl))
    assert _eq(got, jbi.mul_shared(_j(al), _j(xl)))
    want = [a * v for v in xs]
    want[3] = a * (xs[3] - (xs[3] & 0x7FFF) + (1 << 15))
    assert lb.limbs_to_ints(got.numpy().astype(np.uint32)) == want
    out = min(La, Lx)
    assert _eq(tbi.mul_low(_t(al), _t(xl), out), jbi.mul_low(_j(al), _j(xl), out))


def test_sub_mod_sub_scalar_equal():
    rng = random.Random(77)
    m = _odd(rng, 300)
    L = lb.limbs_for_bits(300)
    xs = [rng.randrange(m) for _ in range(20)] + [0, m - 1, 5]
    ys = [rng.randrange(m) for _ in range(20)] + [m - 1, 0, 5]
    x, y, ml = lb.ints_to_limbs(xs, L), lb.ints_to_limbs(ys, L), lb.int_to_limbs(m, L)
    got = tbi.sub_mod(_t(x), _t(y), _t(ml))
    assert _eq(got, jbi.sub_mod(_j(x), _j(y), _j(ml)))
    assert lb.limbs_to_ints(got.numpy().astype(np.uint32)) == [
        (a - b) % m for a, b in zip(xs, ys)
    ]
    x1 = lb.ints_to_limbs([v + 1 for v in xs], L)
    assert _eq(tbi.sub_scalar(_t(x1), 1), jbi.sub_scalar(_j(x1), 1))
    d, b = tbi.sub_borrow(_t(x), _t(y))
    jd, jb = jbi.sub_borrow(_j(x), _j(y))
    assert _eq(d, jd) and _eq(b, jb)


def test_mont_mul_and_mod_mul_equal():
    rng = random.Random(5)
    n = _odd(rng, 200)
    c = jmg.MontConstants.create(n)
    L = c.num_limbs
    a_i = [rng.randrange(n) for _ in range(9)] + [0, 1, n - 1]
    b_i = [rng.randrange(n) for _ in range(9)] + [n - 1, 1, n - 1]
    a, b = lb.ints_to_limbs(a_i, L), lb.ints_to_limbs(b_i, L)
    got = tmg.mont_mul(_t(a), _t(b), _t(c.n_limbs), c.n0inv)
    want = jmg.mont_mul(_j(a), _j(b), _j(c.n_limbs), jnp.uint32(c.n0inv))
    assert _eq(got, want)  # redundant digits equal too, not only the value
    got = tmg.mont_mod_mul(_t(a), _t(b), _t(c.n_limbs), c.n0inv, _t(c.r2_limbs))
    assert lb.limbs_to_ints(got.numpy().astype(np.uint32)) == [
        x * y % n for x, y in zip(a_i, b_i)
    ]


# ---------------------------------------------------------------------------
# RNS stage primitives
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx256():
    rng = random.Random(2024)
    N = _odd(rng, 256)
    jc = jrns.RNSContext.create(N)
    jconv = jc.device_consts()
    tconv = consts_from_jax({k: np.asarray(v) for k, v in jconv.items()})
    return rng, N, jc, jconv, tconv


def test_barrett_reduce_integer_flavor_equal(ctx256):
    _, _, jc, _, _ = ctx256
    r = np.random.default_rng(3)
    m = jc.mods.astype(np.int64)
    v = r.integers(0, 1 << 30, (50, m.shape[0]), dtype=np.int64)
    v[0] = (1 << 30) - 1
    v[1] = 0
    v[2] = m * 7 - 1
    got = trns.barrett_reduce(_t(v), _t(m), _t(jc.barrett))
    want = jrns.barrett_reduce(_j(v), _j(m), _j(jc.barrett))
    assert _eq(got, want) and _eq(got, v % m)
    x = r.integers(0, 1 << 14, v.shape) % m
    y = r.integers(0, 1 << 14, v.shape) % m
    assert _eq(trns.mulmod(_t(x), _t(y), _t(m), _t(jc.barrett)), x * y % m)


def test_barrett_reduce_f32_flavor_equal(ctx256):
    _, _, jc, _, _ = ctx256
    r = np.random.default_rng(4)
    mods = np.concatenate([jc.mods, np.array([4099, 4111, 8191], np.uint32)])
    m = mods.astype(np.int64)
    mu = jrns.inv_f32(mods)
    assert np.array_equal(mu, trns.inv_f32(mods))
    v = r.integers(0, 1 << 31, (60, m.shape[0]), dtype=np.int64)
    v[0] = (1 << 31) - 1
    v[1] = 0
    v[2] = m * 131071  # exact multiples: the quotient must not overshoot
    v[3] = m * 131071 - 1
    got = trns.barrett_reduce(_t(v), _t(m), torch.from_numpy(mu))
    want = jrns.barrett_reduce(_j(v), _j(m), jnp.asarray(mu))
    assert _eq(got, want) and _eq(got, v % m)


def _residues(rng, jc, vals):
    return np.stack([jc.to_residues(v) for v in vals])


def test_limbs_to_rns_equal(ctx256):
    rng, N, jc, jconv, tconv = ctx256
    xs = [rng.randrange(N) for _ in range(12)] + [0, 1, N - 1]
    x = lb.ints_to_limbs(xs, jc.Lin)
    x[2, 0] = 1 << 15  # redundant digit
    got = trns.limbs_to_rns(_t(x), tconv)
    assert _eq(got, jrns.limbs_to_rns(_j(x), jconv))
    assert _eq(got[3:], _residues(rng, jc, xs[3:]))


def test_rns_mont_mul_equal(ctx256):
    rng, N, jc, jconv, tconv = ctx256
    xs = [rng.randrange(3 * N) for _ in range(40)] + [0, 1, 3 * N - 1]
    ys = [rng.randrange(3 * N) for _ in range(40)] + [3 * N - 1, 1, 3 * N - 1]
    x, y = _residues(rng, jc, xs), _residues(rng, jc, ys)
    got = trns.rns_mont_mul(_t(x), _t(y), tconv)
    assert _eq(got, jrns.rns_mont_mul(_j(x), _j(y), jconv))
    vals = lb.limbs_to_ints(
        trns.rns_to_limbs(got, tconv).numpy().astype(np.uint32)
    )
    MAinv = pow(jc.MA, -1, N)
    for a, b, v in zip(xs, ys, vals):
        assert v % N == a * b * MAinv % N and v < 3 * N


def test_rns_to_limbs_equal(ctx256):
    rng, N, jc, jconv, tconv = ctx256
    xs = [rng.randrange(3 * N) for _ in range(20)] + [0, 1, N, 3 * N - 1]
    x = _residues(rng, jc, xs)
    got = trns.rns_to_limbs(_t(x), tconv)
    assert _eq(got, jrns.rns_to_limbs(_j(x), jconv))
    assert lb.limbs_to_ints(got.numpy().astype(np.uint32)) == xs


def test_exact_matmul_and_matmul_mod_equal(ctx256):
    _, _, jc, _, _ = ctx256
    r = np.random.default_rng(6)
    k = jc.k
    x = r.integers(0, 1 << 14, (10, k))
    T = jc.T1.astype(np.int64)
    m, mu = jc.mods[k:].astype(np.int64), jc.barrett[k:]
    assert _eq(trns.exact_matmul(_t(x), _t(T)), x @ T)
    got = trns.matmul_mod(_t(x), _t(T), _t(m), _t(mu))
    assert _eq(got, jrns.matmul_mod(_j(x), _j(T), _j(m), _j(mu)))
    assert _eq(got, (x @ T) % m)


# ---------------------------------------------------------------------------
# ChaCha20 DRBG
# ---------------------------------------------------------------------------


def test_chacha20_rfc8439_vector():
    """RFC 8439 §2.3.2: key 00..1f, nonce 000000090000004a00000000, block
    counter 1."""
    key = np.frombuffer(bytes(range(32)), np.uint32).astype(np.int64)
    nonce = np.frombuffer(
        bytes.fromhex("000000090000004a00000000"), np.uint32
    ).astype(np.int64)
    ks = tpops._chacha20_blocks(torch.from_numpy(key), torch.from_numpy(nonce), 2)
    want = (
        "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
        "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e"
    )
    assert ks.dtype == torch.uint8
    assert ks[1].numpy().tobytes().hex() == want


@pytest.mark.parametrize("B,NP,randbits", [(5, 16, 128), (130, 8, 61)])
def test_device_obf_bytes_equal(B, NP, randbits):
    """Same [1, 11] seed row and mask -> the JAX package's bytes."""
    r = np.random.default_rng(B)
    seed = r.integers(0, 1 << 32, (1, 11), dtype=np.uint64).astype(np.uint32)
    seed[0, 0] = 0xFFFFFFFF  # words above 2^31 must survive the int64 route
    nbytes = -(-randbits // 8)
    mask = np.zeros((NP,), np.uint8)
    mask[:nbytes] = 0xFF
    if randbits % 8:
        mask[nbytes - 1] = (1 << (randbits % 8)) - 1
    got = tpops._device_obf_bytes(
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(mask), B
    )
    want = jpops._device_obf_bytes(jnp.asarray(seed), jnp.asarray(mask), B)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(want))
    # row i does not depend on the batch size
    more = tpops._device_obf_bytes(
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(mask), B + 123
    )
    assert torch.equal(more[:B], got)


def test_pack_unpack_ops_equal():
    r = np.random.default_rng(8)
    x = r.integers(0, 1 << 15, (6, 9))
    packed = tpops.pack_out_op(_t(x))
    assert _eq(packed, jpops.pack_out_op(_j(x)))
    assert _eq(packed, lb.pack_pairs_np(x.astype(np.uint32)))
    assert _eq(tpops.unpack_in_op(packed, 9), x)
