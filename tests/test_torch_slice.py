"""The ported path as a whole — DJN encrypt -> CRT decrypt through the
public API on ``device="cpu"`` — against the JAX package on keys built in
both packages from the same p, q, hs.  The JAX engines run their Pallas
kernels in interpret mode (backend ``rns_interpret``).  Tolerance: exact
equality of ciphertexts and plaintexts as Python ints."""

import math
import random

import numpy as np
import pytest
import torch

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.utils.rng import DeviceSeed as JaxDeviceSeed
from pailliercryptolib_tpu_torch.convert import keys_from_ints
from pailliercryptolib_tpu_torch.models.engine import DevLimbs
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed, batch_random_bytes


def _prime34(rng, bits):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 3
        if miller_rabin(c):
            return c


def _djn_ints(bits, seed):
    """(n, p, q, hs, randbits) of a DJN key from a seed."""
    rng = random.Random(seed)
    while True:
        p, q = _prime34(rng, bits // 2), _prime34(rng, bits // 2)
        n = p * q
        if p != q and n.bit_length() == bits and math.gcd(p - 1, q - 1) == 2:
            break
    r = rng.randrange(2, n)
    hs = pow((-(r * r)) % n, n, n * n)
    return n, p, q, hs, bits // 2


@pytest.fixture(scope="module", params=[256, 512])
def keys(request):
    bits = request.param
    n, p, q, hs, randbits = _djn_ints(bits, seed=bits)
    jpk = ptpu.PublicKey(n, bits, hs=hs, randbits=randbits)
    jsk = ptpu.PrivateKey(jpk, p, q)
    for e in (jpk._engine, jsk._engine):
        e.backend = "rns_interpret"
    tkey = keys_from_ints(n, p, q, hs, randbits, device="cpu")
    rng = random.Random(bits + 1)
    return dict(bits=bits, n=n, p=p, q=q, hs=hs, randbits=randbits, jpk=jpk,
                jsk=jsk, tpk=tkey.pub_key, tsk=tkey.priv_key, rng=rng)


def _injected(k):
    """Both packages' ciphertexts of the same plaintexts under the same
    injected obfuscator exponents (made once per key)."""
    if "jct" not in k:
        rng, n = k["rng"], k["n"]
        vals = [rng.getrandbits(64) for _ in range(4)] + [0, n - 1]
        rs = [rng.getrandbits(k["randbits"]) for _ in range(4)]
        rs += [0, (1 << k["randbits"]) - 1]
        k["jpk"].set_random(rs)
        k["tpk"].set_random(rs)
        k["jct"] = k["jpk"].encrypt(ptpu.PlainText(vals))
        k["tct"] = k["tpk"].encrypt(ptorch.PlainText(vals))
        k["vals"], k["rs"] = vals, rs
    return k


def test_injected_r_equal_ciphertexts_and_oracle(keys):
    k = _injected(keys)
    n, n2 = k["n"], k["n"] ** 2
    want = [
        (n * m + 1) * pow(k["hs"], r, n2) % n2 for m, r in zip(k["vals"], k["rs"])
    ]
    assert k["tct"].texts == want
    assert k["tct"].texts == k["jct"].texts


def test_cross_decrypt(keys):
    """The port decrypts the JAX package's ciphertexts and the reverse."""
    k = _injected(keys)
    want = [v % k["n"] for v in k["vals"]]
    from_jax = ptorch.CipherText(k["tpk"], k["jct"].texts)
    assert k["tsk"].decrypt(from_jax).texts == want
    from_port = ptpu.CipherText(k["jpk"], k["tct"].texts)
    assert k["jsk"].decrypt(from_port).texts == want
    # device-resident payload (no host round trip) gives the same
    assert isinstance(k["tct"].device_payload(), DevLimbs)
    assert k["tsk"].decrypt(k["tct"]).texts == want


def test_same_device_seed_equal_ciphertexts(keys):
    """Same 44-byte seed -> the same ChaCha20 exponents -> equal
    ciphertexts, at a batch that is no multiple of 128 (the JAX engine pads
    to its tile, the port does not pad)."""
    k = keys
    B = 130 if k["bits"] == 256 else 5
    vals = [k["rng"].getrandbits(64) for _ in range(B)]
    data = np.random.default_rng(k["bits"]).integers(
        0, 1 << 32, 11, dtype=np.uint64
    ).astype(np.uint32)
    js, ts = JaxDeviceSeed(), DeviceSeed()
    js.data, ts.data = data.copy(), data.copy()
    jct = k["jpk"]._engine.encrypt_djn_dev(vals, js).fetch()
    out = k["tpk"]._engine.encrypt_djn_dev(vals, ts)
    assert out.arr.shape[0] == B and out.arr.dtype == torch.int32  # unpadded
    tct = out.fetch()
    assert tct == jct
    assert k["tsk"].decrypt(ptorch.CipherText(k["tpk"], out)).texts == vals


def test_fresh_seed_roundtrip_ragged_batch(keys):
    k = keys
    B = 131 if k["bits"] == 256 else 3
    vals = [k["rng"].getrandbits(64) for _ in range(B)]
    ct = k["tpk"].encrypt(ptorch.PlainText(vals))
    ct2 = k["tpk"].encrypt(ptorch.PlainText(vals))
    assert ct.texts != ct2.texts  # fresh obfuscators per call
    dec = k["tsk"].decrypt(ct)
    dec.block_until_ready()
    assert len(dec) == B and dec.texts == vals
    assert k["tsk"].decrypt(ct2).texts == vals


def test_bytes_r_convention_matches_oracle(keys):
    k = keys
    n, n2 = k["n"], k["n"] ** 2
    vals = [7, 1234567, n - 2]
    rb = batch_random_bytes(3, k["randbits"])
    out = k["tpk"]._engine.encrypt_djn(vals, rb)
    rs = [int.from_bytes(row.tobytes(), "little") for row in rb]
    assert out == [(n * m + 1) * pow(k["hs"], r, n2) % n2 for m, r in zip(vals, rs)]


def test_set_random_fifo(keys):
    """set_random APPENDS; values are consumed first-in first-out and the
    hook disarms when drained."""
    pk = keys["tpk"]
    n, n2, hs = pk.n, pk.nsquare, pk.hs
    pk.set_random([11, 12])
    pk.set_random([13])
    a = pk.encrypt(ptorch.PlainText([1, 2]))
    b = pk.encrypt(ptorch.PlainText([3]))
    assert a.texts == [(n * m + 1) * pow(hs, r, n2) % n2 for m, r in ((1, 11), (2, 12))]
    assert b.texts == [(n * 3 + 1) * pow(hs, 13, n2) % n2]
    assert not pk._testv
    pk.set_random([5])
    with pytest.raises(ValueError):
        pk.encrypt(ptorch.PlainText([1, 2]))  # not enough injected values
    pk._test_r.clear()
    pk._testv = False


def test_out_of_slice_entry_points_raise(keys):
    k = keys
    tpk, tsk = k["tpk"], k["tsk"]
    ct = tpk.encrypt(ptorch.PlainText([1, 2]))
    with pytest.raises(NotImplementedError):
        ct + ct
    with pytest.raises(NotImplementedError):
        ct + ptorch.PlainText([1, 2])
    with pytest.raises(NotImplementedError):
        ct * ptorch.PlainText([3])
    with pytest.raises(NotImplementedError):
        tpk.apply_obfuscator(ct)
    with pytest.raises(NotImplementedError):
        tpk.encrypt(ptorch.PlainText([1]), make_secure=False)
    tsk.enable_crt = False
    try:
        with pytest.raises(NotImplementedError):
            tsk.decrypt(ct)  # RAW decrypt
    finally:
        tsk.enable_crt = True
    normal = ptorch.PublicKey(k["n"], k["bits"], device="cpu")
    with pytest.raises(NotImplementedError):
        normal.encrypt(ptorch.PlainText([1]))  # normal-mode encrypt
    # an injected exponent wider than the fixed-base table
    tpk.set_random([1 << (k["randbits"] + 70)])
    with pytest.raises(NotImplementedError):
        tpk.encrypt(ptorch.PlainText([1]))
    # the errors name where the work is queued
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct + ct


def test_wide_keys_raise():
    with pytest.raises(NotImplementedError):
        ptorch.generate_keypair(3072, device="cpu")
    n = (1 << 3071) | 1
    with pytest.raises(NotImplementedError):
        ptorch.PublicKey(n, 3072, hs=5, randbits=1536, device="cpu")._engine


def test_generate_keypair_roundtrip_cpu():
    key = ptorch.generate_keypair(256, enable_DJN=True, device="cpu")
    assert key.pub_key.is_djn() and key.pub_key.get_rand_bits() == 128
    assert key.pub_key.device == torch.device("cpu")
    vals = [0, 1, 2**63, key.pub_key.n + 5]
    ct = key.pub_key.encrypt(ptorch.PlainText(vals))
    assert key.priv_key.decrypt(ct).texts == [v % key.pub_key.n for v in vals]
    with pytest.raises(ValueError):
        key.pub_key.encrypt(ptorch.PlainText([]))
    with pytest.raises(ValueError):
        ptorch.PrivateKey(key.pub_key, key.priv_key.p, key.priv_key.q + 2)
    other = ptorch.generate_keypair(256, enable_DJN=True, device="cpu")
    with pytest.raises(ValueError):
        other.priv_key.decrypt(ct)  # N mismatch
