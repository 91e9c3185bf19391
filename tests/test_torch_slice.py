"""The ported paths as a whole — DJN and normal-mode encrypt,
apply_obfuscator, CT+CT, CT+PT, CT*PT, CRT and RAW decrypt through the
public API on ``device="cpu"`` — against the JAX package on keys built in
both packages from the same p, q, hs.  The JAX engines run their Pallas
kernels in interpret mode (backend ``rns_interpret``).  Tolerance: exact
equality of ciphertexts and plaintexts as Python ints."""

import math
import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.utils.rng import DeviceSeed as JaxDeviceSeed
from pailliercryptolib_tpu_torch.convert import keys_from_ints
from pailliercryptolib_tpu_torch.models.engine import DevLimbs
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed, batch_random_bytes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool only costs,
    and under parallel test workers it oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    """What is still outside the port says so: a constant set the compiled
    kernels do not cover (a folded integer-Barrett pair) raises
    NotImplementedError, keys above 4096 bits raise ValueError on every
    backend, and the runtime context, absent before it was ported, is
    exported (``initialize_context``, ``get_context``, ``terminate_context``
    in ``__all__``).  Every entry point of the
    homomorphic API, which raised before the generic RNS modexp kernel was
    ported, now answers; ``modexp`` and the hybrid-mode functions, absent
    before the CIOS backend was ported, are exported; the n^2 constant set of
    a 3072-bit key, refused while the kernels stopped at 320 lanes, packs;
    engines of 3072-bit keys build on every backend; and serialization,
    absent before, lives in ``utils.serialize`` (the top level exports no
    serialization name, as in the reference)."""
    from pailliercryptolib_tpu_torch.ops import cuda_rns2
    from pailliercryptolib_tpu_torch.ops.rns import RNSContext

    k = keys
    tpk, tsk = k["tpk"], k["tsk"]
    n = k["n"]
    ct = tpk.encrypt(ptorch.PlainText([1, 2]))
    assert tsk.decrypt(ct + ct).texts == [2, 4]
    assert tsk.decrypt(ct + ptorch.PlainText([1, 2])).texts == [2, 4]
    assert tsk.decrypt(ct * ptorch.PlainText([3])).texts == [3, 6]
    assert tsk.decrypt(tpk.apply_obfuscator(ct)).texts == [1, 2]
    assert tpk.encrypt(ptorch.PlainText([1]), make_secure=False).texts == [n + 1]
    tsk.enable_crt = False
    try:
        assert tsk.decrypt(ct).texts == [1, 2]  # RAW decrypt
    finally:
        tsk.enable_crt = True
    normal = ptorch.PublicKey(n, k["bits"], device="cpu")
    assert tsk.decrypt(normal.encrypt(ptorch.PlainText([5]))).texts == [5]
    # an injected exponent wider than the fixed-base table
    r = 1 << (k["randbits"] + 70)
    tpk.set_random([r])
    wide = tpk.encrypt(ptorch.PlainText([1]))
    assert wide.texts == [(n + 1) * pow(k["hs"], r, n * n) % (n * n)]
    # still outside: folded integer-Barrett sets
    cp, cq = tsk._engine._rns_crt_ctxs()
    with pytest.raises(NotImplementedError):
        cuda_rns2._kernel_pack(cuda_rns2.fold_group_consts2([cp, cq]))
    big = RNSContext.create((1 << 6143) | 1)  # n^2 of a 3072-bit key
    pack = cuda_rns2._kernel_pack(cuda_rns2.stack_group_consts2([big]))
    assert (pack["W"], pack["f32"], pack["lean"]) == (480, True, False)
    for name in ("initialize_context", "get_context", "terminate_context"):
        assert callable(getattr(ptorch, name)) and name in ptorch.__all__, name
    from pailliercryptolib_tpu_torch.utils import serialize as tser

    for name in ("serialize", "deserialize", "dumps", "loads", "serialize_to_file",
                 "deserialize_from_file"):
        assert callable(getattr(tser, name)), name
        assert not hasattr(ptorch, name), name  # as in the reference's top level
    assert tser.loads(tser.dumps(ptorch.PlainText([7])), ptorch.PlainText).texts == [7]
    for name in ("modexp", "HybridMode", "set_hybrid_mode", "set_hybrid_ratio",
                 "set_hybrid_off", "get_hybrid_mode", "get_hybrid_ratio"):
        assert hasattr(ptorch, name) and name in ptorch.__all__, name
    assert ptorch.modexp(3, 5, 7, device="cpu") == 5
    from pailliercryptolib_tpu_torch.models.engine import PublicEngine

    for backend in ("rns", "cios", "plain"):
        eng = PublicEngine((1 << 3071) | 1, 3072, None, 1536, backend=backend,
                           device="cpu")
        assert eng.backend == backend and eng.L2 == 410
        with pytest.raises(ValueError, match="exceeds supported range"):
            PublicEngine((1 << 4099) | 1, 4100, None, 2050, backend=backend,
                         device="cpu")


@pytest.mark.parametrize("backend", ["cios", "plain"])
def test_backends_agree_with_rns(keys, backend):
    """The same key on another backend gives the rns backend's ciphertexts
    for the same injected r, and each backend decrypts the other's."""
    k = _injected(keys)
    twin = keys_from_ints(k["n"], k["p"], k["q"], k["hs"], k["randbits"], device="cpu")
    tpk, tsk = twin.pub_key, twin.priv_key
    tpk._engine.backend = tsk._engine.backend = backend
    tpk.set_random(k["rs"])
    ct = tpk.encrypt(ptorch.PlainText(k["vals"]))
    assert ct.texts == k["tct"].texts
    want = [v % k["n"] for v in k["vals"]]
    assert tsk.decrypt(k["tct"]).texts == want
    assert k["tsk"].decrypt(ct + ct).texts == [2 * v % k["n"] for v in want]
    assert tpk._engine._secondary is None and tsk._engine._secondary is None


def test_wide_keys_raise():
    """Keys above the reference's 4096-bit cap raise its ValueError, from the
    key generator and from the engines; a 3072-bit key builds."""
    with pytest.raises(ValueError, match="exceeds supported range"):
        ptorch.generate_keypair(4100, device="cpu")
    n = (1 << 4099) | 1
    with pytest.raises(ValueError, match="exceeds supported range"):
        ptorch.PublicKey(n, 4100, hs=5, randbits=2050, device="cpu")._engine
    n = (1 << 3071) | 1
    eng = ptorch.PublicKey(n, 3072, hs=5, randbits=1536, device="cpu")._engine
    assert eng.nbits == 3072 and eng.backend == "rns" and eng.randbits == 1536


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


# ---------------------------------------------------------------------------
# the homomorphic API: normal-mode encrypt, apply_obfuscator, CT+CT, CT+PT,
# CT*PT, RAW decrypt — one 256-bit key, DJN and normal-mode public keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hk():
    bits = 256
    n, p, q, hs, randbits = _djn_ints(bits, seed=777)
    jpk = ptpu.PublicKey(n, bits, hs=hs, randbits=randbits)
    jnpk = ptpu.PublicKey(n, bits)  # normal mode
    jsk = ptpu.PrivateKey(jpk, p, q)
    for e in (jpk._engine, jnpk._engine, jsk._engine):
        e.backend = "rns_interpret"
    tkey = keys_from_ints(n, p, q, hs, randbits, device="cpu")
    tnpk = ptorch.PublicKey(n, bits, device="cpu")
    rng = random.Random(778)
    B = 6
    a = [rng.getrandbits(64) for _ in range(B - 2)] + [0, n - 1]
    b = [rng.getrandbits(64) for _ in range(B - 2)] + [n - 1, 1]
    rs = [rng.randrange(1, n) for _ in range(2 * B)]
    tnpk.set_random(rs)
    ca = tnpk.encrypt(ptorch.PlainText(a))
    cb = tnpk.encrypt(ptorch.PlainText(b))
    return dict(bits=bits, n=n, n2=n * n, p=p, q=q, hs=hs, randbits=randbits,
                jpk=jpk, jnpk=jnpk, jsk=jsk, tpk=tkey.pub_key, tnpk=tnpk,
                tsk=tkey.priv_key, rng=rng, B=B, a=a, b=b, rs=rs, ca=ca, cb=cb)


def _seed_pair(tag):
    data = np.random.default_rng(tag).integers(
        0, 1 << 32, 11, dtype=np.uint64
    ).astype(np.uint32)
    js, ts = JaxDeviceSeed(), DeviceSeed()
    js.data, ts.data = data.copy(), data.copy()
    return js, ts


def test_normal_encrypt_injected_r_equal_and_oracle(hk):
    n, n2, B = hk["n"], hk["n2"], hk["B"]
    want = [(n * m + 1) * pow(r, n, n2) % n2 for m, r in zip(hk["a"], hk["rs"][:B])]
    assert hk["ca"].texts == want
    hk["jnpk"].set_random(hk["rs"][:B])
    assert hk["jnpk"].encrypt(ptpu.PlainText(hk["a"])).texts == want
    assert hk["tsk"].decrypt(hk["ca"]).texts == hk["a"]


def test_normal_same_device_seed_equal_ciphertexts(hk):
    """Same 44-byte seed -> the same unreduced r'' -> equal normal-mode
    ciphertexts in both packages."""
    js, ts = _seed_pair(31)
    vals = hk["a"]
    jct = hk["jnpk"]._engine.encrypt_normal_dev(vals, js).fetch()
    out = hk["tnpk"]._engine.encrypt_normal_dev(vals, ts)
    assert out.arr.shape[0] == len(vals)  # unpadded
    assert out.fetch() == jct
    assert hk["tsk"].decrypt(ptorch.CipherText(hk["tnpk"], out)).texts == vals


def test_normal_fresh_draws_follow_the_reference(hk):
    """Fresh normal-mode randomness: a DeviceSeed for encrypt, host r in
    [1, n-1] for apply_obfuscator (as the reference draws them)."""
    pk = hk["tnpk"]
    assert isinstance(pk._draw_randoms(3, op="encrypt"), DeviceSeed)
    r = pk._draw_randoms(3, op="obfuscate")
    assert isinstance(r, list) and all(1 <= v < hk["n"] for v in r)
    assert isinstance(hk["tpk"]._draw_randoms(3, op="obfuscate"), DeviceSeed)
    vals = hk["b"]
    c1, c2 = pk.encrypt(ptorch.PlainText(vals)), pk.encrypt(ptorch.PlainText(vals))
    assert c1.texts != c2.texts
    assert hk["tsk"].decrypt(c1).texts == vals == hk["tsk"].decrypt(c2).texts


@pytest.mark.parametrize(
    "form", ["djn_seed", "djn_bytes", "djn_ints", "djn_oversized", "normal"]
)
def test_apply_obfuscator_equal(hk, form):
    n, n2, B, hs = hk["n"], hk["n2"], hk["B"], hk["hs"]
    cts = hk["ca"].texts
    rng = random.Random(form)
    je, te = hk["jpk"]._engine, hk["tpk"]._engine
    oracle_r = None
    if form == "djn_seed":
        jr, tr = _seed_pair(41)
    elif form == "djn_bytes":
        jr = tr = batch_random_bytes(B, hk["randbits"])
        oracle_r = [int.from_bytes(row.tobytes(), "little") for row in tr]
    elif form == "djn_ints":
        jr = tr = oracle_r = [rng.getrandbits(hk["randbits"]) for _ in range(B)]
    elif form == "djn_oversized":
        jr = tr = oracle_r = [rng.getrandbits(hk["randbits"] + 70) for _ in range(B)]
    else:
        je, te = hk["jnpk"]._engine, hk["tnpk"]._engine
        jr = tr = [rng.randrange(1, n) for _ in range(B)]
    want = je.obfuscate_dev(list(cts), jr).fetch()
    got = te.obfuscate_dev(list(cts), tr).fetch()
    assert got == want
    if oracle_r is not None:
        assert got == [c * pow(hs, r, n2) % n2 for c, r in zip(cts, oracle_r)]
    elif form == "normal":
        assert got == [c * pow(r, n, n2) % n2 for c, r in zip(cts, tr)]
    assert hk["tsk"].decrypt(ptorch.CipherText(hk["tpk"], got)).texts == hk["a"]


def test_apply_obfuscator_public_api(hk):
    for pk in (hk["tpk"], hk["tnpk"]):
        ct = ptorch.CipherText(pk, hk["ca"].device_payload())
        out = pk.apply_obfuscator(ct)
        assert out.texts != ct.texts
        assert hk["tsk"].decrypt(out).texts == hk["a"]
    with pytest.raises(ValueError):
        hk["tpk"].apply_obfuscator(ptorch.CipherText(hk["tpk"], []))


@pytest.mark.parametrize("broadcast", [False, True])
def test_add_ctct_equal(hk, broadcast):
    n, n2 = hk["n"], hk["n2"]
    a_ct, b_ct = hk["ca"].texts, hk["cb"].texts
    if broadcast:
        b_ct = b_ct[:1]
    want = [x * (b_ct[0] if broadcast else y) % n2
            for x, y in zip(a_ct, hk["cb"].texts)]
    jout = (ptpu.CipherText(hk["jnpk"], a_ct) + ptpu.CipherText(hk["jnpk"], b_ct)).texts
    tsum = hk["ca"] + ptorch.CipherText(hk["tnpk"], b_ct)
    assert isinstance(tsum.device_payload(), DevLimbs)
    assert tsum.texts == want == jout
    plain = [(x + (hk["b"][0] if broadcast else y)) % n for x, y in zip(hk["a"], hk["b"])]
    assert hk["tsk"].decrypt(tsum).texts == plain
    with pytest.raises(ValueError):
        hk["ca"] + ptorch.CipherText(hk["tnpk"], a_ct[:2])


def test_add_ctpt_equal(hk):
    n = hk["n"]
    pt = hk["b"]
    jout = (ptpu.CipherText(hk["jnpk"], hk["ca"].texts) + ptpu.PlainText(pt)).texts
    tout = hk["ca"] + ptorch.PlainText(pt)
    assert tout.texts == jout
    assert hk["tsk"].decrypt(tout).texts == [(x + y) % n for x, y in zip(hk["a"], pt)]
    assert (ptorch.PlainText(pt) + hk["ca"]).texts == jout  # PT + CT commutes
    noobf = hk["tnpk"].encrypt(ptorch.PlainText(pt), make_secure=False)
    assert noobf.texts == [n * (v % n) + 1 for v in pt]


@pytest.mark.parametrize("shared", [False, True])
def test_mul_ctpt_equal(hk, shared):
    n, n2 = hk["n"], hk["n2"]
    pt = [hk["rng"].getrandbits(64)] if shared else \
        [hk["rng"].getrandbits(64) for _ in range(hk["B"] - 2)] + [0, 1]
    jout = (ptpu.CipherText(hk["jnpk"], hk["ca"].texts) * ptpu.PlainText(pt)).texts
    tout = hk["ca"] * ptorch.PlainText(pt)
    pts = pt * hk["B"] if shared else pt
    assert tout.texts == jout == [pow(c, e, n2) for c, e in zip(hk["ca"].texts, pts)]
    assert hk["tsk"].decrypt(tout).texts == [x * e % n for x, e in zip(hk["a"], pts)]
    assert (ptorch.PlainText(pt) * hk["ca"]).texts == jout
    with pytest.raises(ValueError):
        hk["ca"] * ptorch.PlainText([1, 2])


def test_raw_decrypt_equal(hk):
    jsk, tsk = hk["jsk"], hk["tsk"]
    cts = hk["ca"].texts
    jsk.enable_crt = tsk.enable_crt = False
    try:
        jout = jsk.decrypt(ptpu.CipherText(hk["jpk"], cts)).texts
        tout = tsk.decrypt(hk["ca"])
        assert isinstance(tout.device_payload(), DevLimbs)
        assert tout.texts == jout == hk["a"]
    finally:
        jsk.enable_crt = tsk.enable_crt = True


def test_grouped_crt_decrypt_equals_folded(hk):
    eng = hk["tsk"]._engine
    payload = hk["cb"].device_payload()
    folded = eng._decrypt_crt_impl(payload).fetch()
    grouped = eng._decrypt_crt_impl(payload, grouped=True).fetch()
    assert grouped == folded == hk["b"]
    assert "maskB" not in eng.rns_crt_stacked[0] and "maskB" in eng.rns_crt[0]


def test_chain_stays_on_the_device(hk):
    """encrypt -> CT+CT -> CT+PT -> CT*PT -> apply_obfuscator -> decrypt
    without a host round trip in between."""
    n = hk["n"]
    pk, sk = hk["tnpk"], hk["tsk"]
    ct = (hk["ca"] + hk["cb"] + ptorch.PlainText([7])) * ptorch.PlainText([3])
    ct = pk.apply_obfuscator(ct)
    assert ct._texts is None and isinstance(ct.device_payload(), DevLimbs)
    want = [((x + y + 7) * 3) % n for x, y in zip(hk["a"], hk["b"])]
    assert sk.decrypt(ct).texts == want
