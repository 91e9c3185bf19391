"""A 3072-bit key in the PyTorch/CUDA port, on the CPU: the engines' CRT
layout rule (grouped, by the reference's rule, with the reference's constant
set), and the public API on all three backends against Python ``pow()``.
The port runs on ``device="cpu"``, where the kernel wrappers take their plain
versions.  Tolerance: exact integer equality.  Batch 4 and short obfuscator
exponents on the 15-bit-limb backends: the widths are the real ones, the
depth is not.  The one decrypt on ``"cios"``, whose exponent windows are the
key's own and cannot be cut, runs on a 2112-bit key (beyond the reference
library's 2048 bits, about half the cost); the GPU-marked tests and
``chip_smoke.py`` decrypt on ``"cios"`` at 3072 and 4096 bits."""

import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.models import engine as tengine
from pailliercryptolib_tpu_torch.ops import cuda_modexp, cuda_rns2

# 1536-bit primes, both 3 mod 4, gcd(p - 1, q - 1) = 2: a 3072-bit DJN key
P3072 = int(
    "cbead8e123cb7f9baccb599c054c31592a85d5b3c1629c966d6e4ad61f159e33d0bb95f1"
    "f1644e0c18deacd2ecce225c3658dbc505f9a7185b2fa0419184e1f266e514fdb7dcb8eb"
    "7ad8e6b0e9baaa79a03f8ece74f047f2dce090e541f7b05e7ef4aea00513dfef4112ac05"
    "2e3e17112778c9240d6ddff1ad4711d80d47c1981b8c3613401d326c311e9f089b438dec"
    "58aee7954f266d612c0190755d168e99a728d8602fee2efa3f0936fa2f5b6bb1af2434e1"
    "71d0cd02de7cb37841a1ee2b", 16)
Q3072 = int(
    "e4d4e97afaca06141e8956fce0ad85dc1b7db73bebe6d4f2712189463da1474d5beb494e"
    "49408668092b3d53fa6a4795c5c3a6a1b499ded249ea5056251be574d99bcecf54f13af6"
    "b980bdb6fb28e4db86f7ee810d1a4b3b7693620b186c729d1e6bbe67cd5a86fcfb17de71"
    "aecf8db35e0ba03444ea44942e562a8ef8deaf7a3571938ab87dafe61a4ca6ce3af729cd"
    "b5ffabd01abee4754f078fc7b776f3db71ad130ead15d7ef2e37ec92bb94c8493486229"
    "698b3797d3be3eea363552013", 16)
# 1056-bit primes of the same kind: a 2112-bit key
P2112 = int(
    "a6de5cb2ddc91b9ff1394e01a0a35bdc12080d50a61bb303d0b98e332de6547603f0784b"
    "00e03de474abc09b2b7ba148ae35155ddc61a4755aac50dd8b39843ea0fe29d081d0aa05"
    "aa7df3f9dafbae2d460720b259a015f00c3c8017fb3b8000eb08cb3f7b7cac22bf5864e3"
    "77f7f42af1d2484b465e939843c50a3bd8c5ea5f0cc39ebb", 16)
Q2112 = int(
    "df1196e4c4a500bd2ba45c81501e18319187d76f1c6136b96f546e994bfde6e3817cc251"
    "7040a629b4505fb5972ebdc3caca271a8964297ed6999a8597ed658f7e47293d19a684ad"
    "9bd3929b0440e5be39c5e8bb8131dc8a57ee2df20028cfc8a10976e704de0de30ff5eb8f"
    "bdbe613993a36ce088111c82f5e79b7f8f135de410646e43", 16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A few rows and a few hundred lanes: torch's intra-op threads only cost,
    and under parallel test workers they oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _consts_equal(got, want):
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(k for k in got if not k.startswith("_")) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if w.dtype == np.float32:
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), key
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), key


# ---------------------------------------------------------------------------
# a 3072-bit key: the engines' layout rule, then the public API
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def key3072():
    p, q = P3072, Q3072
    n = p * q
    assert n.bit_length() == 3072
    rng = random.Random(11)
    x = rng.randrange(2, n)
    hs = pow((-(x * x)) % n, n, n * n)
    pk = ptorch.PublicKey(n, 3072, hs=hs, randbits=1536, device="cpu")
    sk = ptorch.PrivateKey(pk, p, q)
    vals = [rng.getrandbits(64) for _ in range(3)] + [n - 1]
    rs = [rng.getrandbits(32) for _ in range(4)]
    pk.set_random(rs)
    ct = pk.encrypt(ptorch.PlainText(vals))
    return dict(n=n, n2=n * n, p=p, q=q, hs=hs, pk=pk, sk=sk, rng=rng, vals=vals,
                rs=rs, ct=ct)


def test_grouped_crt_decrypt_3072_matches_pow(key3072):
    """Wide keys take the grouped CRT layout by the reference's rule (the
    same constant set as the JAX engine builds), and decrypt right."""
    k = key3072
    eng = k["sk"]._engine
    assert not eng.crt_folded
    kc2, conv2 = eng.rns_crt
    assert "maskB" not in kc2 and kc2["sig0"].shape[0] == 2
    assert eng.rns_crt_stacked[0] is kc2
    jsk = ptpu.PrivateKey(ptpu.PublicKey(k["n"], 3072), k["p"], k["q"])
    jkc2, _ = jsk._engine.rns_crt
    assert "maskB" not in jkc2
    _consts_equal(kc2, jkc2)
    n, n2 = k["n"], k["n2"]
    want_ct = [(n * m + 1) * pow(k["hs"], r, n2) % n2 for m, r in zip(k["vals"], k["rs"])]
    assert k["ct"].texts == want_ct
    forms = dict(cuda_rns2.MODEXP2_FORMS)
    assert k["sk"].decrypt(k["ct"]).texts == k["vals"]
    assert cuda_rns2.MODEXP2_FORMS == forms  # the plain route counts nothing
    # a 2048-bit key stays folded
    small = ptorch.generate_keypair(256, device="cpu").priv_key._engine
    assert small.crt_folded and "maskB" in small.rns_crt[0]


@pytest.mark.parametrize("backend", ["rns", "cios", "plain"])
def test_wide_key_api_cpu(key3072, backend):
    """The public API at a 3072-bit key on ``device="cpu"``, against
    ``pow()``: on ``"rns"`` every operation (DJN and normal-mode encrypt,
    CT+CT, CT*PT, apply_obfuscator, CRT and RAW decrypt); on ``"cios"`` and
    ``"plain"`` — whose plain 15-bit-limb products cost tens of milliseconds
    each here — encrypt, CT+CT, CT*PT and apply_obfuscator with short
    exponents, equal to the ``"rns"`` ciphertexts, and on ``"cios"`` one CRT
    decrypt of one row of a 2112-bit key (a product there is 141 limb steps
    and the exponents 264 windows, against 205 and 384)."""
    k = key3072
    n, n2, rng = k["n"], k["n2"], k["rng"]
    vals, rs = k["vals"], k["rs"]
    if backend == "rns":
        pk, sk = k["pk"], k["sk"]
    else:  # a short obfuscator width keeps the exponent windows few
        pk = ptorch.PublicKey(n, 3072, hs=k["hs"], randbits=32, device="cpu")
        sk = ptorch.PrivateKey(pk, k["p"], k["q"])
        pk._engine.backend = sk._engine.backend = backend
        pk.set_random(rs)
        assert pk.encrypt(ptorch.PlainText(vals)).texts == k["ct"].texts
    ct = k["ct"] if backend == "rns" else ptorch.CipherText(pk, k["ct"].texts)
    two = ct + ct
    assert two.texts == [c * c % n2 for c in k["ct"].texts]
    tri = two * ptorch.PlainText([3])
    assert tri.texts == [pow(c, 6, n2) for c in k["ct"].texts]
    r2 = [rng.getrandbits(32) for _ in range(4)]
    pk.set_random(r2)
    obf = pk.apply_obfuscator(tri)
    assert obf.texts == [c * pow(k["hs"], r, n2) % n2 for c, r in zip(tri.texts, r2)]
    want = [6 * v % n for v in vals]
    if backend == "rns":
        assert sk.decrypt(obf).texts == want  # grouped CRT
        sk.enable_crt = False
        try:
            assert sk.decrypt(obf).texts == want  # RAW: K5 over n^2, full fold
        finally:
            sk.enable_crt = True
        npk = ptorch.PublicKey(n, 3072, device="cpu")  # normal mode
        rb = [rng.randrange(1, n) for _ in range(2)]
        npk.set_random(rb)
        nct = npk.encrypt(ptorch.PlainText(vals[:2]))
        assert nct.texts == [(n * m + 1) * pow(r, n, n2) % n2
                             for m, r in zip(vals, rb)]
    else:
        assert k["sk"].decrypt(obf).texts == want
        if backend == "cios":
            p2, q2 = sorted((P2112, Q2112))
            n_s = p2 * q2
            assert n_s.bit_length() == 2112
            hs_s = pow((-(7 * 7)) % n_s, n_s, n_s * n_s)
            pk_s = ptorch.PublicKey(n_s, 2112, hs=hs_s, randbits=32, device="cpu")
            sk_s = ptorch.PrivateKey(pk_s, p2, q2)
            pk_s._engine.backend = sk_s._engine.backend = backend
            pk_s.set_random(rs[:1])
            one = pk_s.encrypt(ptorch.PlainText([n_s - 2]))
            assert one.texts == [(n_s * (n_s - 2) + 1) * pow(hs_s, rs[0], n_s * n_s)
                                 % (n_s * n_s)]
            assert sk_s.decrypt(one).texts == [n_s - 2]
    assert pk._engine._secondary is None and sk._engine._secondary is None


def test_key_size_limits():
    """Above 4096 bits the key generator and the engines raise the
    reference's ValueError; 3072 and 4096 bits are accepted."""
    with pytest.raises(ValueError, match="exceeds supported range"):
        ptorch.generate_keypair(4100, device="cpu")
    with pytest.raises(ValueError, match="exceeds supported range"):
        ptpu.generate_keypair(4100)
    with pytest.raises(ValueError):
        tengine.PublicEngine((1 << 4099) | 1, 4100, None, 2050, device="cpu")
    for bits in (3072, 4096):
        eng = tengine.PublicEngine((1 << (bits - 1)) | 1, bits, None, bits // 2,
                                   backend="cios", device="cpu")
        assert eng.backend == "cios" and eng.L2 <= cuda_modexp.KERNEL_MAX_L
