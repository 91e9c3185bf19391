"""Serialization in the PyTorch/CUDA port: the cereal-PortableBinary layout
on the port's keys and texts, byte for byte the JAX package's, against the
frozen wire images of the format, and through a round trip with a
device-resident ciphertext batch (``device="cpu"`` here).  Tolerance: equal
bytes, equal integers."""

import io
import random

import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.utils import serialize as jser
from pailliercryptolib_tpu_torch import CipherText, PlainText, PrivateKey, PublicKey
from pailliercryptolib_tpu_torch.convert import keys_from_ints
from pailliercryptolib_tpu_torch.utils import serialize as ser

# Frozen wire images, derived by hand from the cereal 1.3.2 PortableBinary
# grammar: p = 2^32 - 5, q = 2^32 - 17 (both prime), n = p * q (64 bits),
# DJN hs = 0x0102030405060708090a0b0c, randbits = 32.
G_P, G_Q = 4294967291, 4294967279
G_N = G_P * G_Q
G_HS = 0x0102030405060708090A0B0C
GOLDEN_PK = bytes.fromhex(
    "010000000040000000012000000000000000020000000000000055000000eaffff"
    "ff0100000003000000000000000c0b0a09080706050403020101000000"
)
GOLDEN_SK = bytes.fromhex(
    "010000000020000000000000000100000000000000efffffff0100000001000000"
    "00000000fbffffff01000000"
)
GOLDEN_PT = bytes.fromhex(
    "010000000000000000020000000000000002000000000000000000000001000000"
    "0000000005000000010000000200000000000000000000000001000001000000"
)
GOLDEN_CT = bytes.fromhex(
    "010000000000000000010000000000000001000000000000000000000001000000"
    "000000000300000001000000000000004000000001200000000200000000000000"
    "55000000eaffffff0100000003000000000000000c0b0a090807060504030201"
    "01000000"
)


@pytest.fixture(scope="module")
def key():
    return ptorch.generate_keypair(256, enable_DJN=True, device="cpu")


def _golden_objects():
    pk = PublicKey(G_N, 64, hs=G_HS, randbits=32, device="cpu")
    return {
        "public_key": (pk, GOLDEN_PK, PublicKey),
        "private_key": (PrivateKey(G_N, G_P, G_Q, device="cpu"), GOLDEN_SK, PrivateKey),
        "plaintext": (PlainText([5, 1 << 40]), GOLDEN_PT, PlainText),
        "ciphertext": (CipherText(pk, [3]), GOLDEN_CT, CipherText),
    }


@pytest.mark.parametrize("what", ["public_key", "private_key", "plaintext", "ciphertext"])
def test_golden_bytes(what):
    obj, golden, cls = _golden_objects()[what]
    assert ser.dumps(obj) == golden
    back = ser.loads(golden, cls, device="cpu")
    assert ser.dumps(back) == golden
    if what == "public_key":
        assert (back.n, back.bits, back.hs, back.randbits) == (G_N, 64, G_HS, 32)
        assert back.is_djn() and back.device == torch.device("cpu")
    elif what == "private_key":
        assert (back.p, back.q) == (min(G_P, G_Q), max(G_P, G_Q))
        assert back.device == torch.device("cpu")
    elif what == "plaintext":
        assert back.texts == [5, 1 << 40]
    else:
        assert back.texts == [3] and back.public_key.n == G_N
        assert back.public_key.device == torch.device("cpu")


@pytest.mark.parametrize("djn", [True, False])
def test_bytes_equal_the_jax_packages(key, djn):
    """The same key and texts in both packages serialize to the same bytes,
    and each package loads what the other wrote."""
    n, p, q = key.pub_key.n, key.priv_key.p, key.priv_key.q
    hs, rb = (key.pub_key.hs, key.pub_key.randbits) if djn else (None, None)
    t = keys_from_ints(n, p, q, hs, rb, device="cpu")
    if djn:
        jpk = ptpu.PublicKey(n, 256, hs=hs, randbits=rb)
    else:
        jpk = ptpu.PublicKey(n, 256)
    jsk = ptpu.PrivateKey(jpk, p, q)
    assert ser.dumps(t.pub_key) == jser.dumps(jpk)
    assert ser.dumps(t.priv_key) == jser.dumps(jsk)
    rng = random.Random(4)
    vals = [rng.getrandbits(200) for _ in range(5)] + [0]
    assert ser.dumps(PlainText(vals)) == jser.dumps(ptpu.PlainText(vals))
    cts = [rng.randrange(n * n) for _ in range(3)]
    data = ser.dumps(CipherText(t.pub_key, cts))
    assert data == jser.dumps(ptpu.CipherText(jpk, cts))
    back = jser.loads(data, ptpu.CipherText)
    assert back.texts == cts and back.public_key.n == n
    mine = ser.loads(jser.dumps(jsk), PrivateKey, device="cpu")
    assert mine == t.priv_key and mine.hp == jsk.hp and mine.x == jsk.x


def test_roundtrip_with_a_device_resident_ciphertext(key):
    """Keys and a ciphertext batch survive dumps / loads and still decrypt;
    a batch that lives in device limbs is written through its lazy download."""
    rng = random.Random(8)
    vals = [rng.getrandbits(64) for _ in range(7)]
    ct = key.pub_key.encrypt(PlainText(vals))
    assert ct._texts is None  # device-resident until someone reads .texts
    data = ser.dumps(ct)
    assert ct._texts is not None
    ct2 = ser.loads(data, CipherText, device="cpu")
    assert ct2.texts == ct.texts and ct2.public_key == key.pub_key
    pk2 = ser.loads(ser.dumps(key.pub_key), PublicKey, device="cpu")
    sk2 = ser.loads(ser.dumps(key.priv_key), PrivateKey, device="cpu")
    assert (pk2.n, pk2.hs, pk2.randbits, pk2.enable_djn_flag) == (
        key.pub_key.n, key.pub_key.hs, key.pub_key.randbits, True)
    assert sk2 == key.priv_key and sk2.hq == key.priv_key.hq
    assert sk2.decrypt(ct2).texts == vals
    assert key.priv_key.decrypt(pk2.encrypt(PlainText(vals))).texts == vals
    assert sk2.decrypt(ct2 + ct2).texts == [2 * v for v in vals]


def test_stream_and_file_helpers(tmp_path, key):
    buf = io.BytesIO()
    ser.serialize(buf, key.pub_key)
    assert buf.getvalue() == ser.dumps(key.pub_key)
    assert buf.getvalue()[0] == 1  # little-endian flag
    assert int.from_bytes(buf.getvalue()[5:9], "little") == key.pub_key.bits
    buf.seek(0)
    assert ser.deserialize(buf, PublicKey, device="cpu") == key.pub_key
    path = str(tmp_path / "sk.bin")
    assert ser.serialize_to_file(path, key.priv_key)
    assert ser.deserialize_from_file(path, PrivateKey, device="cpu") == key.priv_key
    assert not ser.serialize_to_file(str(tmp_path / "no" / "dir" / "x.bin"), key.pub_key)


def test_bad_input_raises(key):
    w = io.BytesIO()
    writer = ser._Writer(w)
    writer.bignum(0)
    writer.bignum(-(2**70))
    r = ser._Reader(io.BytesIO(w.getvalue()))
    assert r.bignum() == 0 and r.bignum() == -(2**70)
    with pytest.raises(ValueError):
        ser.loads(b"\x00" + ser.dumps(key.pub_key)[1:], PublicKey, device="cpu")
    with pytest.raises(EOFError):
        ser.loads(ser.dumps(key.pub_key)[:-3], PublicKey, device="cpu")
    with pytest.raises(TypeError):
        ser.dumps(object())
    with pytest.raises(TypeError):
        ser.loads(ser.dumps(key.pub_key), dict, device="cpu")


def test_load_defaults_to_the_card():
    """``device`` defaults to ``"cuda"`` on load, and without a GPU that
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError):
        ser.loads(GOLDEN_PK, PublicKey)
    with pytest.raises(RuntimeError):
        ser.loads(GOLDEN_SK, PrivateKey)
    assert ser.loads(GOLDEN_PT, PlainText).texts == [5, 1 << 40]  # no device needed
