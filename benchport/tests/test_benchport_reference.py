"""The plain reference: ChaCha20 against RFC 8439, Paillier against the
ISO/IEC 18033-6 vectors, the frozen keystream map against the program's,
and each control against the reference."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from kit import REPO, SMALL_P, SMALL_Q

from benchport.reference import chacha20, paillier

ISO = {k: int(v, 16) for k, v in json.loads(
    (REPO / "benchport" / "reference" / "iso_vectors.json").read_text()).items()
    if k not in ("source", "note")}
RFC_KEY = np.frombuffer(bytes(range(32)), "<u4")


def test_chacha20_block_rfc8439_2_3_2():
    nonce = np.frombuffer(bytes.fromhex("000000090000004a00000000"), "<u4")
    out = chacha20.blocks(RFC_KEY, nonce, 1, counter=1)[0].tobytes().hex()
    assert out == ("10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
                   "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


def test_chacha20_encryption_rfc8439_2_4_2():
    nonce = np.frombuffer(bytes.fromhex("000000000000004a00000000"), "<u4")
    text = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
            b"tip for the future, sunscreen would be it.")
    ks = chacha20.blocks(RFC_KEY, nonce, 2, counter=1).reshape(-1)[: len(text)]
    ct = bytes(np.frombuffer(text, np.uint8) ^ ks)
    assert ct[:16].hex() == "6e2e359a2568f98041ba0728dd0d6981"
    assert ct[96:112].hex() == "5af90bbf74a35be6b40b8eedf2785e42"
    assert ct[112:].hex() == "874d"


def test_chacha20_against_cryptography():
    crypto = pytest.importorskip("cryptography.hazmat.primitives.ciphers")
    words = np.arange(11, dtype=np.uint32) * np.uint32(0x9E3779B9)
    key, nonce = words[:8].astype("<u4").tobytes(), words[8:].astype("<u4").tobytes()
    enc = crypto.Cipher(crypto.algorithms.ChaCha20(key, bytes(4) + nonce), None).encryptor()
    want = enc.update(bytes(64 * 37))
    assert chacha20.blocks(words[:8], words[8:], 37).tobytes() == want
    rows = [0, 5, 36]
    got = chacha20.row_bytes(words, rows, 64)
    assert [g.tobytes() for g in got] == [want[64 * r : 64 * r + 64] for r in rows]
    # rows that straddle blocks
    got = chacha20.row_bytes(words, [0, 1, 2, 7], 513)
    assert [g.tobytes() for g in got] == [
        enc2[513 * r : 513 * r + 513]
        for enc2 in [crypto.Cipher(crypto.algorithms.ChaCha20(key, bytes(4) + nonce), None)
                     .encryptor().update(bytes(513 * 8))]
        for r in (0, 1, 2, 7)
    ]


@pytest.mark.parametrize("batch,nbytes", [(5, 128), (3, 513), (9, 16)])
def test_frozen_map_is_the_programs(batch, nbytes):
    """The program's device expansion (run here by its plain torch form)
    reads the same bytes for every row as the reference's frozen copy."""
    torch = pytest.importorskip("torch")
    from pailliercryptolib_tpu_torch.ops import paillier_ops

    words = np.random.default_rng(7).integers(0, 1 << 32, 11, dtype=np.uint64).astype(np.uint32)
    seed = torch.from_numpy(words.astype(np.int64)[None])
    prog = paillier_ops._chacha_bytes(seed, batch, nbytes).numpy()
    ref = chacha20.row_bytes(words, range(batch), nbytes)
    assert np.array_equal(prog, ref)


def test_iso_vectors():
    p, q = ISO["p"], ISO["q"]
    n = p * q
    n2 = n * n
    assert paillier.encrypt(n, ISO["m1"], pow(ISO["r0"], n, n2)) == ISO["c1"]
    assert paillier.encrypt(n, ISO["m2"], pow(ISO["r1"], n, n2)) == ISO["c2"]
    assert paillier.decrypt_crt_row(p, q, ISO["c1"]) == ISO["m1"]
    assert paillier.decrypt_crt_row(q, p, ISO["c2"]) == ISO["m2"]
    assert ISO["c1"] * ISO["c2"] % n2 == ISO["c1c2"]
    assert paillier.decrypt_crt_row(p, q, ISO["c1c2"]) == ISO["m1m2"]


def _small():
    p, q = int(SMALL_P, 16), int(SMALL_Q, 16)
    return p, q, p * q


def test_round_trips_and_controls():
    p, q, n = _small()
    hs = paillier.djn_hs(n, 123456789)
    words = np.arange(11, dtype=np.uint32)
    for row, m in enumerate([0, 1, 2**64 - 1, n - 1]):
        c = paillier.encrypt_djn_row(n, hs, 128, words, row, m)
        assert paillier.decrypt_crt_row(p, q, c) == m
        assert paillier.control_encrypt_djn_row(n, hs, 128, words, row, m) != c
        c = paillier.encrypt_normal_row(n, words, row, m)
        assert paillier.decrypt_crt_row(p, q, c) == m
        assert paillier.control_encrypt_normal_row(n, words, row, m) != c
    c = 987654321987654321 % (n * n)
    assert math.gcd(c, n) == 1
    assert paillier.control_decrypt_crt_row(p, q, c) != paillier.decrypt_crt_row(p, q, c)


def test_normal_base_acts_as_its_residue():
    """The unreduced base of 2|n| + 3 bits gives r^n = (r mod n)^n mod n^2."""
    _, _, n = _small()
    (r,) = chacha20.normal_bases(np.arange(11, dtype=np.uint32), [3], n.bit_length())
    assert r.bit_length() > n.bit_length()
    assert pow(r, n, n * n) == pow(r % n, n, n * n)
