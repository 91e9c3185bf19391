"""The host-RNG switch of the PyTorch/CUDA port (``PAILLIER_TORCH_HOST_RNG``,
utils/rng.use_device_rng) against the JAX package's
(``PAILLIER_TPU_HOST_RNG``): fresh obfuscators are a DeviceSeed expanded on
the device unless the switch is set, and then host draws of the same kinds
as the reference's, on the CPU."""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.utils import rng as jrng
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.utils import rng as trng


@pytest.fixture(scope="module")
def keys():
    torch.set_num_threads(1)
    djn = ptorch.generate_keypair(256, enable_DJN=True, device="cpu")
    normal = ptorch.generate_keypair(256, enable_DJN=False, device="cpu")
    jdjn = ptpu.PublicKey(djn.pub_key.n, 256, hs=djn.pub_key.hs,
                          randbits=djn.pub_key.randbits)
    jnormal = ptpu.PublicKey(normal.pub_key.n, 256)
    return djn, normal, jdjn, jnormal


def _kind(r):
    if isinstance(r, (trng.DeviceSeed, jrng.DeviceSeed)):
        return "seed"
    if isinstance(r, np.ndarray):
        return ("bytes", r.dtype, r.shape)
    assert isinstance(r, list) and all(isinstance(v, int) for v in r)
    return ("ints", len(r))


@pytest.mark.parametrize("host", [False, True])
def test_draws_follow_the_reference(keys, monkeypatch, host):
    djn, normal, jdjn, jnormal = keys
    if host:
        monkeypatch.setenv("PAILLIER_TORCH_HOST_RNG", "1")
        monkeypatch.setenv("PAILLIER_TPU_HOST_RNG", "1")
    assert trng.use_device_rng() is (not host) is jrng.use_device_rng()
    for tpk, jpk in ((djn.pub_key, jdjn), (normal.pub_key, jnormal)):
        for op in ("encrypt", "obfuscate"):
            got, want = tpk._draw_randoms(5, op=op), jpk._draw_randoms(5, op=op)
            assert _kind(got) == _kind(want), (tpk, op)
    r = djn.pub_key._draw_randoms(5)
    if host:
        assert r.dtype == np.uint8 and r.shape == (5, -(-djn.pub_key.randbits // 8))
        bases = normal.pub_key._draw_randoms(5)
        assert all(1 <= v < normal.pub_key.n for v in bases)
    else:
        assert isinstance(r, trng.DeviceSeed)
        assert isinstance(normal.pub_key._draw_randoms(5), trng.DeviceSeed)


@pytest.mark.parametrize("host", [False, True])
def test_encrypt_roundtrip_and_device_expansion(keys, monkeypatch, host):
    """On "rns" the round trip holds either way; the ChaCha20 keystream runs
    only without the switch."""
    djn, normal, _, _ = keys
    if host:
        monkeypatch.setenv("PAILLIER_TORCH_HOST_RNG", "1")
    calls = []
    orig = tpops._chacha20_blocks
    monkeypatch.setattr(tpops, "_chacha20_blocks",
                        lambda *a: calls.append(1) or orig(*a))
    vals = list(range(1, 41))
    for k in (djn, normal):
        assert k.pub_key._engine.backend == "rns"
        c1 = k.pub_key.encrypt(ptorch.PlainText(vals))
        c2 = k.pub_key.encrypt(ptorch.PlainText(vals))
        assert c1.texts != c2.texts
        assert k.priv_key.decrypt(c1).texts == vals == k.priv_key.decrypt(c2).texts
    assert (len(calls) == 0) is host
