"""The port's CUDA kernels on a GPU, at small shapes: each kernel against its
plain PyTorch version on the same CUDA tensors (tolerance: exact equality),
ragged batches, and encrypt -> decrypt through the public API on ``device="cuda"``.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are compiled at
first use) and skip without one.  The file imports nothing of JAX, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts="" -m cuda

``chip_smoke.py`` makes the same comparison at the full 2048-bit shapes.
"""

import random

import numpy as np
import pytest
import torch

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.models.keygen import get_prime
from pailliercryptolib_tpu_torch.ops import cuda_modexp, cuda_rns2
from pailliercryptolib_tpu_torch.ops import limbs as lb
from pailliercryptolib_tpu_torch.ops.montgomery import MontConstants, to_i32
from pailliercryptolib_tpu_torch.ops.rns import RNSContext

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU form")
    return torch.device("cuda")


def _residues(r, mods, rows, dev):
    m = mods.cpu().numpy().astype(np.int64)
    return to_i32(r.integers(0, 1 << 30, (rows, m.shape[0])) % m, dev)


@pytest.mark.parametrize("bits,B", [(256, 37), (1024, 128)])
def test_fixed_base_kernels_equal_plain(dev, bits, B):
    rng = random.Random(bits)
    r = np.random.default_rng(bits)
    N = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    kc = cuda_rns2.stack_group_consts2([RNSContext.create(N)], device=dev)
    NP = 8
    gA = _residues(r, kc["modsA"][0], NP, dev)[None]
    gB = _residues(r, kc["modsBx"][0], NP, dev)[None]
    before = dict(cuda_rns2.LAUNCHES)
    tabA, tabB = cuda_rns2.fb_table2(gA, gB, kc)
    pA, pB = cuda_rns2.fb_table2_plain(gA, gB, kc)
    assert tabA.is_cuda and torch.equal(tabA, pA) and torch.equal(tabB, pB)
    tab = cuda_rns2.fb_gather_table(tabA, tabB)
    wins = torch.from_numpy(r.integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    for mont_out in (False, True):
        got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=mont_out)
        want = cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=mont_out)
        assert got.is_cuda and torch.equal(got, want)
    assert cuda_rns2.LAUNCHES["fb_table2"] == before["fb_table2"] + 1
    assert cuda_rns2.LAUNCHES["fb_modexp2"] == before["fb_modexp2"] + 2


@pytest.mark.parametrize("pbits,B", [(64, 19), (256, 130)])
def test_folded_modexp_kernel_equal_plain(dev, pbits, B):
    r = np.random.default_rng(pbits)
    p, q = sorted((get_prime(pbits), get_prime(pbits)))
    in_limbs = 2 * lb.limbs_for_bits(2 * pbits)
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [
        RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
        for h in (p, q)
    ]
    kc2 = cuda_rns2.fold_group_consts2(
        ctxs, f32_mu=True, shared_input=True, device=dev
    )
    x = to_i32(r.integers(0, 1 << 15, (B, in_limbs)), dev)
    ewbits = max(8, -(-lb.num_windows(pbits) // 8) * 8) * 4
    wins = to_i32(
        np.concatenate(
            [lb.ints_to_windows([p - 1], ewbits), lb.ints_to_windows([q - 1], ewbits)]
        ),
        dev,
    )
    got = cuda_rns2.rns_modexp2f(x, wins, kc2)
    assert got.is_cuda and torch.equal(got, cuda_rns2.rns_modexp2f_plain(x, wins, kc2))


def test_mod_mul_kernel_equal_plain(dev):
    rng = random.Random(7)
    ns = [rng.getrandbits(512) | (1 << 511) | 1 for _ in range(2)]
    cs = [MontConstants.create(n) for n in ns]
    L, B = cs[0].num_limbs, 70
    a = torch.stack(
        [to_i32(lb.ints_to_limbs([rng.randrange(n) for _ in range(B)], L), dev) for n in ns]
    )
    b = torch.stack(
        [to_i32(lb.ints_to_limbs([rng.randrange(n)], L), dev) for n in ns]
    )  # [2, 1, L]
    n = to_i32(np.stack([c.n_limbs for c in cs]), dev)
    r2 = to_i32(np.stack([c.r2_limbs for c in cs]), dev)
    n0 = to_i32(np.array([c.n0inv for c in cs]), dev)
    got = cuda_modexp.mod_mul(a, b, n, n0, r2)
    assert got.is_cuda and torch.equal(got, cuda_modexp.mod_mul_plain(a, b, n, n0, r2))
    one = cuda_modexp.mod_mul(a[1:], b[1, 0], n[1:], n0[1:], r2[1:])
    assert torch.equal(one[0], got[1])


def test_slice_on_gpu(dev):
    """Round trip and the injected-r oracle through the public API."""
    key = ptorch.generate_keypair(512, enable_DJN=True)  # device="cuda"
    pk, sk = key.pub_key, key.priv_key
    rng = random.Random(1)
    vals = [rng.getrandbits(64) for _ in range(45)]
    ct = pk.encrypt(ptorch.PlainText(vals))
    assert ct.device_payload().arr.is_cuda
    assert sk.decrypt(ct).texts == vals
    rs = [rng.getrandbits(pk.randbits) for _ in range(3)]
    pk.set_random(rs)
    got = pk.encrypt(ptorch.PlainText(vals[:3])).texts
    n, n2 = pk.n, pk.nsquare
    assert got == [(n * m + 1) * pow(pk.hs, r, n2) % n2 for m, r in zip(vals, rs)]
    # tensors on the wrong device are refused, not moved
    with pytest.raises(ValueError):
        cuda_rns2.fb_modexp2(
            pk._engine.fixedbase[0], torch.zeros((1, 2, pk._engine.fixedbase[1]),
                                                 dtype=torch.uint8),
            pk._engine.rns[1],
        )
