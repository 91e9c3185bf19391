"""K3 and K5 in the narrow layout's two halves out of step
(csrc/rns_mont_mul_tc.cuh Narrow) on a GPU, against their plain versions and
the same kernels in the layout's one half (``rns_modexp2f_unsplit``,
``rns_modexp2_unsplit``), bit for bit, at the sets of the benchmark's cells:
the n^2 set of a 2048-bit key (K5 shared and per-row), the folded p^2 / q^2
set of a 2048-bit key (K3) and the stacked p^2 / q^2 pair of a 4096-bit key
(K5 grouped L548); and a set whose last CTA owns no lane of the contraction
(it signals its digit exchanges by arrivals).  Batches within one cluster,
ragged last clusters and a half left empty (1, 40, 71, 72, 73, 4097 rows),
two streams with a call outstanding on each, and the split form's counter.
Windows are short (the kernels' correctness does not depend on their count).

Needs an NVIDIA GPU and ``nvcc``; skips without one.  Imports nothing of JAX:

    python -m pytest tests/test_torch_cuda_split.py -q --noconftest -o addopts="" -m cuda
"""

import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.models.keygen import get_prime
from pailliercryptolib_tpu_torch.ops import cuda_rns2
from pailliercryptolib_tpu_torch.ops import limbs as lb
from pailliercryptolib_tpu_torch.ops.montgomery import to_i32
from pailliercryptolib_tpu_torch.ops.rns import RNSContext

pytestmark = pytest.mark.cuda

BATCHES = [1, 40, 71, 72, 73, 4097]
NW = 6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU form")
    return torch.device("cuda")


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _one_system(bits, seed, dev):
    rng = random.Random(seed)
    while True:
        try:
            ctx = RNSContext.create(_odd(rng, bits))
            break
        except ValueError:  # a modulus that shares a factor with the base
            continue
    return cuda_rns2.stack_group_consts2([ctx], device=dev)


def _crt_ctxs(pbits):
    p, q = sorted((get_prime(pbits), get_prime(pbits)))
    in_limbs = 2 * lb.limbs_for_bits(2 * pbits)
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    return in_limbs, [RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
                      for h in (p, q)]


@pytest.fixture(scope="module")
def n2_2048(dev):
    """K5's set for a 2048-bit key's n^2 (normal encrypt, CT*PT, RAW decrypt)."""
    return _one_system(4096, 8, dev)


@pytest.fixture(scope="module")
def no_contraction_lanes(dev):
    """A set of 256 lanes with k = 192: the last CTA's lanes lie past the
    contraction (32 KC = 192) and hold the redundant lane."""
    kc = _one_system(2616, 3, dev)
    p = cuda_rns2._tc_pack(kc, "rns_modexp2")
    assert (p["k"], p["W"], p["KC"], p["halves"]) == (192, 256, 6, 2)
    return kc


@pytest.fixture(scope="module")
def folded_2048(dev):
    in_limbs, ctxs = _crt_ctxs(1024)
    return in_limbs, cuda_rns2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True,
                                                  device=dev)


@pytest.fixture(scope="module")
def grouped_4096(dev):
    in_limbs, ctxs = _crt_ctxs(2048)
    kc = cuda_rns2.stack_group_consts2(ctxs, f32_mu=True, device=dev)
    p = cuda_rns2._tc_pack(kc, "rns_modexp2")
    assert (p["k"], p["G"], p["halves"], in_limbs) == (305, 2, 2, 548)
    return in_limbs, kc


def _limbs(seed, shape, dev):
    return to_i32(np.random.default_rng(seed).integers(0, 1 << 15, shape), dev)


def _wins(seed, shape, dev):
    return to_i32(np.random.default_rng(seed).integers(0, 16, shape), dev)


def _k5_case(kc, B, shared, dev, in_limbs=None):
    G = kc["sig0"].shape[0]
    L = in_limbs or kc["CinA"].shape[-2]
    x = _limbs(B, (1, B, L), dev)
    wins = _wins(B + 1, (G, NW) if shared else (G, B, NW), dev)
    return x, wins


def _split_counted(kernel, fn):
    """``fn()`` and the launches it made of ``kernel``'s library form and its
    split form."""
    forms = dict(cuda_rns2.KERNEL_FORMS)
    out = fn()
    return out, (cuda_rns2.KERNEL_FORMS[f"{kernel}_tc"] - forms[f"{kernel}_tc"],
                 cuda_rns2.KERNEL_FORMS[f"{kernel}_tc_split"] - forms[f"{kernel}_tc_split"])


@pytest.mark.parametrize("B", BATCHES)
def test_k3_split_equals_plain_and_one_half(dev, folded_2048, B):
    in_limbs, kc2 = folded_2048
    x = _limbs(B, (B, in_limbs), dev)
    wins = _wins(B, (2, NW), dev)
    got, made = _split_counted("rns_modexp2f", lambda: cuda_rns2.rns_modexp2f(x, wins, kc2))
    assert made == (1, 1)
    assert torch.equal(got, cuda_rns2.rns_modexp2f_plain(x, wins, kc2))
    assert torch.equal(got, cuda_rns2.rns_modexp2f_unsplit(x, wins, kc2))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "var"])
@pytest.mark.parametrize("B", BATCHES)
def test_k5_split_equals_plain_and_one_half(dev, n2_2048, B, shared):
    x, wins = _k5_case(n2_2048, B, shared, dev)
    got, made = _split_counted(
        "rns_modexp2", lambda: cuda_rns2.rns_modexp2(x, wins, n2_2048, shared=shared))
    assert made == (1, 1)
    assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, wins, n2_2048, shared=shared))
    assert torch.equal(got, cuda_rns2.rns_modexp2_unsplit(x, wins, n2_2048, shared=shared))


@pytest.mark.parametrize("B", BATCHES)
def test_k5_grouped_l548_split_equals_plain_and_one_half(dev, grouped_4096, B):
    in_limbs, kc = grouped_4096
    x, wins = _k5_case(kc, B, True, dev, in_limbs)
    got, made = _split_counted(
        "rns_modexp2", lambda: cuda_rns2.rns_modexp2(x, wins, kc, shared=True))
    assert made == (1, 1)
    assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=True))
    assert torch.equal(got, cuda_rns2.rns_modexp2_unsplit(x, wins, kc, shared=True))


@pytest.mark.parametrize("B", [73, 4097])
def test_k5_split_without_contraction_lanes(dev, no_contraction_lanes, B):
    kc = no_contraction_lanes
    x, wins = _k5_case(kc, B, False, dev)
    got, made = _split_counted(
        "rns_modexp2", lambda: cuda_rns2.rns_modexp2(x, wins, kc, shared=False))
    assert made == (1, 1)
    assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=False))
    assert torch.equal(got, cuda_rns2.rns_modexp2_unsplit(x, wins, kc, shared=False))


def test_split_on_two_streams(dev, folded_2048, n2_2048):
    """A K3 and a K5 call outstanding on two streams at once, each equal to
    its one-half form run alone."""
    in_limbs, kc2 = folded_2048
    x3, w3 = _limbs(5, (4097, in_limbs), dev), _wins(5, (2, NW), dev)
    x5, w5 = _k5_case(n2_2048, 4097, True, dev)
    want3 = cuda_rns2.rns_modexp2f_unsplit(x3, w3, kc2)
    want5 = cuda_rns2.rns_modexp2_unsplit(x5, w5, n2_2048, shared=True)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    outs = []
    for _ in range(2):
        with torch.cuda.stream(s1):
            outs.append(("k3", cuda_rns2.rns_modexp2f(x3, w3, kc2)))
        with torch.cuda.stream(s2):
            outs.append(("k5", cuda_rns2.rns_modexp2(x5, w5, n2_2048, shared=True)))
    torch.cuda.synchronize()
    for name, got in outs:
        assert torch.equal(got, want3 if name == "k3" else want5), name


def test_layouts_of_one_half_count_no_split(dev):
    """K5 on the small layout (sets of up to 160 lanes) keeps its one half:
    its launches count no split form, and the one-half form refuses its set."""
    kc = _one_system(1024, 4, dev)
    assert cuda_rns2._tc_pack(kc, "rns_modexp2")["halves"] == 1
    x, wins = _k5_case(kc, 73, True, dev)
    got, made = _split_counted(
        "rns_modexp2", lambda: cuda_rns2.rns_modexp2(x, wins, kc, shared=True))
    assert made == (1, 0)
    assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=True))
    with pytest.raises(ValueError):
        cuda_rns2.rns_modexp2_unsplit(x, wins, kc, shared=True)


def test_p5_product_split_equals_one_half(dev, folded_2048):
    """P5's chain of products in both forms, with and without extensions,
    against its plain version."""
    from pailliercryptolib_tpu_torch.ops import cuda_probes

    _, kc2 = folded_2048
    r = np.random.default_rng(9)
    x = torch.cat([to_i32(r.integers(0, 1 << 30, (73, m.shape[-1])) % m.cpu().numpy(), dev)
                   for m in (kc2["modsA"][0], kc2["modsBx"][0])], dim=1)
    for ext in (True, False):
        got = cuda_probes.mont_chain(x, kc2, 3, "tc", ext)
        assert torch.equal(got, cuda_probes.mont_chain(x, kc2, 3, "unsplit", ext))
        assert torch.equal(got, cuda_probes.mont_chain_plain(x, kc2, 3, ext))
