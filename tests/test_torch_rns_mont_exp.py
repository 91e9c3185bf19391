"""``rns_mont_exp`` of the PyTorch/CUDA port against the JAX package's, on the
CPU: the same seeded bases and exponents through both, canonical values
(after ``rns_to_limbs``) equal to each other and to ``pow(b, e, N)``, the
port's at most 2N.  Residues are not compared: the Kawamura estimate may
land the two on representatives that differ by N (ROADMAP.md, "Known, not
faults"), the canonical value decides.  Tolerance: exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as jlb
from pailliercryptolib_tpu.ops import rns as jrns
from pailliercryptolib_tpu_torch.ops import limbs as tlb
from pailliercryptolib_tpu_torch.ops import rns as trns


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ctx256():
    rng = random.Random(21)
    N = rng.getrandbits(256) | (1 << 255) | 1
    jc = jrns.RNSContext.create(N)
    tc = trns.RNSContext.create(N)
    return rng, N, jc, jc.device_consts(), tc.device_consts("cpu")


def _both(x, wins, jconv, tconv):
    """Canonical values of the JAX and the port's rns_mont_exp."""
    jout = jrns.rns_mont_exp(jnp.asarray(x), jnp.asarray(wins), jconv)
    jv = jlb.limbs_to_ints(np.asarray(jrns.rns_to_limbs(jout, jconv)))
    tx = torch.from_numpy(x.astype(np.int32))
    tw = torch.from_numpy(wins.astype(np.int32))
    tout = trns.rns_mont_exp(tx, tw, tconv)
    assert tout.dtype == torch.int32 and tout.shape == tx.shape
    tv = tlb.limbs_to_ints(trns.rns_to_limbs(tout, tconv).numpy().astype(np.uint32))
    return [int(v) for v in jv], [int(v) for v in tv]


@pytest.mark.parametrize("ebits", [1, 16, 64])
def test_rns_mont_exp_equals_jax_and_pow(ctx256, ebits):
    rng, N, jc, jconv, tconv = ctx256
    B = 8
    bases = [rng.randrange(N) for _ in range(B)]
    exps = [rng.getrandbits(ebits) for _ in range(B - 2)] + [0, 1]
    x = np.stack([jc.to_residues(v) for v in bases])
    wins = tlb.ints_to_windows(exps, ebits)
    assert np.array_equal(wins, jlb.ints_to_windows(exps, ebits))
    jv, tv = _both(x, wins, jconv, tconv)
    assert tv == jv
    for b, e, v in zip(bases, exps, tv):
        assert v % N == pow(b, e, N)
        assert v <= 2 * N


def test_rns_mont_exp_shared_window_row(ctx256):
    """One exponent for every row: windows [1, NW] broadcast over the batch."""
    rng, N, jc, jconv, tconv = ctx256
    B = 8
    bases = [rng.randrange(N) for _ in range(B - 1)] + [N - 1]
    e = rng.getrandbits(40)
    x = np.stack([jc.to_residues(v) for v in bases])
    wins = tlb.ints_to_windows([e], 40)
    assert wins.shape == (1, 10)
    jv, tv = _both(x, wins, jconv, tconv)
    assert tv == jv
    for b, v in zip(bases, tv):
        assert v % N == pow(b, e, N) and v <= 2 * N
