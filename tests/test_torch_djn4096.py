"""The 4096-bit DJN key of the benchmark's configuration ``djn4096``
(benchport/configs/djn4096.json) in the PyTorch/CUDA port, against the
benchmark's plain reference (benchport/reference/paillier.py, Python ints).

On the CPU: the key's CRT decrypt takes the grouped layout, and the public
API decrypts three rows of it exactly; ``RNSContext``'s conversion constants
equal their defining formulas at 256, 2048 and 4096 bits; the recorder's
counter ``pipelines.crt_grouped`` counts the grouped calls alone.  On the
card (marker ``cuda``, skipped without one; no JAX imported): a ragged batch
of 2049 rows on two streams, replayed, against the reference:

    python -m pytest tests/test_torch_djn4096.py -q --noconftest -o addopts="" -m cuda
"""

import json
import math
import pathlib
import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.models.engine import PrivateEngine
from pailliercryptolib_tpu_torch.models.keys import PrivateKey
from pailliercryptolib_tpu_torch.ops.limbs import LIMB_BITS
from pailliercryptolib_tpu_torch.ops.rns import RNSContext
from pailliercryptolib_tpu_torch.utils import trace

from benchport.reference import paillier

REPO = pathlib.Path(__file__).resolve().parent.parent


def _primes(name):
    c = json.loads((REPO / "benchport" / "configs" / f"{name}.json").read_text())
    return tuple(sorted((int(c["p"], 16), int(c["q"], 16))))


P, Q = _primes("djn4096")
N = P * Q
#: Two 128-bit primes, both 3 mod 4: a 256-bit key
P256 = 0xC334629E968C80B9534AAD5888183613
Q256 = 0xFC75DEAE1C1D86C891FC7F590E851FFB


def _uniform_units(n, count, seed):
    """``count`` uniform elements of Z*_{n^2}."""
    r, n2, out = random.Random(seed), n * n, []
    while len(out) < count:
        c = r.randrange(1, n2)
        if math.gcd(c, n) == 1:
            out.append(c)
    return out


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.drain()
    yield
    trace.drain()


@pytest.fixture(scope="module")
def one_thread():
    """A few rows and a few hundred lanes: torch's intra-op threads only cost,
    and under parallel test workers they oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_public_api_decrypt_on_the_grouped_layout(one_thread):
    """Two seeded uniform rows and the encryption of n - 1: the CRT decrypt on
    the grouped constants equals the reference's row for row."""
    pk = ptorch.PublicKey(N, device="cpu")
    sk = PrivateKey(pk, P, Q, device="cpu")
    eng = sk._engine
    assert eng.backend == "rns"
    assert eng.crt_folded is False
    assert eng.rns_crt is eng.rns_crt_stacked
    n2 = N * N
    obf = pow(random.Random(3).randrange(2, N), N, n2)
    rows = _uniform_units(N, 2, 4096) + [paillier.encrypt(N, N - 1, obf)]
    with trace.recording():
        got = sk.decrypt(ptorch.CipherText(pk, rows)).texts
    assert trace.drain()["counters"].get("pipelines.crt_grouped") == 1
    assert got == [paillier.decrypt_crt_row(P, Q, c) for c in rows]
    assert got[2] == N - 1


def _crt_ctx(h):
    """The CRT decrypt's context of h^2, as PrivateEngine builds it: limb rows
    over the whole n^2-wide ciphertext, above h^2's own width."""
    hbits = h.bit_length()
    lh2 = -(-2 * hbits // LIMB_BITS)
    in_limbs = 2 * lh2
    bits = 2 * hbits + LIMB_BITS + in_limbs.bit_length() + 1
    return RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)


def _check_rows_and_tables(ctx, cells):
    """Cin[l, j] = (2^(15 l) mod N) mod m_j on ``cells`` (l, j), and T1 /
    T1ext by their formulas."""
    mods = [int(m) for m in ctx.mods]
    for l, j in cells:
        assert int(ctx.Cin[l, j]) == pow(2, LIMB_BITS * l, ctx.N) % mods[j], (l, j)
    k = ctx.k
    bx = mods[k:]
    t1 = np.array([[(ctx.MA // a) % m for m in bx] for a in mods[:k]], np.uint32)
    assert ctx.T1.dtype == ctx.T1ext.dtype == ctx.Cin.dtype == np.uint32
    assert np.array_equal(ctx.T1, t1)
    assert np.array_equal(ctx.T1ext, np.vstack([t1, [[(-ctx.MA) % m for m in bx]]]))


@pytest.mark.parametrize("bits", [256, 2048])
def test_context_constants_equal_their_formulas(bits):
    """Every entry of Cin, T1 and T1ext, at the CRT contexts of a 256-bit key
    and of the benchmark's 2048-bit key, and at the n^2-wide context of the
    256-bit key."""
    p, q = (P256, Q256) if bits == 256 else _primes("djn2048")
    ctxs = [_crt_ctx(p), _crt_ctx(q)]
    if bits == 256:
        ctxs.append(RNSContext.create((p * q) ** 2))
    for ctx in ctxs:
        assert ctx.Cin.shape == (ctx.Lin, ctx.K)
        _check_rows_and_tables(ctx, [(l, j) for l in range(ctx.Lin) for j in range(ctx.K)])


def test_context_constants_at_4096_bits_on_sampled_entries():
    """The 4096-bit key's p^2 context: Cin on 400 sampled (row, modulus)
    entries, its first and last rows among them, and T1 / T1ext whole."""
    ctx = _crt_ctx(P)
    assert (ctx.k, ctx.K, ctx.Lin) == (305, 611, 548)
    r = random.Random(548)
    cells = [(r.randrange(ctx.Lin), r.randrange(ctx.K)) for _ in range(400)]
    cells += [(l, j) for l in (0, 1, ctx.Lin - 1) for j in (0, ctx.k, ctx.K - 1)]
    _check_rows_and_tables(ctx, cells)


def _engine_256(dev):
    sk = PrivateKey(P256 * Q256, P256, Q256, device=dev)
    return PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                         backend="rns", device=dev)


@pytest.mark.parametrize("grouped", [False, True])
def test_crt_grouped_counter(one_thread, grouped):
    """Raised once a call on the grouped constants, never on the folded ones
    (a 256-bit key folds)."""
    eng = _engine_256("cpu")
    assert eng.crt_folded
    n = P256 * Q256
    rows = _uniform_units(n, 3, 256)
    calls = 3
    with trace.recording():
        outs = [eng._decrypt_crt_impl(rows, grouped=grouped).fetch() for _ in range(calls)]
    got = trace.drain()["counters"].get("pipelines.crt_grouped", 0)
    assert got == (calls if grouped else 0)
    want = [paillier.decrypt_crt_row(P256, Q256, c) for c in rows]
    assert all(o == want for o in outs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ragged_batch_on_two_streams_replays(dev):
    """2049 rows (a ragged last tile), three calls on each of two streams, so
    that each stream's third call replays its graph: every call equals the
    reference on 8 sampled rows, and each counts one grouped call."""
    sk = PrivateKey(N, P, Q, device=dev)
    eng = sk._engine
    assert not eng.crt_folded
    rows = _uniform_units(N, 2049, 2049)
    sample = sorted(random.Random(7).sample(range(len(rows)), 6)) + [0, len(rows) - 1]
    want = {i: paillier.decrypt_crt_row(P, Q, rows[i]) for i in sample}
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs = []
    with trace.recording():
        for _ in range(3):
            for s in streams:
                with torch.cuda.stream(s):
                    outs.append(eng.decrypt_crt_dev(rows).fetch())
    counters = trace.drain()["counters"]
    assert counters.get("pipelines.crt_grouped") == 6
    assert counters.get("pipelines.graph_replays") == 2
    for out in outs:
        assert len(out) == len(rows)
        assert {i: out[i] for i in sample} == want
