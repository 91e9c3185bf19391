"""CUDA graphs of the ``rns`` pipelines (ops/graphs.py) and the device-side
stores that capture needs.

On the CPU: ``sub_scalar``'s device fill against Python ints, the byte mask of
the normal-mode base, the graph keys, and the engines' three graph paths
running eagerly (counted as ``pipelines.graph_eager``).  On the card (marker
``cuda``, skipped without one; no JAX imported): the normal and DJN encrypt
with a DeviceSeed and the CRT decrypt, replayed, against the eager stages,
bit for bit, with their counters and launch counts:

    python -m pytest tests/test_torch_graphs.py -q --noconftest -o addopts="" -m cuda
"""

import random
import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.models.engine import PrivateEngine, PublicEngine
from pailliercryptolib_tpu_torch.models.keys import PrivateKey
from pailliercryptolib_tpu_torch.ops import bigint, graphs
from pailliercryptolib_tpu_torch.ops import paillier_ops as pops
from pailliercryptolib_tpu_torch.ops.limbs import (
    LIMB_BITS,
    ints_to_limbs,
    limbs_to_ints,
)
from pailliercryptolib_tpu_torch.utils import trace
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

#: Two 128-bit primes, both 3 mod 4: a 256-bit key
P = 0xC334629E968C80B9534AAD5888183613
Q = 0xFC75DEAE1C1D86C891FC7F590E851FFB
N = P * Q
OPS = ("normal", "djn", "decrypt")
GRAPH_COUNTERS = ("pipelines.graph_eager", "pipelines.graph_captures",
                  "pipelines.graph_replays")


def _engines(dev):
    """The three engines of the 256-bit key, their lazy constants built."""
    n2 = N * N
    hs = pow((-(0x1234567 ** 2)) % n2, N, n2)
    sk = PrivateKey(N, P, Q, device=dev)
    engs = {
        "normal": PublicEngine(N, N.bit_length(), None, 0, backend="rns", device=dev),
        "djn": PublicEngine(N, N.bit_length(), hs, 128, backend="rns", device=dev),
        "decrypt": PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                                 backend="rns", device=dev),
    }
    engs["normal"].rns, engs["djn"].fb_mask, engs["decrypt"].rns_crt
    return engs


def _plain(rows, salt):
    r = random.Random(1000 * rows + salt)
    return [r.getrandbits(64) for _ in range(rows)]


def _seed(salt):
    return DeviceSeed(np.arange(salt, salt + 11, dtype=np.uint32))


def _cipher(rows, salt):
    r = random.Random(7 * rows + salt)
    return [r.randrange(1, N * N) for _ in range(rows)]


def _submit(engs, op, rows, salt):
    if op == "normal":
        return engs[op].encrypt_normal_dev(_plain(rows, salt), _seed(salt))
    if op == "djn":
        return engs[op].encrypt_djn_dev(_plain(rows, salt), _seed(salt))
    return engs[op].decrypt_crt_dev(_cipher(rows, salt))


def _counts(rec):
    return {k: rec["counters"].get(k, 0) for k in GRAPH_COUNTERS}


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.drain()
    yield
    trace.drain()


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def _borrow_cases(L, c):
    """Values from c to the top of L limbs: c, c + 1, the top, 2^(15 j) and
    2^(15 j) + c - 1 (from which c borrows through every limb below j), and
    random ones."""
    top = (1 << (LIMB_BITS * L)) - 1
    xs = [c, c + 1, top, top >> 1]
    for j in range(1, L):
        xs += [1 << (LIMB_BITS * j), (1 << (LIMB_BITS * j)) + c - 1]
    r = random.Random(L * 65537 + c)
    xs += [r.randrange(c, top + 1) for _ in range(8)]
    return [x for x in xs if c <= x <= top]


@pytest.mark.parametrize("L", [1, 2, 9, 69])
@pytest.mark.parametrize("c", [0, 1, 2, 12345, (1 << LIMB_BITS) - 1])
def test_sub_scalar_equals_int_subtraction(L, c):
    xs = _borrow_cases(L, c)
    x = torch.from_numpy(np.asarray(ints_to_limbs(xs, L)).astype(np.int32))
    got = limbs_to_ints(bigint.sub_scalar(x, c).numpy())
    assert got == [v - c for v in xs]


@pytest.mark.parametrize("ebits", [8, 20, 515, 4099, 4104])
def test_normal_base_byte_mask(ebits):
    """The normal-mode base is the keystream's ceil(ebits / 8) bytes a row
    with the bits above ``ebits`` cleared."""
    B = 3
    L = -(-ebits // LIMB_BITS)
    seed = torch.arange(11, dtype=torch.int64)[None] * 0x01010101
    nbytes = -(-ebits // 8)
    by = pops._chacha_bytes(seed, B, nbytes).numpy()
    want = [int.from_bytes(row.tobytes(), "little") & ((1 << ebits) - 1) for row in by]
    got = limbs_to_ints(pops._device_normal_base(seed, B, ebits, L).numpy())
    assert got == want
    assert max(v.bit_length() for v in got) <= ebits


def _key_of(op="encrypt_normal", rows=4, width=8, stream=7, dtype=torch.int32):
    seed = torch.zeros((1, 11), dtype=torch.int64)
    return graphs.graph_key(op, (seed, torch.zeros((rows, width), dtype=dtype)), stream)


@pytest.mark.parametrize("change", [
    {"stream": 8}, {"rows": 5}, {"width": 16}, {"dtype": torch.int64},
    {"op": "encrypt_djn"},
])
def test_graph_key_changes_with_stream_rows_and_width(change):
    assert _key_of() == _key_of()
    assert _key_of(**change) != _key_of()


@pytest.fixture(scope="module")
def cpu_engines():
    torch.set_num_threads(1)
    return _engines("cpu")


@pytest.mark.parametrize("op", OPS)
def test_cpu_calls_stay_eager(cpu_engines, op):
    outs = []
    with trace.recording():
        for _ in range(3):
            outs.append(_submit(cpu_engines, op, 3, 0).fetch())
    rec = trace.drain()
    assert _counts(rec) == {"pipelines.graph_eager": 3, "pipelines.graph_captures": 0,
                            "pipelines.graph_replays": 0}
    assert not any(s.name == "pipelines.graph_replay" for s in rec["spans"])
    assert outs[0] == outs[1] == outs[2]
    assert not cpu_engines[op]._graphs._graphs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU form")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card(dev):
    """Engines whose calls replay, and engines whose calls stay eager (the
    eager stages, for comparison)."""
    engs, eager = _engines(dev), _engines(dev)
    for e in eager.values():
        e._graphs.run = lambda op, fn, *inputs: fn(*inputs)
    return engs, eager


def _launches():
    return [dict(d) for d in graphs._counters()]


def _launch_delta(before):
    return [{k: v - was[k] for k, v in d.items() if v != was[k]}
            for d, was in zip(graphs._counters(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 300])
@pytest.mark.parametrize("op", OPS)
def test_replay_equals_eager(card, op, rows):
    """A stream's first call is eager, its second captured, later ones replay:
    each equals the eager stages on its own inputs, distinct seeds give
    distinct ciphertexts, and a replay counts the eager launches."""
    engs, eager = card
    s = torch.cuda.Stream()
    got, want, steps = [], [], []
    with torch.cuda.stream(s):
        for salt in range(5):
            before = _launches()
            with trace.recording():
                out = _submit(engs, op, rows, salt).fetch()
            steps.append((_counts(trace.drain()), _launch_delta(before)))
            got.append(out)
            before = _launches()
            want.append(_submit(eager, op, rows, salt).fetch())
            eager_launches = _launch_delta(before)
    assert got == want
    if op != "decrypt":
        assert len({tuple(g) for g in got}) == len(got)
    else:
        assert all(len(g) == rows for g in got)
    ways = [[k for k, v in c.items() if v] for c, _ in steps]
    assert ways == [["pipelines.graph_eager"], ["pipelines.graph_captures"]] + [
        ["pipelines.graph_replays"]] * 3
    assert all(c[k] == 1 for (c, _), (k,) in zip(steps, ways))
    for _, launched in steps:
        assert launched == eager_launches
    assert eager_launches[0]  # the kernels' wrappers counted something


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_two_streams_with_calls_outstanding(card, op):
    """Two streams, each warmed to replay; then stream 1 gets two calls
    before its first is fetched and stream 2 one in between: every answer is
    its own inputs' eager answer."""
    engs, eager = card
    rows = 64
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        with torch.cuda.stream(s):
            for salt in range(3):
                _submit(engs, op, rows, 100 + salt).fetch()
    plan = [(0, 200), (1, 201), (0, 202), (1, 203)]
    with trace.recording():
        pending = []
        for k, salt in plan:
            with torch.cuda.stream(streams[k]):
                pending.append((k, salt, _submit(engs, op, rows, salt)))
        got = {}
        for k, salt, h in pending:
            with torch.cuda.stream(streams[k]):
                got[salt] = h.fetch()
    assert _counts(trace.drain())["pipelines.graph_replays"] == len(plan)
    for _, salt in plan:
        assert got[salt] == _submit(eager, op, rows, salt).fetch()


@pytest.mark.cuda
def test_threads_on_streams_of_their_own(card):
    """More threads than cores, each on its own stream through one engine's
    cache (so graphs are also evicted and captured again): every answer is the
    eager one."""
    engs, eager = card
    threads, calls, rows = 12, 4, 16
    want = {salt: _submit(eager, "normal", rows, salt).fetch()
            for salt in range(threads * calls)}
    got, errors = {}, []

    def work(t):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for j in range(calls):
                    salt = t * calls + j
                    got[salt] = _submit(engs, "normal", rows, salt).fetch()
        except Exception as e:  # reported below, with the thread's number
            errors.append((t, repr(e)))

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert got == want
    assert len(engs["normal"]._graphs._graphs) <= graphs.MAX_GRAPHS


@pytest.mark.cuda
def test_new_table_drops_the_graphs(dev):
    """set_hs gives the DJN engine a new table: the graphs that read the old
    one are dropped, and the answers follow the new hs."""
    n2 = N * N
    engs = _engines(dev)
    eng = engs["djn"]
    with torch.cuda.stream(torch.cuda.Stream()):
        for salt in range(3):
            _submit(engs, "djn", 8, salt).fetch()
        assert eng._graphs._graphs
        eng.set_hs(pow((-(0x7654321 ** 2)) % n2, N, n2), 128)
        assert not eng._graphs._graphs
        got = [_submit(engs, "djn", 8, salt).fetch() for salt in range(3)]
    fresh = _engines(dev)["djn"]
    fresh.set_hs(eng.hs_int, 128)
    fresh._graphs.run = lambda op, fn, *inputs: fn(*inputs)
    assert got == [fresh.encrypt_djn_dev(_plain(8, salt), _seed(salt)).fetch()
                   for salt in range(3)]

