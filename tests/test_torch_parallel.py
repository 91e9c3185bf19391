"""The runtime context and the mesh split of the PyTorch/CUDA port on
``device="cpu"``, against the JAX package on its 8-device virtual CPU mesh
(tests/conftest.py).  Counterpart of tests/test_hybrid_context.py's context
tests and tests/test_parallel.py.  The JAX engines run their Pallas kernels
in interpret mode (backend ``rns_interpret``).  Tolerance: exact equality of
ciphertexts and plaintexts as Python ints."""

import math
import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.models import engine as jeng
from pailliercryptolib_tpu.parallel import context as jctx
from pailliercryptolib_tpu.parallel import mesh as jmesh
from pailliercryptolib_tpu.utils.rng import DeviceSeed as JaxDeviceSeed
from pailliercryptolib_tpu_torch.convert import keys_from_ints
from pailliercryptolib_tpu_torch.models import engine as teng
from pailliercryptolib_tpu_torch.models.engine import ShardedLimbs
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.ops import dispatch as tdispatch
from pailliercryptolib_tpu_torch.ops import limbs as tlb
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.parallel import context as tctx
from pailliercryptolib_tpu_torch.parallel import mesh as tmesh
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed


@pytest.fixture(autouse=True)
def _teardown():
    yield
    tctx.terminate_context()
    jctx.terminate_context()
    tdispatch.set_hybrid_off()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _prime34(rng, bits):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 3
        if miller_rabin(c):
            return c


@pytest.fixture(scope="module")
def ints():
    """(n, p, q, hs, randbits) of a 256-bit DJN key from a seed."""
    rng = random.Random(1107)
    while True:
        p, q = _prime34(rng, 128), _prime34(rng, 128)
        n = p * q
        if p != q and n.bit_length() == 256 and math.gcd(p - 1, q - 1) == 2:
            break
    r = rng.randrange(2, n)
    return n, min(p, q), max(p, q), pow((-(r * r)) % n, n, n * n), 128


def _parts(ct):
    return [(i, p.size) for i, p in enumerate(ct.device_payload().parts) if p is not None]


def test_context_idempotent_and_terminates():
    c1 = ptorch.initialize_context("CPU", device="cpu")
    c2 = ptorch.initialize_context("DEFAULT", device="cpu")  # keeps the first
    assert c2 is c1 and ptorch.get_context() is c1
    assert tctx.is_running()
    ptorch.terminate_context()
    assert not tctx.is_running() and tctx.peek_context() is None
    with pytest.raises(ValueError):
        ptorch.initialize_context("GPU", device="cpu")
    for name in ("get_context", "initialize_context", "terminate_context"):
        assert name in ptorch.__all__
        assert getattr(ptorch, name) is getattr(tctx, name)


def test_context_cpu_forces_plain_backend():
    ctx = ptorch.initialize_context("CPU", device="cpu")
    assert ctx.backend == "plain" and ctx.mesh == [torch.device("cpu")]
    k = ptorch.generate_keypair(256, enable_DJN=True, device="cpu")
    assert k.pub_key._engine.backend == "plain" == k.priv_key._engine.backend
    assert k.pub_key._engine.mesh is None  # one entry: no split
    ct = k.pub_key.encrypt(ptorch.PlainText([1, 2, 3]))
    assert k.priv_key.decrypt(ct).texts == [1, 2, 3]


def test_context_mesh_shards_public_api(rng):
    """An 8-entry mesh: the public API splits every batch; the reference's
    padding puts all 16 rows of a kernel-backend batch in entry 0."""
    ctx = ptorch.initialize_context(mesh_devices=8, device="cpu")
    assert len(ctx.mesh) == 8 and ctx.backend == "rns"
    k = ptorch.generate_keypair(256, enable_DJN=True, device="cpu")
    assert k.pub_key._engine.mesh is ctx.mesh is k.priv_key._engine.mesh
    vals = [rng.getrandbits(32) for _ in range(16)]
    ct = k.pub_key.encrypt(ptorch.PlainText(vals))
    assert isinstance(ct.device_payload(), ShardedLimbs)
    assert _parts(ct) == [(0, 16)]
    assert k.priv_key.decrypt(ct).texts == vals
    s = ct + ct
    assert k.priv_key.decrypt(s).texts == [2 * v for v in vals]
    m3 = ct * ptorch.PlainText([3])
    assert k.priv_key.decrypt(m3).texts == [3 * v for v in vals]
    # on "plain" the next power of two spreads the rows: 2 an entry; the
    # decrypt on "rns" keeps the payload's split
    k.pub_key._engine.backend = "plain"
    ct = k.pub_key.encrypt(ptorch.PlainText(vals), make_secure=False)
    assert _parts(ct) == [(i, 2) for i in range(8)]
    s = ct + ct
    assert s.device_payload().bounds == ct.device_payload().bounds
    dec = k.priv_key.decrypt(s)
    assert _parts(dec) == [(i, 2) for i in range(8)]
    assert dec.texts == [2 * v for v in vals]


def test_mesh_obfuscators_independent_across_shards():
    """One seed row an entry (engine._seed_rows): the same plaintext in
    every row gives pairwise-distinct ciphertexts, the rows of entry 1
    included (a replicated seed would repeat entry 0's first rows)."""
    ptorch.initialize_context(mesh_devices=2, device="cpu")
    vals = [7] * 130  # entry 0: rows 0-127, entry 1: rows 128-129
    for djn in (True, False):
        k = ptorch.generate_keypair(256, enable_DJN=djn, device="cpu")
        ct = k.pub_key.encrypt(ptorch.PlainText(vals))
        assert _parts(ct) == [(0, 128), (1, 2)]
        texts = ct.texts
        assert len(set(texts)) == len(texts)
        assert k.priv_key.decrypt(ct).texts == vals


def test_batch_bounds_follow_the_reference_padding():
    assert tmesh.batch_bounds(200, 2, "rns") == [(0, 128), (128, 200)]
    assert tmesh.batch_bounds(2100, 2, "cios") == [(0, 1152), (1152, 2100)]
    assert tmesh.batch_bounds(2048, 2, "rns") == [(0, 1024), (1024, 2048)]
    assert tmesh.batch_bounds(16, 8, "rns") == [(0, 16)] + [(16, 16)] * 7
    assert tmesh.batch_bounds(19, 8, "plain") == [(min(4 * i, 19), min(4 * i + 4, 19))
                                                  for i in range(8)]
    assert tmesh.batch_bounds(5, 3, "plain") == [(0, 3), (3, 5), (5, 5)]
    for B, S, backend in ((200, 2, "rns"), (16, 8, "rns"), (19, 8, "plain"),
                          (5, 3, "plain")):
        padded = len(jeng._pad_batch([0] * B, 0, "xla" if backend == "plain" else "rns",
                                     S))
        per = padded // S
        assert tmesh.batch_bounds(B, S, backend) == [
            (min(i * per, B), min((i + 1) * per, B)) for i in range(S)]


def test_make_mesh_shapes(monkeypatch):
    m1 = tmesh.make_mesh(8, device="cpu")
    j1 = jmesh.make_mesh(8)
    assert m1.axis_names == j1.axis_names == ("batch",) and len(m1) == 8
    m2 = tmesh.make_mesh(8, crt_axis=True, device="cpu")
    j2 = jmesh.make_mesh(8, crt_axis=True)
    assert m2.axis_names == j2.axis_names == ("crt", "batch")
    assert m2.shape == j2.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, crt_axis=True, device="cpu")
    # more entries than CUDA devices raise; a repeated device is listed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tmesh.make_mesh(device="cuda") == [torch.device("cuda", 0)]
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cuda")
    with pytest.raises(ValueError):
        tctx.initialize_context(mesh_devices=2)
    ctx = tctx.initialize_context(devices=["cuda:0", "cuda:0"])
    assert list(ctx.mesh) == [torch.device("cuda", 0)] * 2


def test_explicit_mesh_and_device_type(ints):
    n, p, q, hs, rb = ints
    tctx.initialize_context(mesh_devices=4, device="cpu")
    e = teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=["cpu", "cpu"])
    assert list(e.mesh) == [torch.device("cpu")] * 2  # explicit beats context
    assert teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=[]).mesh is None
    assert teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=["cpu"]).mesh is None
    with pytest.raises(ValueError):
        teng._resolve_mesh(tmesh.DeviceMesh([torch.device("cuda", 0)] * 2),
                           torch.device("cpu"))


def _seeded(monkeypatch, rows):
    """Both packages' engines take ``rows`` as their [S, 11] seed rows."""
    monkeypatch.setattr(jeng.PublicEngine, "_seed_rows",
                        lambda self, r: self._up_arr(rows))
    monkeypatch.setattr(teng.PublicEngine, "_seed_rows", lambda self, r: rows)


@pytest.mark.parametrize("S,B", [(2, 200), (8, 16)])
def test_seed_rows_equal_the_reference(ints, monkeypatch, S, B):
    """Same seed rows -> equal ciphertexts, bit for bit: the port cuts the
    batch where the reference's padded shards end (at 128 for B = 200 on two
    entries; all 16 rows in entry 0 of eight) and each entry expands its
    own row from counter 0."""
    n, p, q, hs, rb = ints
    rows = np.random.default_rng(S).integers(0, 1 << 32, (S, 11), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    _seeded(monkeypatch, rows)
    m = [random.Random(B).getrandbits(64) for _ in range(B)]
    je = jeng.PublicEngine(n, 256, hs, rb, backend="rns_interpret",
                           mesh=jmesh.make_mesh(S))
    want = je.encrypt_djn_dev(m, JaxDeviceSeed()).fetch()
    tkey = keys_from_ints(n, p, q, hs, rb, device="cpu")
    ptorch.initialize_context(mesh_devices=S, device="cpu")
    tpk, tsk = tkey.pub_key, tkey.priv_key
    assert tpk._engine.mesh is not None
    ct = tpk.encrypt(ptorch.PlainText(m))  # a fresh DeviceSeed a call
    got = ct.device_payload()
    assert got.bounds == tmesh.batch_bounds(B, S, "rns")
    assert got.fetch() == want
    # entry i alone, unsharded, with seed row i
    solo = teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=[])
    for i, (lo, hi) in enumerate(got.bounds):
        if hi > lo:
            assert solo.encrypt_djn_dev(m[lo:hi], DeviceSeed(rows[i])).fetch() == want[lo:hi]
    assert tsk.decrypt(ct).texts == m


def test_injected_r_and_chained_ops_equal_unsharded(ints):
    """Injected r: the sharded ciphertexts equal pow() and the unsharded
    engine's; CT+CT, CT*PT (per row and scalar) and apply_obfuscator stay
    split at the same rows and equal the unsharded results."""
    n, p, q, hs, rb = ints
    n2 = n * n
    rng = random.Random(5)
    B = 150
    vals = [rng.getrandbits(64) for _ in range(B)]
    rs = [rng.getrandbits(rb) for _ in range(2 * B)]
    ws = [rng.getrandbits(16) for _ in range(B)]
    ref = keys_from_ints(n, p, q, hs, rb, device="cpu")
    ref.pub_key._engine, ref.priv_key._engine  # made before the context
    ptorch.initialize_context(mesh_devices=2, device="cpu")
    key = keys_from_ints(n, p, q, hs, rb, device="cpu")
    assert ref.pub_key._engine.mesh is None and key.pub_key._engine.mesh is not None
    out = {}
    for name, k in (("ref", ref), ("mesh", key)):
        k.pub_key.set_random(rs)
        ct = k.pub_key.encrypt(ptorch.PlainText(vals))
        chain = k.pub_key.apply_obfuscator(ct * ptorch.PlainText(ws) + ct * ptorch.PlainText([3]))
        out[name] = (ct, chain, k.priv_key.decrypt(chain))
    ct, chain, dec = out["mesh"]
    assert [type(x.device_payload()) for x in (ct, chain, dec)] == [ShardedLimbs] * 3
    assert chain.device_payload().bounds == [(0, 128), (128, 150)]
    assert ct.texts == [(n * m + 1) * pow(hs, r, n2) % n2 for m, r in zip(vals, rs)]
    assert ct.texts == out["ref"][0].texts and chain.texts == out["ref"][1].texts
    assert dec.texts == [(v * (w + 3)) % n for v, w in zip(vals, ws)] == out["ref"][2].texts
    key.priv_key.enable_crt = False
    assert key.priv_key.decrypt(chain).texts == dec.texts
    # a split payload goes into an engine without the mesh: gathered
    assert ref.priv_key.decrypt(ct).texts == vals


def test_hybrid_split_and_twin_under_a_mesh(ints):
    n, p, q, hs, rb = ints
    ptorch.initialize_context(mesh_devices=2, device="cpu")
    key = keys_from_ints(n, p, q, hs, rb, device="cpu")
    eng = key.pub_key._engine
    assert eng.secondary.mesh is eng.mesh and eng.secondary.backend == "plain"
    ptorch.set_hybrid_ratio(0.5)
    vals = list(range(1, 141))
    ct = key.pub_key.encrypt(ptorch.PlainText(vals))
    assert _parts(ct) == [(0, 128), (1, 12)]
    assert key.priv_key.decrypt(ct).texts == vals


def test_per_device_constants_built_once(ints, monkeypatch):
    """A repeated device holds one copy of the per-key constants: K1's
    table is built once for a mesh of eight entries on the CPU."""
    n, p, q, hs, rb = ints
    calls = []
    orig = tpops.fb_table_stage
    monkeypatch.setattr(tpops, "fb_table_stage",
                        lambda *a: calls.append(1) or orig(*a))
    e = teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=["cpu"] * 8)
    vals = list(range(300))
    first = e.encrypt_djn_dev(vals, DeviceSeed())
    e.encrypt_djn_dev(vals, DeviceSeed())
    assert [i for i, x in enumerate(first.parts) if x is not None] == [0, 1, 2]
    assert len(calls) == 1 and e._replicas == {}


def test_sharded_encrypt_djn_matches_pow(ints, rng):
    """The stage-level split (parallel/mesh.sharded_encrypt_djn), the
    counterpart of the JAX package's shard_map'd stage, on both CIOS-pipeline
    backends against pow()."""
    n, p, q, hs, rb = ints
    n2 = n * n
    tpub = teng.PublicEngine(n, 256, hs, rb, device="cpu", mesh=[])
    B = 8
    m = [rng.getrandbits(31) for _ in range(B)]
    r = [rng.getrandbits(rb) for _ in range(B)]
    nw = teng._round_windows(tlb.num_windows(rb))
    m_l = tlb.ints_to_limbs(m, tpub.Ln).astype(np.int32)
    r_w = tlb.ints_to_windows(r, nw * 4).astype(np.int32)
    tm = tmesh.make_mesh(4, device="cpu")
    want = [(n * v + 1) * pow(hs, e, n2) % n2 for v, e in zip(m, r)]
    for backend in ("plain", "cios"):
        tenc = tmesh.sharded_encrypt_djn(tm, backend=backend)
        parts = tenc(tmesh.shard_batch(m_l, tm), tmesh.shard_batch(r_w, tm),
                     tpub.n_limbs, *tpub.n2_args, tpub.hs_limbs)
        assert all(x.shape[0] == 2 for x in parts)
        assert tlb.limbs_to_ints(tmesh.gather(parts).numpy()) == want


@pytest.mark.parametrize("crt_axis", [False, True])
def test_sharded_crt_decrypt_roundtrip(ints, rng, crt_axis):
    n, p, q, hs, rb = ints
    key = keys_from_ints(n, p, q, hs, rb, device="cpu")
    priv = key.priv_key._engine
    vals = [rng.getrandbits(31) for _ in range(8)]
    ct = key.pub_key.encrypt(ptorch.PlainText(vals)).texts
    tm = tmesh.make_mesh(8, crt_axis=crt_axis, device="cpu")
    dec = tmesh.sharded_decrypt_crt(tm, backend="plain")
    parts = dec(
        torch.from_numpy(tlb.ints_to_limbs(ct, 2 * priv.Lp2).astype(np.int32)),
        priv.sq_n, priv.sq_n0inv, priv.sq_r2, priv.sq_one,
        priv.exp_wins, priv.hensel, priv.hfun,
        priv.pq_n, priv.pq_n0inv, priv.pq_r2, priv.pinv_q, priv.p_limbs,
    )
    assert sum(x is not None for x in parts) == 8
    assert tlb.limbs_to_ints(tmesh.gather(parts).numpy()) == vals


def test_sharded_rns_modexp_matches_pow():
    """K5's wrapper split over a 2-entry mesh (its plain version on the
    CPU) against pow()."""
    from pailliercryptolib_tpu_torch.ops import rns
    from pailliercryptolib_tpu_torch.ops.cuda_rns2 import stack_group_consts2

    r2 = random.Random(123)
    N = r2.getrandbits(128) | (1 << 127) | 1
    c = rns.RNSContext.create(N)
    consts = stack_group_consts2([c], device="cpu")
    tm = tmesh.make_mesh(2, device="cpu")
    B = 40
    bases = [r2.randrange(N) for _ in range(B)]
    exps = [r2.getrandbits(16) for _ in range(B)]
    x = torch.from_numpy(tlb.ints_to_limbs(bases, c.Lin).astype(np.int32))[None]
    wins = torch.from_numpy(tlb.ints_to_windows(exps, 16).astype(np.int32))[None]
    fn = tmesh.sharded_rns_modexp(tm, consts)
    parts = fn(tmesh.shard_batch_middle(x, tm), tmesh.shard_batch_middle(wins, tm))
    out = tmesh.gather(parts, axis=1)
    got = tlb.limbs_to_ints(rns.rns_to_limbs(out[0], c.device_consts("cpu")).numpy())
    for g, b, e in zip(got, bases, exps):
        assert g % N == pow(b, e, N) and g <= 2 * N
    # one shared exponent
    fn = tmesh.sharded_rns_modexp(tm, consts, shared=True)
    out = tmesh.gather(fn(x, wins[:, 0]), axis=1)
    got = tlb.limbs_to_ints(rns.rns_to_limbs(out[0], c.device_consts("cpu")).numpy())
    assert [g % N for g in got] == [pow(b, exps[0], N) for b in bases]
