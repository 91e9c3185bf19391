"""The CIOS backend of the PyTorch/CUDA port — the plain versions of the
windowed modexp (K6), the raw Montgomery product (K7) and the modular product
(K4), the CIOS pipelines, the backend dispatch, the ``modexp`` API and the
hybrid batch split — against the JAX package on the same seeded inputs.

The port's functions get CPU tensors, where the kernel wrappers take their
plain versions; the JAX functions run their Pallas kernels in interpret mode
(backend ``pallas_interpret``) or their XLA path.  Moduli of 128 and 256
bits.  Tolerance: none, integer arithmetic — every comparison is exact."""

import math
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.ops import bigint as jbig
from pailliercryptolib_tpu.ops import dispatch as jdisp
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops import paillier_ops as jpops
from pailliercryptolib_tpu.ops.pallas_modexp import (
    BATCH_TILE,
    pallas_mod_mul,
    pallas_modexp,
    pallas_mont_raw,
)
from pailliercryptolib_tpu_torch.convert import keys_from_ints, mont_consts_from_jax
from pailliercryptolib_tpu_torch.models import engine as tengine
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.ops import bigint as tbig
from pailliercryptolib_tpu_torch.ops import cuda_modexp
from pailliercryptolib_tpu_torch.ops import dispatch as tdisp
from pailliercryptolib_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.utils import config as tconfig
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

B = BATCH_TILE  # 128: one Pallas batch tile
BITS = 256


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return tuple(got.shape) == want.shape and np.array_equal(
        got.numpy().astype(np.int64), want.astype(np.int64)
    )


def _ints(t):
    return lb.limbs_to_ints(np.asarray(t).astype(np.uint32))


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op thread pool only costs,
    and under parallel test workers it oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    tdisp.set_hybrid_off()
    jdisp.set_hybrid_off()
    tconfig.set_config(tconfig.Config())


def _group(rng, bits, G):
    """G odd moduli with the JAX package's constants stacked as numpy arrays
    (n, n0inv, r2, one) and the port's tensors made from them."""
    ns = [_odd(rng, bits) for _ in range(G)]
    cs = [jmg.MontConstants.create(n) for n in ns]
    jc = (
        np.stack([c.n_limbs for c in cs]),
        np.array([c.n0inv for c in cs], np.uint32),
        np.stack([c.r2_limbs for c in cs]),
        np.stack([c.one_limbs for c in cs]),
    )
    return ns, cs[0].num_limbs, jc, mont_consts_from_jax(*jc)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the Pallas kernels and pow()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2])
def test_modexp_plain_equals_pallas_and_pow(G):
    rng = random.Random(11 + G)
    ns, L, jc, tc = _group(rng, 128, G)
    ebits = 64
    bases = [[rng.randrange(n) for _ in range(B)] for n in ns]
    exps = [[rng.getrandbits(ebits) for _ in range(B - 2)] + [0, 1] for _ in ns]
    base = np.stack([lb.ints_to_limbs(b, L) for b in bases])
    wins = np.stack([lb.ints_to_windows(e, ebits) for e in exps])
    want = pallas_modexp(_j(base), _j(wins), *(_j(c) for c in jc), interpret=True)
    n, n0, r2, one = tc
    assert n0.shape == (G,) and n0.dtype == torch.int32
    got = cuda_modexp.modexp(_t(base), _t(wins), n, n0, r2, one)
    assert got.dtype == torch.int32 and _eq(got, want)
    assert torch.equal(got, cuda_modexp.modexp_plain(_t(base), _t(wins), n, n0, r2, one))
    for g, m in enumerate(ns):
        assert _ints(got[g]) == [pow(b, e, m) for b, e in zip(bases[g], exps[g])]
    # one exponent for the group's rows, one base for the group's rows
    shared_w = cuda_modexp.modexp(_t(base), _t(wins[:, :1]), n, n0, r2, one)
    for g, m in enumerate(ns):
        assert _ints(shared_w[g]) == [pow(b, exps[g][0], m) for b in bases[g]]
    shared_b = cuda_modexp.modexp(_t(base[:, :1]), _t(wins), n, n0, r2, one)
    for g, m in enumerate(ns):
        assert _ints(shared_b[g]) == [pow(bases[g][0], e, m) for e in exps[g]]


@pytest.mark.parametrize("shared_b", [False, True])
def test_mont_raw_plain_equals_pallas(shared_b):
    """Digit for digit the Pallas kernel's redundant output; as a value
    a*b*R^-1 mod n below 2n."""
    rng = random.Random(17)
    ns, L, jc, tc = _group(rng, 128, 2)
    a_i = [[rng.randrange(n) for _ in range(B)] for n in ns]
    b_i = [[rng.randrange(n) for _ in range(1 if shared_b else B)] for n in ns]
    a = np.stack([lb.ints_to_limbs(x, L) for x in a_i])
    b = np.stack([lb.ints_to_limbs(x, L) for x in b_i])
    want = pallas_mont_raw(
        _j(a), jnp.broadcast_to(_j(b), a.shape), _j(jc[0]), _j(jc[1]), interpret=True
    )
    got = cuda_modexp.mont_raw(_t(a), _t(b), tc[0], tc[1])
    assert _eq(got, want)
    assert torch.equal(got, cuda_modexp.mont_raw_plain(_t(a), _t(b), tc[0], tc[1]))
    assert int(got.max()) <= 1 << 15
    R = 1 << (lb.LIMB_BITS * L)
    for g, m in enumerate(ns):
        rinv = pow(R, -1, m)
        vals = _ints(tmg.canonicalize(got[g]))
        for i, v in enumerate(vals):
            y = b_i[g][0 if shared_b else i]
            assert v < 2 * m and v % m == a_i[g][i] * y * rinv % m


@pytest.mark.parametrize("shared_b", [False, True])
def test_mod_mul_plain_equals_pallas_and_ints(shared_b):
    rng = random.Random(19)
    ns, L, jc, tc = _group(rng, 128, 2)
    a_i = [[rng.randrange(n) for _ in range(B)] for n in ns]
    b_i = [[rng.randrange(n) for _ in range(1 if shared_b else B)] for n in ns]
    a = np.stack([lb.ints_to_limbs(x, L) for x in a_i])
    b = np.stack([lb.ints_to_limbs(x, L) for x in b_i])
    want = pallas_mod_mul(
        _j(a), jnp.broadcast_to(_j(b), a.shape), _j(jc[0]), _j(jc[1]), _j(jc[2]),
        interpret=True,
    )
    got = cuda_modexp.mod_mul(_t(a), _t(b), tc[0], tc[1], tc[2])
    assert _eq(got, want)
    for g, m in enumerate(ns):
        assert _ints(got[g]) == [
            x * b_i[g][0 if shared_b else i] % m for i, x in enumerate(a_i[g])
        ]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = random.Random(23)
    _, L, _, (n, n0, r2, one) = _group(rng, 128, 1)
    a = torch.zeros((1, 3, L), dtype=torch.int32)
    w = torch.zeros((1, 3, 8), dtype=torch.int32)
    assert cuda_modexp.KERNEL_MAX_L == 547  # n^2 of a 4096-bit key
    assert set(cuda_modexp.LAUNCHES) == {"mod_mul", "modexp", "mont_raw"}
    with pytest.raises(TypeError):
        cuda_modexp.mont_raw(a.to(torch.int64), a, n, n0)
    with pytest.raises(TypeError):
        cuda_modexp.mod_mul(a, a.to(torch.int64), n, n0, r2)
    with pytest.raises(ValueError):
        cuda_modexp.mont_raw(a, a, n[:, :-1], n0)
    with pytest.raises(ValueError):
        cuda_modexp.modexp(a, w, n, n0, r2[:, :-1], one)
    with pytest.raises(ValueError):
        cuda_modexp.modexp(a[0], w, n, n0, r2, one)
    # CPU tensors never count as launches
    before = dict(cuda_modexp.LAUNCHES)
    cuda_modexp.modexp(a, w, n, n0, r2, one)
    cuda_modexp.mont_raw(a, a, n, n0)
    cuda_modexp.mod_mul(a, a, n, n0, r2)
    assert cuda_modexp.LAUNCHES == before


# ---------------------------------------------------------------------------
# plain functions against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["rows", "shared_base", "shared_exponent"])
def test_mont_exp_equals_jax(form):
    rng = random.Random(29)
    m = _odd(rng, 128)
    c = jmg.MontConstants.create(m)
    L, rows, ebits = c.num_limbs, 6, 32
    bases = [rng.randrange(m) for _ in range(1 if form == "shared_base" else rows)]
    exps = [rng.getrandbits(ebits) for _ in range(1 if form == "shared_exponent" else rows)]
    base = lb.ints_to_limbs(bases, L)
    if form == "shared_base":
        base = base[0]
    wins = lb.ints_to_windows(exps, ebits)
    jn, jn0, jr2, jone = c.as_device_args()
    want = jmg.mont_exp(_j(base), _j(wins), jn, jn0, jr2, jone)
    got = tmg.mont_exp(_t(base), _t(wins), _t(c.n_limbs), int(c.n0inv),
                       _t(c.r2_limbs), _t(c.one_limbs))
    assert _eq(got, want)
    full_b = bases * rows if form == "shared_base" else bases
    full_e = exps * rows if form == "shared_exponent" else exps
    assert _ints(got) == [pow(b, e, m) for b, e in zip(full_b, full_e)]


def test_mod_fold_and_combine_equal_jax():
    rng = random.Random(31)
    m = _odd(rng, 128)
    c = jmg.MontConstants.create(m)
    L = c.num_limbs
    xs = [rng.getrandbits(2 * 15 * L - 8) for _ in range(7)] + [0, m, m * m - 1]
    x = lb.ints_to_limbs(xs, 2 * L)
    jn, jn0, jr2, _ = c.as_device_args()
    want = jbig.mod_fold(_j(x), jn, jn0, jr2)
    got = tbig.mod_fold(_t(x), _t(c.n_limbs), int(c.n0inv), _t(c.r2_limbs))
    assert _eq(got, want)
    R = 1 << (15 * L)
    assert all(v < R and v % m == w % m for v, w in zip(_ints(got), xs))
    folded = jmg.mont_mul(_j(x[:, L:]), jr2, jn, jn0)
    want_c = jbig.mod_fold_combine(folded, _j(x[:, :L]), jn)
    got_c = tbig.mod_fold_combine(_t(np.asarray(folded)), _t(x[:, :L]), _t(c.n_limbs))
    assert _eq(got_c, want_c) and _eq(got_c, want)
    # grouped: n as [G, 1, L] against [G, B, L] operands
    g2 = tbig.mod_fold_combine(
        _t(np.asarray(folded))[None].expand(2, -1, -1), _t(x[:, :L])[None],
        _t(c.n_limbs)[None, None].expand(2, 1, -1),
    )
    assert torch.equal(g2[0], got_c) and torch.equal(g2[1], got_c)


def test_add_scalar_add_carry_equal_jax():
    rng = random.Random(37)
    L = 9
    top = (1 << (15 * L)) - 1
    xs = [rng.getrandbits(15 * L - 1) for _ in range(5)] + [0, top - 40000, (1 << 60) - 1]
    ys = [rng.getrandbits(15 * L - 1) for _ in range(len(xs) - 1)] + [1]
    x, y = lb.ints_to_limbs(xs, L), lb.ints_to_limbs(ys, L)
    for cst in (0, 1, 32767):
        got = tbig.add_scalar(_t(x), cst)
        assert _eq(got, jbig.add_scalar(_j(x), cst))
        assert _ints(got) == [v + cst for v in xs]
    got = tbig.add_carry(_t(x[:5]), _t(y[:5]))
    assert _eq(got, jbig.add_carry(_j(x[:5]), _j(y[:5])))
    assert _ints(got) == [a + b for a, b in zip(xs[:5], ys[:5])]


def test_mont_consts_from_jax():
    c = jmg.MontConstants.create(_odd(random.Random(41), 256))
    n, n0, r2, one = (np.asarray(v) for v in c.as_device_args())
    tn, tn0, tr2, tone = mont_consts_from_jax(n, n0, r2, one)
    assert tn0.shape == (1,) and int(tn0[0]) == c.n0inv
    for t, a in ((tn, n), (tr2, r2), (tone, one)):
        assert t.dtype == torch.int32 and _eq(t, a)
    tc = tmg.MontConstants.create(c.modulus).as_device_args("cpu")
    assert torch.equal(tc[0], tn) and tc[1] == c.n0inv and torch.equal(tc[3], tone)


# ---------------------------------------------------------------------------
# the CIOS pipelines against the JAX *_op on pallas_interpret
# ---------------------------------------------------------------------------


def _prime34(rng, bits):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 3
        if miller_rabin(c):
            return c


def _key_ints(bits, seed):
    rng = random.Random(seed)
    while True:
        p, q = _prime34(rng, bits // 2), _prime34(rng, bits // 2)
        n = p * q
        if p != q and n.bit_length() == bits and math.gcd(p - 1, q - 1) == 2:
            break
    r = rng.randrange(2, n)
    hs = pow((-(r * r)) % n, n, n * n)
    return n, p, q, hs, bits // 2


@pytest.fixture(scope="module")
def env():
    """One 256-bit DJN key in both packages and a batch of seeded operands.
    The JAX engines only lend their constants here."""
    n, p, q, hs, randbits = _key_ints(BITS, seed=4242)
    jpk = ptpu.PublicKey(n, BITS, hs=hs, randbits=randbits)
    jsk = ptpu.PrivateKey(jpk, p, q)
    tkey = keys_from_ints(n, p, q, hs, randbits, device="cpu")
    rng = random.Random(4243)
    n2 = n * n
    e = dict(n=n, n2=n2, p=min(p, q), q=max(p, q), hs=hs, randbits=randbits,
             jpub=jpk._engine, jprv=jsk._engine, tpub=tkey.pub_key._engine,
             tprv=tkey.priv_key._engine, rng=rng)
    e["m"] = [rng.randrange(n) for _ in range(B - 2)] + [0, n - 1]
    e["r"] = [rng.getrandbits(randbits) for _ in range(B - 2)] + [0, (1 << randbits) - 1]
    e["rbase"] = [rng.randrange(1, n) for _ in range(B)]
    e["ct"] = [rng.randrange(n2) for _ in range(B)]
    e["ct2"] = [rng.randrange(n2) for _ in range(B)]
    e["pt"] = [rng.getrandbits(64) for _ in range(B - 2)] + [0, 1]
    return e


def _jn2(e):
    return e["jpub"].n2_args


def _tn2(e):
    return mont_consts_from_jax(*(np.asarray(v) for v in _jn2(e)))


def _run_op(name, e):
    """(JAX result on pallas_interpret, port's result on cios, expected ints
    or None)."""
    jpub, jprv, tpub, tprv = e["jpub"], e["jprv"], e["tpub"], e["tprv"]
    n, n2, L2, Ln = e["n"], e["n2"], jpub.L2, jpub.Ln
    jn2, tn2 = _jn2(e), _tn2(e)
    jb, tb = dict(backend="pallas_interpret"), dict(backend="cios")
    m = lb.ints_to_limbs(e["m"], Ln)
    ct = lb.ints_to_limbs(e["ct"], L2)
    r_w = lb.ints_to_windows(e["r"], e["randbits"])
    if name == "encrypt_djn":
        want = [(n * x + 1) * pow(e["hs"], r, n2) % n2 for x, r in zip(e["m"], e["r"])]
        return (
            jpops.encrypt_djn_op(_j(m), _j(r_w), jpub.n_limbs, *jn2, jpub.hs_limbs, **jb),
            tpops.encrypt_djn_op(_t(m), _t(r_w), tpub.n_limbs, *tn2, tpub.hs_limbs, **tb),
            want,
        )
    if name == "encrypt_normal":
        rb = lb.ints_to_limbs(e["rbase"], L2)
        want = [(n * x + 1) * pow(r, n, n2) % n2 for x, r in zip(e["m"], e["rbase"])]
        return (
            jpops.encrypt_normal_op(_j(m), _j(rb), jpub.n_wins, jpub.n_limbs, *jn2, **jb),
            tpops.encrypt_normal_op(_t(m), _t(rb), tpub.n_wins, tpub.n_limbs, *tn2, **tb),
            want,
        )
    if name == "obfuscate":
        want = [c * pow(e["hs"], r, n2) % n2 for c, r in zip(e["ct"], e["r"])]
        return (
            jpops.obfuscate_op(_j(ct), jpub.hs_limbs, _j(r_w), *jn2, **jb),
            tpops.obfuscate_op(_t(ct), tpub.hs_limbs, _t(r_w), *tn2, **tb),
            want,
        )
    if name == "add_ctct":
        ct2 = lb.ints_to_limbs(e["ct2"], L2)
        want = [a * b % n2 for a, b in zip(e["ct"], e["ct2"])]
        return (
            jpops.add_ctct_op(_j(ct), _j(ct2), *jn2[:3], **jb),
            tpops.add_ctct_op(_t(ct), _t(ct2), *tn2[:3], **tb),
            want,
        )
    if name == "mul_ctpt":
        pt_w = lb.ints_to_windows(e["pt"], 64)
        want = [pow(c, x, n2) for c, x in zip(e["ct"], e["pt"])]
        return (
            jpops.mul_ctpt_op(_j(ct), _j(pt_w), *jn2, **jb),
            tpops.mul_ctpt_op(_t(ct), _t(pt_w), *tn2, **tb),
            want,
        )
    if name == "decrypt_crt":
        ctw = lb.ints_to_limbs(e["ct"], 2 * jprv.Lp2)
        return (
            jpops.decrypt_crt_op(
                _j(ctw), jprv.sq_n, jprv.sq_n0inv, jprv.sq_r2, jprv.sq_one,
                jprv.exp_wins, jprv.hensel, jprv.hfun, jprv.pq_n, jprv.pq_n0inv,
                jprv.pq_r2, jprv.pinv_q, jprv.p_limbs, **jb),
            tpops.decrypt_crt_op(
                _t(ctw), tprv.sq_n, tprv.sq_n0inv, tprv.sq_r2, tprv.sq_one,
                tprv.exp_wins, tprv.hensel, tprv.hfun, tprv.pq_n, tprv.pq_n0inv,
                tprv.pq_r2, tprv.pinv_q, tprv.p_limbs, **tb),
            None,
        )
    assert name == "decrypt_raw"
    jn_n, jn_n0, jn_r2, _ = jprv.mont_n.as_device_args()
    return (
        jpops.decrypt_raw_op(
            _j(ct), jprv.lam_wins, *jprv.mont_n2.as_device_args(), jprv.hensel_n,
            jprv.x_limbs, jn_n, jn_n0, jn_r2, **jb),
        tpops.decrypt_raw_op(
            _t(ct), tprv.lam_wins, *tn2, tprv.hensel_n, tprv.x_limbs, tprv.n_n,
            tprv.mont_n.n0inv, tprv.n_r2, **tb),
        None,
    )


@pytest.mark.parametrize("name", [
    "encrypt_djn", "encrypt_normal", "obfuscate", "decrypt_crt", "decrypt_raw",
    "add_ctct", "mul_ctpt",
])
def test_cios_pipeline_equals_jax_op(env, name):
    want, got, ints = _run_op(name, env)
    assert _eq(got, want)
    if ints is not None:
        assert _ints(got) == ints


def test_engine_constants_equal_jax(env):
    """The constants the port's engines added for the CIOS pipelines."""
    jpub, jprv, tpub, tprv = env["jpub"], env["jprv"], env["tpub"], env["tprv"]
    assert _eq(tpub.hs_limbs, jpub.hs_limbs)
    for t, j in zip(tpub.n2_args, jpub.n2_args):
        assert t == j if isinstance(t, int) else _eq(t, j)
    for name in ("sq_n", "sq_n0inv", "sq_r2", "sq_one"):
        assert _eq(getattr(tprv, name), getattr(jprv, name)), name
    for t, j in zip(tprv.n2_args, jprv.mont_n2.as_device_args()):
        assert t == j if isinstance(t, int) else _eq(t, j)


def test_routers_take_plain_and_refuse_other_backends(env):
    tpub = env["tpub"]
    n2 = env["n2"]
    tn2 = _tn2(env)
    ct = _t(lb.ints_to_limbs(env["ct"][:3], tpub.L2))
    w = _t(lb.ints_to_windows([5], 32))
    for backend in ("cios", "plain"):
        got = tdisp.modexp_backend(ct, w, *tn2, backend)
        assert _ints(got) == [pow(c, 5, n2) for c in env["ct"][:3]]
        got = tdisp.mod_mul_backend(ct, ct[0], *tn2[:3], backend)
        assert _ints(got) == [c * env["ct"][0] % n2 for c in env["ct"][:3]]
    for backend in ("rns", "pallas", "xla"):
        with pytest.raises(ValueError):
            tdisp.modexp_backend(ct, w, *tn2, backend)
        with pytest.raises(ValueError):
            tdisp.mont_raw_backend_grouped(ct[None], ct[None], tn2[0][None], tn2[1], backend)


# ---------------------------------------------------------------------------
# engines: "cios" against "pallas_interpret", "plain" against "xla"
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[("cios", "pallas_interpret"), ("plain", "xla")],
                ids=["cios", "plain"])
def pair(request):
    tback, jback = request.param
    n, p, q, hs, randbits = _key_ints(BITS, seed=777)
    jpk = ptpu.PublicKey(n, BITS, hs=hs, randbits=randbits)
    jsk = ptpu.PrivateKey(jpk, p, q)
    for e in (jpk._engine, jsk._engine):
        e.backend = jback
    tconfig.set_config(tconfig.Config(backend=tback))
    try:
        tkey = keys_from_ints(n, p, q, hs, randbits, device="cpu")
        tpk, tsk = tkey.pub_key, tkey.priv_key
        assert tpk._engine.backend == tback and tsk._engine.backend == tback
    finally:
        tconfig.set_config(tconfig.Config())
    rng = random.Random(778)
    vals = [rng.getrandbits(64) for _ in range(4)] + [0, n - 1]
    rs = [rng.getrandbits(randbits) for _ in range(4)] + [0, (1 << randbits) - 1]
    jpk.set_random(rs)
    tpk.set_random(rs)
    jct = jpk.encrypt(ptpu.PlainText(vals))
    tct = tpk.encrypt(ptorch.PlainText(vals))
    return dict(n=n, hs=hs, randbits=randbits, jpk=jpk, jsk=jsk, tpk=tpk, tsk=tsk,
                rng=rng, vals=vals, rs=rs, jct=jct, tct=tct, tback=tback)


def test_engine_injected_r_equal_ciphertexts(pair):
    k = pair
    n, n2 = k["n"], k["n"] ** 2
    want = [(n * m + 1) * pow(k["hs"], r, n2) % n2 for m, r in zip(k["vals"], k["rs"])]
    assert k["tct"].texts == want
    assert k["tct"].texts == k["jct"].texts
    assert k["tct"].device_payload().arr.dtype == torch.int32


def test_engine_cross_decrypt(pair):
    k = pair
    want = [v % k["n"] for v in k["vals"]]
    assert k["tsk"].decrypt(ptorch.CipherText(k["tpk"], k["jct"].texts)).texts == want
    assert k["jsk"].decrypt(ptpu.CipherText(k["jpk"], k["tct"].texts)).texts == want
    assert k["tsk"].decrypt(k["tct"]).texts == want  # device-resident payload
    k["tsk"].enable_crt = False
    try:
        assert k["tsk"].decrypt(k["tct"]).texts == want  # RAW
    finally:
        k["tsk"].enable_crt = True


def test_engine_homomorphic_ops_equal(pair):
    k = pair
    n = k["n"]
    e = [k["rng"].getrandbits(64) for _ in range(len(k["vals"]))]
    jsum, tsum = k["jct"] + k["jct"], k["tct"] + k["tct"]
    assert tsum.texts == jsum.texts
    jmul, tmul = jsum * ptpu.PlainText(e), tsum * ptorch.PlainText(e)
    assert tmul.texts == jmul.texts
    jsc, tsc = jmul * ptpu.PlainText([3]), tmul * ptorch.PlainText([3])
    assert tsc.texts == jsc.texts
    rs = [k["rng"].getrandbits(k["randbits"]) for _ in e]
    k["jpk"].set_random(rs)
    k["tpk"].set_random(rs)
    job, tob = k["jpk"].apply_obfuscator(jsc), k["tpk"].apply_obfuscator(tsc)
    assert tob.texts == job.texts and tob.texts != tsc.texts
    assert k["tsk"].decrypt(tob).texts == [2 * v * x * 3 % n for v, x in zip(k["vals"], e)]


def test_engine_fresh_randoms_and_normal_mode(pair):
    """A DeviceSeed becomes a host draw on these backends; a non-DJN key
    draws its bases on the host."""
    k = pair
    vals = [1, 2, 3]
    drawn = k["tpk"]._engine._seed_fallback(DeviceSeed(), 3, "encrypt")
    assert isinstance(drawn, np.ndarray) and drawn.shape == (3, -(-k["randbits"] // 8))
    a, b = k["tpk"].encrypt(ptorch.PlainText(vals)), k["tpk"].encrypt(ptorch.PlainText(vals))
    assert a.texts != b.texts and k["tsk"].decrypt(a).texts == vals
    assert k["jsk"].decrypt(ptpu.CipherText(k["jpk"], b.texts)).texts == vals
    tconfig.set_config(tconfig.Config(backend=k["tback"]))
    normal = ptorch.PublicKey(k["n"], BITS, device="cpu")
    assert normal._engine.backend == k["tback"]
    ct = normal.encrypt(ptorch.PlainText(vals))
    assert k["tsk"].decrypt(normal.apply_obfuscator(ct)).texts == vals
    rs = [k["rng"].randrange(1, k["n"]) for _ in vals]
    normal.set_random(rs)
    n, n2 = k["n"], k["n"] ** 2
    assert normal.encrypt(ptorch.PlainText(vals)).texts == [
        (n * m + 1) * pow(r, n, n2) % n2 for m, r in zip(vals, rs)
    ]


# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------


def test_backend_selection(monkeypatch):
    n, p, q, hs, randbits = _key_ints(BITS, seed=901)
    monkeypatch.delenv("PAILLIER_TORCH_BACKEND", raising=False)
    assert tdisp.default_backend() == "rns"
    assert tengine.PublicEngine(n, BITS, hs, randbits, device="cpu").backend == "rns"
    monkeypatch.setenv("PAILLIER_TORCH_BACKEND", "cios")  # read per call when unpinned
    assert tdisp.default_backend() == "cios"
    assert tengine.PublicEngine(n, BITS, hs, randbits, device="cpu").backend == "cios"
    assert tconfig.Config.from_env().backend == "cios"
    # the runtime config beats the environment, an explicit backend= both
    tconfig.set_config(tconfig.Config(backend="plain"))
    assert tdisp.default_backend() == "plain"
    prv = tengine.PrivateEngine(n, min(p, q), max(p, q), 2, 1, 1, 1, backend="rns",
                                device="cpu")
    assert prv.backend == "rns" and prv._secondary is None
    assert tengine.PublicEngine(n, BITS, hs, randbits, backend="cios",
                                device="cpu").backend == "cios"
    tconfig.set_config(tconfig.Config())
    monkeypatch.setenv("PAILLIER_TORCH_BACKEND", "pallas")
    with pytest.raises(ValueError):
        tdisp.default_backend()
    with pytest.raises(ValueError):
        tengine.PublicEngine(n, BITS, hs, randbits, backend="xla", device="cpu")
    # a modulus beyond the RNS prime pool's reach falls to the width-generic kernels
    assert tengine._width_backend("rns", 4096) == "rns"
    assert tengine._width_backend("rns", 1 << 20) == "cios"
    assert tengine._width_backend("plain", 1 << 20) == "plain"


# ---------------------------------------------------------------------------
# the modexp API (the five cases of the JAX package's tests)
# ---------------------------------------------------------------------------


def test_modexp_scalar(rng):
    m = rng.getrandbits(128) | (1 << 127) | 1
    b, e = rng.randrange(m), rng.getrandbits(64)
    got = ptorch.modexp(b, e, m, device="cpu")
    assert got == pow(b, e, m) == ptpu.modexp(b, e, m)


@pytest.mark.parametrize("backend", [None, "cios", "plain"])
def test_modexp_vectors(rng, backend):
    m = rng.getrandbits(256) | (1 << 255) | 1
    bs = [rng.randrange(m) for _ in range(7)]
    es = [rng.getrandbits(48) for _ in range(7)]
    got = ptorch.modexp(bs, es, m, backend=backend, device="cpu")
    assert got == [pow(b, e, m) for b, e in zip(bs, es)]
    if backend is None:
        assert got == ptpu.modexp(bs, es, m)


def test_modexp_vector_of_moduli(rng):
    m1 = rng.getrandbits(128) | (1 << 127) | 1
    m2 = rng.getrandbits(160) | (1 << 159) | 1
    bs = [rng.getrandbits(100) for _ in range(6)]
    es = [rng.getrandbits(32) for _ in range(6)]
    ms = [m1, m2, m1, m2, m1, m1]
    got = ptorch.modexp(bs, es, ms, device="cpu")
    assert got == [pow(b, e, m) for b, e, m in zip(bs, es, ms)]
    assert got == ptpu.modexp(bs, es, ms)


def test_modexp_rejects_even_modulus():
    with pytest.raises(ValueError):
        ptorch.modexp(2, 3, 100, device="cpu")
    with pytest.raises(ValueError):
        ptorch.modexp(2, 3, 101, backend="xla", device="cpu")


def test_modexp_size_mismatch():
    with pytest.raises(ValueError):
        ptorch.modexp([1, 2], [3], [5, 7], device="cpu")


def test_modexp_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError):
        ptorch.modexp(2, 3, 101)


# ---------------------------------------------------------------------------
# HybridMode and the split point against the reference's
# ---------------------------------------------------------------------------


def test_hybrid_mode_members_equal_reference():
    assert {m.name: m.value for m in ptorch.HybridMode} == {
        m.name: m.value for m in ptpu.HybridMode
    }
    assert tdisp.WORKLOAD_SIZE_THRESHOLD == jdisp.WORKLOAD_SIZE_THRESHOLD
    assert tdisp.OPTIMAL_RATIOS == jdisp.OPTIMAL_RATIOS
    for name in ("set_hybrid_mode", "set_hybrid_ratio", "set_hybrid_off",
                 "get_hybrid_mode", "get_hybrid_ratio", "modexp", "HybridMode"):
        assert name in ptorch.__all__ and hasattr(ptorch, name)
    for name in ("initialize_context", "get_context", "terminate_context"):
        assert name in ptorch.__all__ and name in ptpu.__all__ and hasattr(ptorch, name)


_SIZES = (1, 2, 3, 5, 7, 10, 128, 129, 1000, 2048)


def _grid(jback, tback):
    return [
        (op, size, jdisp.hybrid_head_count(op, size, jback),
         tdisp.hybrid_head_count(op, size, tback))
        for op in ("encrypt", "decrypt", "multiply", "other") for size in _SIZES
    ]


@pytest.mark.parametrize("mode", list(jdisp.HybridMode), ids=lambda m: m.name)
def test_hybrid_head_count_by_mode_equals_reference(mode):
    if mode == jdisp.HybridMode.UNDEFINED:
        jdisp.set_hybrid_ratio(0.33)
        tdisp.set_hybrid_ratio(0.33)
    else:
        jdisp.set_hybrid_mode(mode)
        tdisp.set_hybrid_mode(tdisp.HybridMode(int(mode)))
    assert int(tdisp.get_hybrid_mode()) == int(jdisp.get_hybrid_mode())
    assert tdisp.get_hybrid_ratio() == jdisp.get_hybrid_ratio()
    assert tdisp.is_hybrid_optimal() == jdisp.is_hybrid_optimal()
    for jback, tback in (("rns", "rns"), ("pallas", "cios"), ("xla", "plain")):
        for op, size, want, got in _grid(jback, tback):
            assert got == want, (op, size, jback)


@pytest.mark.parametrize("ratio", [0.0, 0.12, 0.4, 0.5, 0.999, 1.0])
def test_hybrid_head_count_by_ratio_equals_reference(ratio):
    jdisp.set_hybrid_ratio(ratio)
    tdisp.set_hybrid_ratio(ratio)
    assert tdisp.get_hybrid_mode() == tdisp.HybridMode.UNDEFINED
    for jback, tback in (("rns", "rns"), ("pallas", "cios"), ("xla", "plain")):
        for op, size, want, got in _grid(jback, tback):
            assert got == want == (size if tback == "plain" or ratio >= 1.0
                                   else int(ratio * size))
    tdisp.set_hybrid_ratio(0.25, reset_mode=False)
    assert tdisp.get_hybrid_mode() == tdisp.HybridMode.UNDEFINED
    tdisp.set_hybrid_off()
    tdisp.set_hybrid_ratio(0.25, reset_mode=False)
    assert tdisp.get_hybrid_mode() == tdisp.HybridMode.OPTIMAL
    with pytest.raises(ValueError):
        tdisp.set_hybrid_ratio(1.5)


def test_hybrid_parameters_are_thread_local():
    tdisp.set_hybrid_mode(tdisp.HybridMode.HALF)
    seen = {}

    def worker():
        seen["mode"] = tdisp.get_hybrid_mode()
        tdisp.set_hybrid_ratio(0.1)
        seen["ratio"] = tdisp.get_hybrid_ratio()

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert seen == {"mode": tdisp.HybridMode.OPTIMAL, "ratio": 0.1}
    assert tdisp.get_hybrid_mode() == tdisp.HybridMode.HALF
    assert tdisp.get_hybrid_ratio() == 0.5


# ---------------------------------------------------------------------------
# the hybrid split wired to execution (the five cases of the reference's tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hkey():
    n, p, q, hs, randbits = _key_ints(BITS, seed=1234)
    return keys_from_ints(n, p, q, hs, randbits, device="cpu")  # backend "rns"


def _spy(engine, method):
    calls = []
    orig = getattr(engine, method)

    def wrapper(*args):
        calls.append(args)
        return orig(*args)

    setattr(engine, method, wrapper)
    return calls


def test_hybrid_half_splits_encrypt(hkey, rng):
    """HALF mode must route half of every batch to the plain twin."""
    pk = hkey.pub_key
    sec_calls = _spy(pk._engine.secondary, "_encrypt_djn_impl")
    assert pk._engine.secondary.backend == "plain"
    tdisp.set_hybrid_mode(tdisp.HybridMode.HALF)
    vals = [rng.getrandbits(32) for _ in range(4)]
    ct = pk.encrypt(ptorch.PlainText(vals))
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 2  # tail rows
    assert ct.device_payload().arr.shape[0] == 4  # concatenated, unpadded
    assert hkey.priv_key.decrypt(ct).texts == vals


def test_hybrid_ratio_splits_decrypt(hkey, rng):
    """An explicit ratio must split host-input decrypts at int(r*size)."""
    pk, sk = hkey.pub_key, hkey.priv_key
    vals = [rng.getrandbits(32) for _ in range(5)]
    ct = pk.encrypt(ptorch.PlainText(vals))
    ct_host = ptorch.CipherText(pk, ct.texts)  # host ints: split applies
    sec_calls = _spy(sk._engine.secondary, "_decrypt_crt_impl")
    tdisp.set_hybrid_ratio(0.4)
    assert tdisp.get_hybrid_mode() == tdisp.HybridMode.UNDEFINED
    dt = sk.decrypt(ct_host)
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 3  # 5 - int(.4*5)
    assert dt.texts == vals
    # CT*PT splits too, a shared scalar goes whole to both parts
    mul_calls = _spy(pk._engine.secondary, "_mul_ctpt_impl")
    out = ct_host * ptorch.PlainText([3])
    assert len(mul_calls) == 1 and len(mul_calls[0][0]) == 3 and mul_calls[0][1] == [3]
    assert sk.decrypt(out).texts == [3 * v for v in vals]


def test_hybrid_xla_mode_all_secondary(hkey, rng):
    """HybridMode.XLA (the reference's IPP) runs everything on the twin."""
    pk = hkey.pub_key
    sec_calls = _spy(pk._engine.secondary, "_encrypt_djn_impl")
    tdisp.set_hybrid_mode(tdisp.HybridMode.XLA)
    vals = [rng.getrandbits(32) for _ in range(3)]
    ct = pk.encrypt(ptorch.PlainText(vals))
    assert len(sec_calls) == 1 and len(sec_calls[0][0]) == 3
    assert hkey.priv_key.decrypt(ct).texts == vals


def test_hybrid_optimal_default_no_split(rng):
    """OPTIMAL (default) keeps everything on the kernel backend: the twin
    engine is never even instantiated."""
    n, p, q, hs, randbits = _key_ints(BITS, seed=1235)
    k = keys_from_ints(n, p, q, hs, randbits, device="cpu")
    vals = [rng.getrandbits(32) for _ in range(3)]
    ct = k.pub_key.encrypt(ptorch.PlainText(vals))
    assert k.priv_key.decrypt(ct + ct).texts == [2 * v for v in vals]
    assert k.pub_key._engine._secondary is None
    assert k.priv_key._engine._secondary is None


def test_hybrid_device_resident_skips_split(hkey, rng):
    """Device-resident ciphertexts stay on the primary (no host reslice)."""
    pk, sk = hkey.pub_key, hkey.priv_key
    tdisp.set_hybrid_mode(tdisp.HybridMode.HALF)
    vals = [rng.getrandbits(32) for _ in range(2)]
    ct = pk.encrypt(ptorch.PlainText(vals))  # hybrid-split output
    sec_calls = _spy(sk._engine.secondary, "_decrypt_crt_impl")
    assert sk.decrypt(ct).texts == vals  # DevLimbs payload: primary only
    assert sec_calls == []
    # set_hs drops the twin: it re-derives hs on next use
    first = pk._engine.secondary
    pk._engine.set_hs(pk.hs)
    assert pk._engine._secondary is None and pk._engine.secondary is not first
