"""The generic RNS modexp (K5) of the PyTorch/CUDA port and the pipeline
stages around it, against the JAX package on the same numpy/seeded inputs.

The port's functions get CPU tensors, where the kernel wrappers take their
plain versions; the JAX functions run their Pallas kernels in interpret
mode, with the ``streams`` the reference ships (2 for the shared-exponent
stage, 4 for the grouped CRT decrypt).  All at a 256-bit key.  Tolerance:
exact integer equality — residue for residue out of the kernels, canonical
limb for limb out of the stages."""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import paillier_ops as jpops
from pailliercryptolib_tpu.ops import pallas_rns2 as jr2
from pailliercryptolib_tpu_torch.convert import fb_table_from_jax, keys_from_ints
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.ops import cuda_rns2
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.ops import rns as trns
from pailliercryptolib_tpu_torch.utils import iso_vectors

B = jr2.BATCH_TILE  # 128: one Pallas batch tile
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


def _prime34(rng, bits):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 3
        if miller_rabin(c):
            return c


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny (a few rows, a few hundred lanes): torch's
    intra-op thread pool only costs, and under parallel test workers it
    oversubscribes the cores (the 2048-bit known-answer test below runs
    thousands of such ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def env():
    """One 256-bit DJN key in both packages, its engines' constants, and a
    batch of bases / exponents made from a seed."""
    rng = random.Random(2718)
    while True:
        p, q = _prime34(rng, BITS // 2), _prime34(rng, BITS // 2)
        n = p * q
        if p != q and n.bit_length() == BITS and math.gcd(p - 1, q - 1) == 2:
            break
    r = rng.randrange(2, n)
    hs = pow((-(r * r)) % n, n, n * n)
    jpk = ptpu.PublicKey(n, BITS, hs=hs, randbits=BITS // 2)
    jsk = ptpu.PrivateKey(jpk, p, q)
    for e in (jpk._engine, jsk._engine):
        e.backend = "rns_interpret"
    tkey = keys_from_ints(n, p, q, hs, BITS // 2, device="cpu")
    te, je = tkey.pub_key._engine, jpk._engine
    jctx, jkc, jconv = je.rns
    _, tkc, tconv = te.rns
    N = n * n
    bases = [rng.randrange(N) for _ in range(B - 3)] + [0, 1, N - 1]
    x = lb.ints_to_limbs(bases, je.L2)
    return dict(rng=rng, n=n, p=p, q=q, hs=hs, N=N, jpk=jpk, jsk=jsk,
                tpk=tkey.pub_key, tsk=tkey.priv_key, te=te, je=je, jctx=jctx,
                jkc=jkc, jconv=jconv, tkc=tkc, tconv=tconv, bases=bases, x=x,
                cache={})


def _shared_result(env):
    """Both packages' shared-exponent stage on the same bases (exponent n),
    computed once: (jax residues, port residues)."""
    c = env["cache"]
    if "shared" not in c:
        je, te = env["je"], env["te"]
        want = jpops.rns_modexp_shared_stage(
            _j(env["x"]), je.n_wins, env["jkc"], interpret=True
        )
        got = tpops.rns_modexp_shared_stage(_t(env["x"]), te.n_wins, env["tkc"])
        c["shared"] = (np.asarray(want), got)
    return c["shared"]


def _check_pow(env, res, exps, conv=None, N=None, bases=None):
    """Residues [B, K] are those of base^e mod N, value <= 2N."""
    N = N or env["N"]
    vals = _ints(trns.rns_to_limbs(res, conv or env["tconv"]).numpy())
    for b, e, v in zip(bases or env["bases"], exps, vals):
        assert v % N == pow(b, e, N) and v <= 2 * N


# ---------------------------------------------------------------------------
# (a) the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def test_constants_equal_the_reference(env):
    """The engines of both packages hold the same kernel constants, so the
    comparisons below feed both sides the same numbers."""
    for key, v in env["jkc"].items():
        assert _eq(env["tkc"][key].to(torch.float64)
                   if env["tkc"][key].dtype == torch.float32
                   else env["tkc"][key], np.asarray(v)), key
    assert _eq(env["te"].n_wins, env["je"].n_wins)


def test_shared_stage_matches_pallas_streams2_and_pow(env):
    want, got = _shared_result(env)
    assert got.dtype == torch.int32 and _eq(got, want)
    _check_pow(env, got, [env["n"]] * B)


def test_shared_matches_pallas_streams1(env):
    """The reference's result does not depend on its row-streams; the port
    has none."""
    want = jr2.pallas_rns_modexp2(
        _j(env["x"])[None], env["je"].n_wins, env["jkc"], shared=True,
        streams=1, interpret=True,
    )
    assert _eq(_shared_result(env)[1], np.asarray(want)[0])


def test_var_stage_matches_pallas_and_pow(env):
    rng = env["rng"]
    exps = [rng.getrandbits(32) for _ in range(B - 3)] + [0, 1, (1 << 32) - 1]
    wins = lb.ints_to_windows(exps, 32)
    want = jpops.rns_modexp_stage(_j(env["x"]), _j(wins), env["jkc"], interpret=True)
    got = tpops.rns_modexp_stage(_t(env["x"]), _t(wins), env["tkc"])
    assert got.dtype == torch.int32 and _eq(got, want)
    _check_pow(env, got, exps)
    # a ragged batch gives the same rows
    part = tpops.rns_modexp_stage(_t(env["x"][:21]), _t(wins[:21]), env["tkc"])
    assert torch.equal(part, got[:21])


@pytest.fixture(scope="module")
def crt_grouped(env):
    """The key's (p^2, q^2) pair as STACKED f32 constants in both packages,
    with the JAX conversion constants stacked as its engine stacks them."""
    cp, cq = env["jsk"]._engine._rns_crt_ctxs()
    jkc2 = jr2.stack_group_consts2([cp, cq], f32_mu=True)
    jconv2 = jax.tree.map(
        lambda a, b: jnp.stack([jnp.asarray(a), jnp.asarray(b)]),
        cp.device_consts(), cq.device_consts(),
    )
    tkc2, tconv2 = env["tsk"]._engine.rns_crt_stacked
    return dict(cp=cp, cq=cq, jkc2=jkc2, jconv2=jconv2, tkc2=tkc2, tconv2=tconv2)


def test_grouped_f32_matches_pallas_streams4_and_pow(env, crt_grouped):
    """G = 2 stacked f32 constants, shared exponents p-1 / q-1, the full
    ciphertext to both groups, 4 row-streams in the reference (the
    configuration its grouped CRT decrypt ships)."""
    g = crt_grouped
    for key, v in g["jkc2"].items():
        assert np.array_equal(g["tkc2"][key].numpy(), np.asarray(v).astype(
            g["tkc2"][key].numpy().dtype)), key
    assert g["tkc2"]["muA"].dtype == torch.float32 and g["tkc2"]["sig0"].shape[0] == 2
    je = env["jsk"]._engine
    wins = np.asarray(je.exp_wins)[:, 0]  # [2, NW]
    # decrypt's operand width: 2 * Lp2 limbs (one more than n^2 needs here)
    xg = np.pad(env["x"], ((0, 0), (0, 2 * je.Lp2 - env["x"].shape[1])))
    x = _j(xg)
    want = jr2.pallas_rns_modexp2(
        jnp.broadcast_to(x[None], (2,) + x.shape), jnp.asarray(wins), g["jkc2"],
        shared=True, streams=4, interpret=True,
    )
    got = cuda_rns2.rns_modexp2(_t(xg)[None], _t(wins), g["tkc2"], shared=True)
    assert got.shape == (2, B, 2 * g["cp"].k + 1) and _eq(got, want)
    # one copy per group is the same input
    both = cuda_rns2.rns_modexp2(
        _t(xg)[None].expand(2, -1, -1).contiguous(), _t(wins), g["tkc2"],
        shared=True,
    )
    assert torch.equal(both, got)
    for i, h in enumerate((env["p"], env["q"])):
        _check_pow(env, got[i], [h - 1] * B, conv=g["tconv2"][i], N=h * h,
                   bases=[b % (h * h) for b in env["bases"]])


def test_rns_modexp2_rejects_wrong_inputs(env):
    x, kc = _t(env["x"])[None], env["tkc"]
    wins = env["te"].n_wins
    with pytest.raises(TypeError):
        cuda_rns2.rns_modexp2(x.to(torch.int64), wins, kc, shared=True)
    with pytest.raises(ValueError):  # per-row windows expected without shared
        cuda_rns2.rns_modexp2(x, wins, kc)
    with pytest.raises(ValueError):
        cuda_rns2.rns_modexp2(x[:, :, :-1].contiguous(), wins, kc, shared=True)
    with pytest.raises(ValueError):  # two base groups, one constant group
        cuda_rns2.rns_modexp2(x.expand(2, -1, -1).contiguous(), wins, kc, shared=True)
    with pytest.raises(ValueError):  # folded constants belong to rns_modexp2f
        cuda_rns2.rns_modexp2(x, wins, env["tsk"]._engine.rns_crt[0], shared=True)
    before = dict(cuda_rns2.LAUNCHES)
    cuda_rns2.rns_modexp2(x[:, :3].contiguous(), wins, kc, shared=True)
    assert dict(cuda_rns2.LAUNCHES) == before  # the plain route counts nothing


# ---------------------------------------------------------------------------
# (b) the stages around the kernels
# ---------------------------------------------------------------------------


def test_rns_finalize_stage_equal(env):
    want_res, got_res = _shared_result(env)
    je, te = env["je"], env["te"]
    want = jpops.rns_finalize_stage(
        jnp.asarray(want_res), env["jconv"], je.n2_args[0], out_limbs=je.L2
    )
    got = tpops.rns_finalize_stage(got_res, env["tconv"], te.n2_n, te.L2)
    assert _eq(got, want)
    assert _ints(got.numpy()) == [pow(b, env["n"], env["N"]) for b in env["bases"]]


def _plaintext_limbs(env, rows=B):
    rng = env["rng"]
    vals = [rng.getrandbits(64) for _ in range(rows - 2)] + [0, env["n"] - 1]
    return vals, lb.ints_to_limbs(vals, env["je"].Ln)


@pytest.mark.parametrize("res_mont", [False, True])
def test_encrypt_post_stage_equal(env, res_mont):
    """Both forms of the encrypt tail on the same obfuscator residues (with
    ``res_mont`` they are read as a Montgomery-form value)."""
    want_res, got_res = _shared_result(env)
    je, te = env["je"], env["te"]
    vals, m = _plaintext_limbs(env)
    n2_n, n2_n0inv, n2_r2, _ = je.n2_args
    want = jpops.encrypt_post_stage(
        jnp.asarray(want_res), _j(m), je.n_limbs, env["jconv"], n2_n, n2_n0inv,
        n2_r2, res_mont=res_mont,
    )
    got = tpops.encrypt_post_stage(
        got_res, _t(m), te.n_limbs, env["tconv"], te.n2_n, res_mont=res_mont
    )
    assert _eq(got, want)
    if not res_mont:
        n, N = env["n"], env["N"]
        assert _ints(got.numpy()) == [
            (n * v + 1) * pow(b, n, N) % N for v, b in zip(vals, env["bases"])
        ]


@pytest.mark.parametrize("nbytes,L", [(65, 35), (3, 8), (67, 36)])
def test_bytes_to_limbs_dev_equal(nbytes, L):
    r = np.random.default_rng(nbytes)
    by = r.integers(0, 256, (7, nbytes), dtype=np.uint8)
    want = jpops._bytes_to_limbs_dev(jnp.asarray(by), L)
    got = tpops._bytes_to_limbs_dev(torch.from_numpy(by), L)
    assert got.dtype == torch.int32 and _eq(got, want)
    mask = (1 << (15 * L)) - 1
    assert _ints(got.numpy()) == [
        int.from_bytes(row.tobytes(), "little") & mask for row in by
    ]


def _seed_pair(tag):
    data = np.random.default_rng(tag).integers(
        0, 1 << 32, (1, 11), dtype=np.uint64
    ).astype(np.uint32)
    return jnp.asarray(data), torch.from_numpy(data.astype(np.int64))


def test_encrypt_normal_rng_stage_equal(env):
    je, te = env["je"], env["te"]
    _, m = _plaintext_limbs(env)
    jseed, tseed = _seed_pair(11)
    ebits = 2 * je.nbits + 3
    want = jpops.encrypt_normal_rng_stage(
        jseed, _j(m), je.n_wins, je.n_limbs, env["jkc"], env["jconv"],
        je.n2_args[0], ebits=ebits, interpret=True,
    )
    got = tpops.encrypt_normal_rng_stage(
        tseed, _t(m), te.n_wins, te.n_limbs, env["tkc"], env["tconv"], te.n2_n,
        ebits=ebits,
    )
    assert _eq(got, want)


def _fixed_base(env):
    c = env["cache"]
    if "fb" not in c:
        planes, NP = env["je"].fixedbase
        tab = fb_table_from_jax([np.asarray(p) for p in planes])
        assert torch.equal(tab, env["te"].fixedbase[0])
        c["fb"] = (planes, tab, NP)
    return c["fb"]


@pytest.mark.parametrize("mont_out", [False, True])
def test_rns_fb_modexp_stage_equal(env, mont_out):
    planes, tab, NP = _fixed_base(env)
    rng = env["rng"]
    exps = [rng.getrandbits(BITS // 2) for _ in range(B)]
    wb = lb.ints_to_bytes_le(exps, NP)
    want = jpops.rns_fb_modexp_stage(
        planes, jnp.asarray(wb), env["jkc"], interpret=True, mont_out=mont_out
    )
    got = tpops.rns_fb_modexp_stage(
        tab, torch.from_numpy(wb.copy()), env["tkc"], mont_out=mont_out
    )
    assert _eq(got, want)
    env["cache"][("fb_res", mont_out)] = (np.asarray(want), got)


@pytest.mark.parametrize("res_mont", [False, True])
def test_mul_res_post_stage_equal(env, res_mont):
    key = ("fb_res", res_mont)
    if key not in env["cache"]:
        test_rns_fb_modexp_stage_equal(env, res_mont)
    want_res, got_res = env["cache"][key]
    want = jpops.mul_res_post_stage(
        _j(env["x"]), jnp.asarray(want_res), env["jconv"], env["je"].n2_args[0],
        res_mont=res_mont,
    )
    got = tpops.mul_res_post_stage(
        _t(env["x"]), got_res, env["tconv"], env["te"].n2_n, res_mont=res_mont
    )
    assert _eq(got, want)


def test_obfuscate_fb_fused_rng_stage_equal(env):
    planes, tab, _ = _fixed_base(env)
    je, te = env["je"], env["te"]
    jseed, tseed = _seed_pair(12)
    want = jpops.obfuscate_fb_fused_rng_stage(
        planes, jseed, je.fb_mask, _j(env["x"]), env["jkc"], env["jconv"],
        je.n2_args[0], interpret=True,
    )
    got = tpops.obfuscate_fb_fused_rng_stage(
        tab, tseed, te.fb_mask, _t(env["x"]), env["tkc"], env["tconv"], te.n2_n
    )
    assert _eq(got, want)


def test_add_ctct_rns_op_equal(env):
    N = env["N"]
    ys = [env["rng"].randrange(N) for _ in range(B)]
    y = lb.ints_to_limbs(ys, env["je"].L2)
    want = jpops.add_ctct_rns_op(
        _j(env["x"]), _j(y), env["jconv"], env["je"].n2_args[0]
    )
    got = tpops.add_ctct_rns_op(_t(env["x"]), _t(y), env["tconv"], env["te"].n2_n)
    assert _eq(got, want)
    assert _ints(got.numpy()) == [a * b % N for a, b in zip(env["bases"], ys)]
    # a size-1 operand broadcast as the engine broadcasts it
    one = tpops.add_ctct_rns_op(
        _t(env["x"]), _t(y[:1]).expand(B, -1), env["tconv"], env["te"].n2_n
    )
    assert _ints(one.numpy()) == [a * ys[0] % N for a in env["bases"]]


def test_encrypt_noobf_op_equal(env):
    je, te = env["je"], env["te"]
    vals, m = _plaintext_limbs(env, 9)
    want = jpops.encrypt_noobf_op(_j(m), je.n_limbs, je.n2_args[0])
    got = tpops.encrypt_noobf_op(_t(m), te.n_limbs, te.n2_n)
    assert _eq(got, want)
    assert _ints(got.numpy()) == [env["n"] * v + 1 for v in vals]
    narrow = tpops.encrypt_noobf_op(_t(m[:-1, :8]), te.n_limbs, te.n2_n)
    assert torch.equal(narrow, got[:-1])  # narrow plaintext upload


def test_hensel_post_stage_equal(env):
    """RAW decrypt's tail on values that are 1 mod n (as c^lambda is)."""
    js, ts = env["jsk"]._engine, env["tsk"]._engine
    n, N = env["n"], env["N"]
    ks = [env["rng"].randrange(n) for _ in range(B - 2)] + [0, n - 1]
    res = lb.ints_to_limbs([1 + k * n for k in ks], ts.mont_n2.num_limbs)
    n_n, n_n0inv, n_r2, _ = js.mont_n.as_device_args()
    want = jpops.hensel_post_stage(
        _j(res), js.hensel_n, js.x_limbs, n_n, n_n0inv, n_r2,
        backend="pallas_interpret",
    )
    got = tpops.hensel_post_stage(
        _t(res), ts.hensel_n, ts.x_limbs, ts.n_n, ts.n_n0inv, ts.n_r2
    )
    assert _eq(got, want)
    x = env["tsk"].x
    assert _ints(got.numpy()) == [k * x % n for k in ks]


def test_decrypt_crt_grouped_equal(env, crt_grouped):
    """decrypt_crt_rns_op with stacked constants: the reference's grouped
    branch (two-group grid, 4 streams) against the port's, and both against
    the port's folded branch on the same ciphertexts."""
    g = crt_grouped
    js, ts = env["jsk"]._engine, env["tsk"]._engine
    n = env["n"]
    vals = [env["rng"].randrange(n) for _ in range(B - 2)] + [0, n - 1]
    env["tpk"].set_random([env["rng"].getrandbits(BITS // 2) for _ in range(B)])
    ct = env["tpk"].encrypt(vals).device_payload().arr
    ct = torch.nn.functional.pad(ct, (0, 2 * ts.Lp2 - ct.shape[1]))  # decrypt's width
    want = jpops.decrypt_crt_rns_op(
        _j(ct.numpy()), js.sq_n, js.exp_wins, js.hensel, js.hfun, js.pq_n,
        js.pq_n0inv, js.pq_r2, js.pinv_q, js.p_limbs, g["jkc2"], g["jconv2"],
        interpret=True,
    )
    args = (ct, ts.sq_n, ts.exp_wins, ts.hensel, ts.hfun, ts.pq_n, ts.pq_n0inv,
            ts.pq_r2, ts.pinv_q, ts.p_limbs)
    got = tpops.decrypt_crt_rns_op(*args, g["tkc2"], g["tconv2"])
    assert _eq(got, want) and _ints(got.numpy()) == vals
    folded = tpops.decrypt_crt_rns_op(*args, *ts.rns_crt)
    assert torch.equal(got, folded)


# ---------------------------------------------------------------------------
# (d) ISO/IEC 18033-6 known-answer test through the port
# ---------------------------------------------------------------------------


def test_iso_iec_18033_6_through_the_port_cpu():
    """2048-bit non-DJN key, injected r, c1, c2, c1*c2 and the decrypted sum
    exact — the vectors are those of the reference's own test."""
    import test_cryptography as ref

    for name in ("ISO_P", "ISO_Q", "ISO_R0", "ISO_R1", "ISO_M1", "ISO_M2",
                 "ISO_C1", "ISO_C2", "ISO_C1C2", "ISO_M1M2"):
        assert getattr(iso_vectors, name) == getattr(ref, name), name
    iso_vectors.check_iso_vectors("cpu")
