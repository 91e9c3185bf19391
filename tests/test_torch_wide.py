"""Keys wider than 2048 bits in the PyTorch/CUDA port, on the CPU: the
host constants at the moduli of 3072- and 4096-bit keys, the f32-reciprocal
reduction with the full (non-lean) fold that their n^2 systems run, the
generic and fixed-base modexp plain versions in that form.  (The grouped CRT
decrypt and a 3072-bit key through the public API are in
``test_torch_wide_api.py``, a file of its own so that parallel test workers
share the time.)

The same numpy / seeded inputs go through the JAX package (its Pallas kernels
in interpret mode) and through the port (CPU tensors, where the kernel
wrappers take their plain versions).  Tolerance: exact integer equality,
and Python ``pow()`` as the oracle.  Everything runs at a few rows and short
exponents: the widths are the real ones, the depth is not."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.experimental import pallas as pl

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import pallas_rns2 as jr2
from pailliercryptolib_tpu.ops import rns as jrns
from pailliercryptolib_tpu_torch.convert import consts_from_jax, fb_table_from_jax
from pailliercryptolib_tpu_torch.models import engine as tengine
from pailliercryptolib_tpu_torch.ops import cuda_modexp, cuda_rns2
from pailliercryptolib_tpu_torch.ops import rns as trns

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """A few rows and a few hundred lanes: torch's intra-op threads only cost,
    and under parallel test workers they oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _np_dict(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.float32:
        assert got.dtype == np.float32 and np.array_equal(
            got.view(np.int32), want.view(np.int32)), what
    else:
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), what


def _ctx_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            _same(x, y, f.name)
        else:
            assert x == y, f.name


def _consts_equal(got, want):
    want = _np_dict(want)
    assert set(k for k in got if not k.startswith("_")) == set(want)
    for key, w in want.items():
        _same(got[key], w, key)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


_WIDE = {}


def _wide_set(bits):
    """(N, port context, JAX context, port consts, JAX consts) of one
    wide-pool modulus, built once."""
    if bits not in _WIDE:
        N = _odd(random.Random(31 + bits), bits)
        tc, jc = trns.RNSContext.create(N), jrns.RNSContext.create(N)
        _WIDE[bits] = (N, tc, jc, cuda_rns2.stack_group_consts2([tc]),
                       jr2.stack_group_consts2([jc]))
    return _WIDE[bits]


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,k,kernel_w", [(6144, 465, 480), (8192, 637, 640)])
def test_wide_constants_equal(bits, k, kernel_w):
    """n^2 of a 3072- / 4096-bit key: moduli below 2^13, so the constant
    sets take the f32-reciprocal flavor; every array equals the reference's."""
    _, tc, jc, tkc, jkc = _wide_set(bits)
    _ctx_equal(tc, jc)
    assert tc.k == k and int(tc.mods.min()) < (1 << 13)
    assert trns.is_wide_pool(tc) and jrns.is_wide_pool(jc)
    assert tkc["muA"].dtype == torch.float32 and jkc["muA"].dtype == jnp.float32
    _consts_equal(tkc, jkc)
    _consts_equal(consts_from_jax(_np_dict(jkc)), jkc)  # the carried-over form
    got, want = tc.device_consts("cpu"), jc.device_consts()
    assert got["barrett"].dtype == torch.float32
    for key in want:
        w = np.asarray(want[key])
        _same(got[key].reshape(w.shape), w, key)
    # what the kernels are handed: f32, full fold, one thread block of up to 640 lanes
    p = cuda_rns2._kernel_pack(tkc)
    assert (p["f32"], p["lean"], p["W"], p["k"]) == (True, False, kernel_w, k)
    assert not cuda_rns2._is_lean(tkc)
    assert trns._alloc_bases(bits)[1] == jrns._alloc_bases(bits)[1]


@pytest.mark.parametrize("pbits,k", [(1536, 227), (2048, 305)])
def test_wide_crt_pair_constants_equal(pbits, k):
    """The (p^2, q^2) pair of a 3072- / 4096-bit key, as the engines build
    it: too wide to fold (2k + 2 > 384), each system within 320 lanes
    and lean; the grouped (stacked) f32 constant set equals the reference's."""
    h = _odd(random.Random(pbits), pbits)
    in_limbs = 2 * lb.limbs_for_bits(2 * pbits)
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    # one context a package, stacked twice: the groups of a stacked set are
    # built one by one, so two equal groups show the layout as well as two
    # different ones, at half the host time
    mine = [trns.RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)] * 2
    theirs = [jrns.RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)] * 2
    _ctx_equal(mine[0], theirs[0])
    assert mine[0].k == mine[1].k == k <= cuda_rns2.LEAN_MAX_CONTRACTION
    assert 2 * k + 2 > tengine.FOLDED_MAX_LANES
    tkc = cuda_rns2.stack_group_consts2(mine, f32_mu=True)
    jkc = jr2.stack_group_consts2(theirs, f32_mu=True)
    _consts_equal(tkc, jkc)
    _consts_equal(consts_from_jax(_np_dict(jkc)), jkc)
    p = cuda_rns2._kernel_pack(tkc)
    assert (p["f32"], p["lean"], p["G"]) == (True, True, 2)
    assert p["W"] <= cuda_rns2.KERNEL_MAX_THREADS_FOLDED
    assert in_limbs <= cuda_rns2.KERNEL_MAX_LIN


def test_kernel_limits():
    """What the kernels are compiled for, and what the wrappers' packing
    refuses."""
    assert cuda_rns2.KERNEL_MAX_THREADS == 640  # n^2 of a 4096-bit key
    assert cuda_rns2.KERNEL_MAX_LIN >= 548  # its n^2-width ciphertext
    assert cuda_rns2.KERNEL_MAX_THREADS_FOLDED == 320
    assert cuda_rns2.KERNEL_MAX_LIN_FOLDED == 288
    assert cuda_modexp.KERNEL_MAX_L == 547
    assert tengine.MAX_KEY_BITS == ptorch.models.keygen.N_BIT_SIZE_MAX == 4096
    # a folded pair beyond 320 lanes is refused (such keys run grouped)
    rng = random.Random(9)
    pair = [trns.RNSContext.create(_odd(rng, 1536) ** 2) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="grouped"):
        cuda_rns2._kernel_pack(
            cuda_rns2.fold_group_consts2(pair, f32_mu=True, shared_input=True))


# ---------------------------------------------------------------------------
# the Montgomery product in the f32 flavor with the full fold
# ---------------------------------------------------------------------------


def _pallas_mont_mul(jkc, xA, xB, yA, yB, canonical_out):
    """The reference's ``_make_mont_mul2`` on one constant set, inside a
    Pallas kernel run in interpret mode."""
    n_c = jr2._MM2_NREFS

    def kernel(*refs):
        c = jr2._mm2_cref(refs[:n_c])
        xa, xb, ya, yb, oa, ob = refs[n_c:]
        ra, rb = jr2._make_mont_mul2(c, canonical_out=canonical_out)(
            xa[0], xb[0], ya[0], yb[0])
        oa[0] = ra
        ob[0] = rb

    args, specs = jr2._mm2_args_specs(jkc)
    ops = [jnp.asarray(a, jnp.uint32)[None] for a in (xA, xB, yA, yB)]
    block = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0, 0))
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct(ops[0].shape, jnp.uint32),
                   jax.ShapeDtypeStruct(ops[1].shape, jnp.uint32)),
        grid=(1,),
        in_specs=specs + [block(a) for a in ops],
        out_specs=(block(ops[0]), block(ops[1])),
        interpret=True,
    )(*args, *ops)


@pytest.mark.parametrize("canonical_out", [False, True])
def test_mont_mul2_f32_full_fold_matches_reference(canonical_out):
    """k = 465: the contraction is beyond 320, so the f32 reduction runs with
    the full fold — the form no narrower key reaches."""
    _, tc, _, tkc, jkc = _wide_set(6144)
    k = tc.k
    assert jkc["muA"].dtype == jnp.float32 and jkc["T1lo"].shape[-2] > 320
    r = np.random.default_rng(7)
    rows = 8
    mods = tc.mods.astype(np.int64)
    x = r.integers(0, 1 << 30, (rows, 2 * k + 1)) % mods
    y = r.integers(0, 1 << 30, (rows, 2 * k + 1)) % mods
    x[0], y[1] = mods - 1, mods - 1  # the largest residues
    y[0] = mods - 1
    wantA, wantB = _pallas_mont_mul(jkc, x[:, :k], x[:, k:], y[:, :k], y[:, k:],
                                    canonical_out)
    c = cuda_rns2._plain_consts(tkc)
    t64 = lambda a: torch.from_numpy(a.astype(np.int64))
    gotA, gotB = cuda_rns2.mont_mul2_plain(
        c, t64(x[:, :k]), t64(x[:, k:]), t64(y[:, :k]), t64(y[:, k:]),
        canonical_out=canonical_out)
    _same(gotA, wantA[0])
    _same(gotB, wantB[0])
    if canonical_out:
        assert bool((gotA < c["modsA"]).all())


# ---------------------------------------------------------------------------
# K5, K1, K2 plain versions on the wide-pool set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
def test_k5_plain_matches_pallas_wide(shared):
    N, tc, jc, tkc, jkc = _wide_set(6144)
    rng = random.Random(5)
    B, ebits = 8, 12
    bases = [rng.randrange(N) for _ in range(B - 2)] + [0, 1]
    exps = [rng.getrandbits(ebits) for _ in range(1 if shared else B)]
    x = lb.ints_to_limbs(bases, jc.Lin)[None]
    wins = lb.ints_to_windows(exps, ebits)
    wins = wins if shared else wins[None]
    want = jr2.pallas_rns_modexp2(jnp.asarray(x), jnp.asarray(wins), jkc,
                                  shared=shared, interpret=True, batch_tile=B)
    got = cuda_rns2.rns_modexp2(_t(x), _t(wins), tkc, shared=shared)
    _same(got, want)
    vals = lb.limbs_to_ints(
        trns.rns_to_limbs(got[0], tc.device_consts("cpu")).numpy().astype(np.uint32))
    for i, (b, v) in enumerate(zip(bases, vals)):
        assert v % N == pow(b, exps[0 if shared else i], N) and v <= 2 * N


@pytest.fixture(scope="module", params=["f32_full_k465", "f32_lean_k22"])
def fb_f32(request):
    """Fixed-base set-up in the f32-reciprocal flavor: the wide-pool set
    (full fold) and a 256-bit modulus with the flavor asked for (lean)."""
    rng = random.Random(77)
    if request.param == "f32_full_k465":
        N, tc, jc, tkc, jkc = _wide_set(6144)
    else:
        N = _odd(rng, 256)
        tc, jc = trns.RNSContext.create(N), jrns.RNSContext.create(N)
        tkc = cuda_rns2.stack_group_consts2([tc], f32_mu=True)
        jkc = jr2.stack_group_consts2([jc], f32_mu=True)
    assert tkc["muA"].dtype == torch.float32
    k, NP = tc.k, 8
    r = np.random.default_rng(3)
    mods = tc.mods.astype(np.int64)
    g = r.integers(0, 1 << 30, (NP, 2 * k + 1)) % mods
    gA, gB = g[None, :, :k], g[None, :, k:]
    jtabA, jtabB = jr2.pallas_fb_table2(
        jnp.asarray(gA, jnp.uint32), jnp.asarray(gB, jnp.uint32), jkc, interpret=True)
    return dict(tc=tc, tkc=tkc, jkc=jkc, gA=gA, gB=gB, NP=NP,
                jtabA=jtabA, jtabB=jtabB, r=r)


def test_fb_table2_f32_matches_pallas(fb_f32):
    f = fb_f32
    tabA, tabB = cuda_rns2.fb_table2(_t(f["gA"]), _t(f["gB"]), f["tkc"])
    _same(tabA, f["jtabA"])
    _same(tabB, f["jtabB"])
    # canonical entries, also under the f32 flavor
    assert bool((tabA.to(torch.int64) < f["tkc"]["modsA"][0].to(torch.int64)).all())


@pytest.mark.parametrize("mont_out", [False, True])
def test_fb_modexp2_f32_matches_pallas(fb_f32, mont_out):
    f = fb_f32
    B = 8
    wb = f["r"].integers(0, 256, (1, B, f["NP"]), dtype=np.uint8)
    planes = jr2.fb_digit_planes2(f["jtabA"], f["jtabB"])
    want = jr2.pallas_fb_modexp2(*planes, jnp.asarray(wb), f["jkc"], interpret=True,
                                 batch_tile=B, streams=2, mont_out=mont_out)
    tab = fb_table_from_jax([np.asarray(p) for p in planes])
    got = cuda_rns2.fb_modexp2(tab, torch.from_numpy(wb.copy()), f["tkc"],
                               mont_out=mont_out)
    _same(got, want)
