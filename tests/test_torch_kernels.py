"""Plain versions of the port's first four CUDA kernels against the Pallas kernels
they replace (run in interpret mode on the CPU, as the JAX package's own
tests run them) and against Python pow().  The wrappers are called with CPU
tensors, which is the one case in which they take the plain version.
Tolerance: exact integer equality, residue for residue."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pailliercryptolib_tpu.ops import limbs as lb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops import paillier_ops as jpops
from pailliercryptolib_tpu.ops import pallas_rns2 as jr2
from pailliercryptolib_tpu.ops import rns as jrns
from pailliercryptolib_tpu.ops.pallas_modexp import pallas_mod_mul
from pailliercryptolib_tpu_torch.convert import consts_from_jax, fb_table_from_jax
from pailliercryptolib_tpu_torch.models.keygen import miller_rabin
from pailliercryptolib_tpu_torch.ops import cuda_modexp, cuda_rns2
from pailliercryptolib_tpu_torch.ops import paillier_ops as tpops
from pailliercryptolib_tpu_torch.ops import rns as trns

B = jr2.BATCH_TILE  # 128: one Pallas batch tile


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.shape == want.shape and np.array_equal(
        got.numpy().astype(np.int64), want.astype(np.int64)
    )


def _np_dict(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _prime(rng, bits):
    while True:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if miller_rabin(c):
            return c


def _ints(t):
    return lb.limbs_to_ints(t.numpy().astype(np.uint32))


# ---------------------------------------------------------------------------
# K1 / K2: fixed-base table and modexp (integer-Barrett flavor)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[256, 4096])
def fb256(request):
    """Fixed-base set-up at a small modulus and at the width of a 2048-bit
    key's n^2 (k = 304 lanes, the kernels' full width)."""
    bits = request.param
    rng = random.Random(4242 + bits)
    N = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    c = jrns.RNSContext.create(N)
    jkc = jr2.stack_group_consts2([c])
    jconv = c.device_consts()
    tkc = consts_from_jax(_np_dict(jkc))
    tconv = consts_from_jax(_np_dict(jconv))
    base = rng.randrange(2, N)
    NP = 8  # 64-bit exponents -> 8 byte-windows
    g = [base]
    for _ in range(NP - 1):
        g.append(pow(g[-1], 256, N))
    g_limbs = lb.ints_to_limbs(g, c.Lin)
    # the reference's stage, step by step, so that the table kernel's own
    # inputs and outputs are at hand
    k = c.k
    res = jrns.limbs_to_rns(jnp.asarray(g_limbs), jconv)
    gm = jrns.rns_mont_mul(res, jconv["mont_sq"][None, :], jconv)
    gB = jrns.mulmod(
        gm[:, k:], jkc["wvec"][0][None, :], jconv["mods"][k:], jconv["barrett"][k:]
    )
    gA = gm[None, :, :k]
    jtabA, jtabB = jr2.pallas_fb_table2(gA, gB[None], jkc, interpret=True)
    planes = jr2.fb_digit_planes2(jtabA, jtabB)
    return dict(rng=rng, N=N, c=c, jkc=jkc, jconv=jconv, tkc=tkc, tconv=tconv,
                base=base, NP=NP, g_limbs=g_limbs, gA=np.asarray(gA),
                gB=np.asarray(gB[None]), jtabA=np.asarray(jtabA),
                jtabB=np.asarray(jtabB), planes=planes)


def test_fb_table2_matches_pallas(fb256):
    f = fb256
    tabA, tabB = cuda_rns2.fb_table2(_t(f["gA"]), _t(f["gB"]), f["tkc"])
    assert tabA.dtype == torch.int32 and tabA.shape == (1, 256, f["NP"], f["c"].k)
    assert _eq(tabA, f["jtabA"]) and _eq(tabB, f["jtabB"])


def test_fb_table2_entries_match_pow(fb256):
    """Entry [j, i] = Mont(base^(j * 2^(8 i))), B lanes scaled by w."""
    f = fb256
    c, N = f["c"], f["N"]
    tabA, tabB = cuda_rns2.fb_table2_plain(_t(f["gA"]), _t(f["gB"]), f["tkc"])
    table = torch.cat([tabA[0], tabB[0]], dim=-1).numpy()  # [256, NP, K]
    wvec = [1] * c.k + list(c.MBj_inv_B) + [c.MBinv_mr]
    for i, j in [(0, 0), (0, 1), (0, 255), (3, 17), (f["NP"] - 1, 2)]:
        want = pow(f["base"], j * (1 << (8 * i)), N) * c.MA % N
        for m, w, v in zip(c.mods, wvec, table[j, i]):
            assert 0 <= int(v) < int(m)  # canonical
            assert int(v) == want * int(w) % int(m), (i, j)


def test_fb_table_stage_matches_reference_planes(fb256):
    """The port's stage (limbs -> gather table) equals the reference's
    stage output recombined as lo + (hi << 7)."""
    f = fb256
    tab = tpops.fb_table_stage(_t(f["g_limbs"]), f["tkc"], f["tconv"])
    jplanes = jpops.fb_table_stage(
        jnp.asarray(f["g_limbs"]), f["jkc"], f["jconv"], interpret=True
    )
    want = fb_table_from_jax([np.asarray(p) for p in jplanes])
    assert tab.shape == (f["NP"], 256, 2 * f["c"].k + 1)
    assert torch.equal(tab, want)


@pytest.fixture(scope="module")
def fb_exps(fb256):
    rng = fb256["rng"]
    exps = [rng.getrandbits(64) for _ in range(B - 3)] + [0, 1, (1 << 64) - 1]
    return exps, lb.ints_to_bytes_le(exps, fb256["NP"])


@pytest.mark.parametrize("mont_out", [False, True])
def test_fb_modexp2_matches_pallas_and_pow(fb256, fb_exps, mont_out):
    f = fb256
    exps, wb = fb_exps
    c, N = f["c"], f["N"]
    want = jr2.pallas_fb_modexp2(
        *f["planes"], jnp.asarray(wb)[None], f["jkc"], interpret=True,
        batch_tile=B, streams=2, mont_out=mont_out,
    )
    tab = fb_table_from_jax([np.asarray(p) for p in f["planes"]])
    got = cuda_rns2.fb_modexp2(
        tab, torch.from_numpy(wb.copy())[None], f["tkc"], mont_out=mont_out
    )
    assert got.dtype == torch.int32 and _eq(got, want)
    vals = _ints(trns.rns_to_limbs(got[0], f["tconv"]))
    scale = c.MA % N if mont_out else 1
    bound = 3 * N if mont_out else 2 * N
    for e, v in zip(exps, vals):
        assert v % N == pow(f["base"], e, N) * scale % N and v <= bound


def test_fb_modexp2_ragged_batch(fb256, fb_exps):
    """A batch that is no multiple of any tile: row i's result does not
    depend on the batch it rides in."""
    f = fb256
    _, wb = fb_exps
    tab = fb_table_from_jax([np.asarray(p) for p in f["planes"]])
    wins = torch.from_numpy(wb.copy())[None]
    full = cuda_rns2.fb_modexp2(tab, wins, f["tkc"], mont_out=True)
    part = cuda_rns2.fb_modexp2(tab, wins[:, :37].contiguous(), f["tkc"], mont_out=True)
    assert torch.equal(part, full[:, :37])


# ---------------------------------------------------------------------------
# K3: CRT-folded modexp, the configuration that ships (folded lanes,
# shared full-width input, f32-reciprocal reduction)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(64, None), (1024, 32)])
def crt_fold(request):
    """p^2/q^2 pair as the engines build it; the small pair runs the full
    exponents p-1, q-1, the 2048-bit-key pair (151 lanes a group, the lean
    fold at its real width) 32-bit exponents to keep interpret mode short."""
    pbits, ebits = request.param
    rng = random.Random(977 + pbits)
    p, q = sorted((_prime(rng, pbits), _prime(rng, pbits)))
    Lp2 = lb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    cp = jrns.RNSContext.create(p * p, in_limbs=in_limbs, product_bits=bits)
    cq = jrns.RNSContext.create(q * q, in_limbs=in_limbs, product_bits=bits)
    jkc2 = jr2.fold_group_consts2([cp, cq], f32_mu=True, shared_input=True)
    tkc2 = consts_from_jax(_np_dict(jkc2))
    n2 = (p * q) ** 2
    cts = [rng.randrange(n2) for _ in range(B - 3)] + [0, 1, n2 - 1]
    x = lb.ints_to_limbs(cts, in_limbs)
    if ebits is None:
        exps = [p - 1, q - 1]
        ewbits = max(8, -(-lb.num_windows(pbits) // 8) * 8) * 4
    else:
        exps = [rng.getrandbits(ebits) | 1 for _ in range(2)]
        ewbits = ebits
    wins = np.concatenate(
        [lb.ints_to_windows([e], ewbits) for e in exps]
    )  # [2, NW]
    want = jr2.pallas_rns_modexp2f(
        jnp.asarray(x), jnp.asarray(wins), jkc2, interpret=True,
        batch_tile=B, streams=4,
    )
    return dict(p=p, q=q, cp=cp, cq=cq, tkc2=tkc2, cts=cts, x=x, wins=wins,
                exps=exps, want=np.asarray(want))


def test_rns_modexp2f_matches_pallas(crt_fold):
    f = crt_fold
    assert f["tkc2"]["muA"].dtype == torch.float32  # the f32 flavor
    assert f["tkc2"]["CinA"].shape[-2] == f["x"].shape[-1]  # shared input
    got = cuda_rns2.rns_modexp2f(_t(f["x"]), _t(f["wins"]), f["tkc2"])
    assert got.dtype == torch.int32 and _eq(got, f["want"])


def test_rns_modexp2f_matches_pow(crt_fold):
    f = crt_fold
    got = cuda_rns2.rns_modexp2f_plain(_t(f["x"]), _t(f["wins"]), f["tkc2"])
    res = cuda_rns2.unfold_rns_out(got, f["cp"].k)
    want_unfold = jr2.unfold_rns_out(jnp.asarray(f["want"]), f["cp"].k)
    assert _eq(res, want_unfold)
    for g, (h, c) in enumerate(((f["p"], f["cp"]), (f["q"], f["cq"]))):
        conv = consts_from_jax(_np_dict(c.device_consts()))
        vals = _ints(trns.rns_to_limbs(res[g], conv))
        for ct, v in zip(f["cts"], vals):
            assert v % (h * h) == pow(ct % (h * h), f["exps"][g], h * h)
            assert v <= 2 * h * h


def test_rns_modexp2f_ragged_batch(crt_fold):
    f = crt_fold
    got = cuda_rns2.rns_modexp2f(_t(f["x"][:19]), _t(f["wins"]), f["tkc2"])
    assert _eq(got, f["want"][:19])


def test_rns_modexp2f_rejects_wrong_inputs(crt_fold):
    g = crt_fold
    with pytest.raises(TypeError):
        cuda_rns2.rns_modexp2f(_t(g["x"]).to(torch.int64), _t(g["wins"]), g["tkc2"])
    with pytest.raises(ValueError):
        cuda_rns2.rns_modexp2f(_t(g["x"][:, :-1]), _t(g["wins"]), g["tkc2"])
    with pytest.raises(ValueError):  # constants that are not folded
        not_folded = {k: v for k, v in g["tkc2"].items() if k != "maskB"}
        cuda_rns2.rns_modexp2f(_t(g["x"]), _t(g["wins"]), not_folded)


def test_fb_wrappers_reject_wrong_inputs(fb256):
    f = fb256
    with pytest.raises(ValueError):
        cuda_rns2.fb_table2(_t(f["gA"]).transpose(1, 2), _t(f["gB"]), f["tkc"])
    with pytest.raises(TypeError):
        cuda_rns2.fb_modexp2(
            torch.zeros((8, 256, 2 * f["c"].k + 1), dtype=torch.int32),
            torch.zeros((1, 4, 8), dtype=torch.int32), f["tkc"],
        )
    # the fixed-base kernels run ONE residue system; a stacked pair (which
    # the generic modexp kernel takes, and the pack holds per group) is refused
    pair = {k: torch.cat([v, v]) for k, v in f["tkc"].items()}
    with pytest.raises(ValueError):
        cuda_rns2.fb_table2(_t(f["gA"]), _t(f["gB"]), pair)
    pack = cuda_rns2._kernel_pack(pair)
    assert pack["G"] == 2 and pack["rowc"].shape[0] == 2
    assert torch.equal(pack["rowc"][0], pack["rowc"][1])
    assert torch.equal(pack["rowc"][0], cuda_rns2._kernel_pack(f["tkc"])["rowc"][0])


# ---------------------------------------------------------------------------
# K4: grouped CIOS modular product
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mm_pair():
    rng = random.Random(99)
    n1 = rng.getrandbits(128) | (1 << 127) | 1
    n2 = rng.getrandbits(128) | (1 << 127) | 1
    c1, c2 = jmg.MontConstants.create(n1), jmg.MontConstants.create(n2)
    return rng, (n1, n2), (c1, c2)


def test_mod_mul_grouped_matches_pallas_and_ints(mm_pair):
    rng, ns, cs = mm_pair
    L = cs[0].num_limbs
    a_i = [[rng.randrange(m) for _ in range(B - 2)] + [0, m - 1] for m in ns]
    b_i = [rng.randrange(m) for m in ns]  # one shared multiplier per group
    a = np.stack([lb.ints_to_limbs(x, L) for x in a_i])  # [2, B, L]
    b = np.stack([lb.ints_to_limbs([x], L) for x in b_i])  # [2, 1, L]
    n = np.stack([c.n_limbs for c in cs])
    n0 = np.array([c.n0inv for c in cs], np.uint32)
    r2 = np.stack([c.r2_limbs for c in cs])
    want = pallas_mod_mul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(n), jnp.asarray(n0),
        jnp.asarray(r2), interpret=True,
    )
    got = cuda_modexp.mod_mul(_t(a), _t(b), _t(n), _t(n0), _t(r2))
    assert got.dtype == torch.int32 and _eq(got, want)
    for g, m in enumerate(ns):
        assert _ints(got[g]) == [x * b_i[g] % m for x in a_i[g]]


def test_mod_mul_single_matches_pallas_and_ints(mm_pair):
    rng, ns, cs = mm_pair
    m, c = ns[1], cs[1]
    L = c.num_limbs
    a_i = [rng.randrange(m) for _ in range(B)]
    b_i = rng.randrange(m)
    a = lb.ints_to_limbs(a_i, L)[None]  # [1, B, L]
    b = lb.int_to_limbs(b_i, L)  # [L], broadcast over the batch
    n, r2 = c.n_limbs[None], c.r2_limbs[None]
    n0 = np.array([c.n0inv], np.uint32)
    want = pallas_mod_mul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(n), jnp.asarray(n0),
        jnp.asarray(r2), interpret=True,
    )
    got = cuda_modexp.mod_mul(_t(a), _t(b), _t(n), _t(n0), _t(r2))
    assert _eq(got, want)
    assert _ints(got[0]) == [x * b_i % m for x in a_i]
    # a ragged batch gives the same rows
    part = cuda_modexp.mod_mul(_t(a[:, :50]), _t(b), _t(n), _t(n0), _t(r2))
    assert torch.equal(part, got[:, :50])


def test_mod_mul_rejects_wrong_inputs(mm_pair):
    _, _, cs = mm_pair
    L = cs[0].num_limbs
    a = torch.zeros((1, 4, L), dtype=torch.int32)
    n, r2 = _t(cs[0].n_limbs[None]), _t(cs[0].r2_limbs[None])
    n0 = _t(np.array([cs[0].n0inv]))
    with pytest.raises(TypeError):
        cuda_modexp.mod_mul(a.to(torch.int64), a, n, n0, r2)
    with pytest.raises(ValueError):
        cuda_modexp.mod_mul(a, a, n[:, :-1], n0, r2)
    with pytest.raises(ValueError):
        cuda_modexp.mod_mul(a[0], a, n, n0, r2)


def test_launch_counters_untouched_on_cpu(fb256, fb_exps):
    """The plain route launches nothing and counts nothing."""
    before = dict(cuda_rns2.LAUNCHES), dict(cuda_modexp.LAUNCHES)
    f = fb256
    cuda_rns2.fb_table2(_t(f["gA"]), _t(f["gB"]), f["tkc"])
    assert (dict(cuda_rns2.LAUNCHES), dict(cuda_modexp.LAUNCHES)) == before
    assert set(cuda_rns2.LAUNCHES) == {
        "fb_table2", "fb_modexp2", "rns_modexp2f", "rns_modexp2"
    }
    assert set(cuda_modexp.LAUNCHES) == {"mod_mul", "modexp", "mont_raw"}
