"""The port's CUDA kernels on a GPU, at small shapes: each kernel against its
plain PyTorch version on the same CUDA tensors (tolerance: exact equality),
ragged batches, and the public API on ``device="cuda"``: encrypt -> decrypt
and the homomorphic chain.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are compiled at
first use) and skip without one.  The file imports nothing of JAX, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts="" -m cuda

``chip_smoke.py`` makes the same comparison at the full 2048- and 4096-bit
shapes.
"""

import random

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu_torch as ptorch
from pailliercryptolib_tpu_torch.models.keygen import get_prime
from pailliercryptolib_tpu_torch.ops import cuda_modexp, cuda_probes, cuda_rns2
from pailliercryptolib_tpu_torch.ops import limbs as lb
from pailliercryptolib_tpu_torch.ops.montgomery import (
    MontConstants,
    canonicalize,
    cond_sub_n,
    to_i32,
)
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


# -- the tensor-core forms of K3 and K2 (csrc/rns_mont_mul_tc.cuh) ------------


def _folded_set(pbits, dev):
    p, q, in_limbs, ctxs = _crt_ctxs(pbits)
    kc2 = cuda_rns2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True, device=dev)
    ewbits = max(8, -(-lb.num_windows(pbits) // 8) * 8) * 4
    wins = to_i32(np.concatenate([lb.ints_to_windows([p - 1], ewbits),
                                  lb.ints_to_windows([q - 1], ewbits)]), dev)
    return kc2, in_limbs, wins


@pytest.fixture(scope="module")
def folded256(dev):
    return _folded_set(256, dev)


@pytest.mark.parametrize("B", [1, 7, 65, 300, 2048])
def test_tc_folded_modexp_equal_plain(dev, folded256, B):
    """K3 on tensor cores: batches within one cluster's 72 rows and across
    many clusters."""
    kc2, in_limbs, wins = folded256
    x = to_i32(np.random.default_rng(B).integers(0, 1 << 15, (B, in_limbs)), dev)
    before = cuda_rns2.LAUNCHES["rns_modexp2f"]
    got = cuda_rns2.rns_modexp2f(x, wins, kc2)
    assert cuda_rns2.LAUNCHES["rns_modexp2f"] == before + 1
    want = cuda_rns2.rns_modexp2f_plain(x, wins, kc2)
    assert got.is_cuda and torch.equal(got, want)


@pytest.fixture(scope="module")
def fixed_base1024(dev):
    r = np.random.default_rng(1024)
    N = random.Random(1024).getrandbits(1024) | (1 << 1023) | 1
    kc = cuda_rns2.stack_group_consts2([RNSContext.create(N)], device=dev)
    NP = 8
    gA = _residues(r, kc["modsA"][0], NP, dev)[None]
    gB = _residues(r, kc["modsBx"][0], NP, dev)[None]
    tabs = cuda_rns2.fb_table2(gA, gB, kc)
    return kc, cuda_rns2.fb_gather_table(*tabs), NP


@pytest.mark.parametrize("mont_out", [False, True])
@pytest.mark.parametrize("B", [1, 7, 65, 300, 2048])
def test_tc_fixed_base_modexp_equal_plain(dev, fixed_base1024, B, mont_out):
    kc, tab, NP = fixed_base1024
    assert cuda_rns2._kernel_pack(kc)["W"] <= cuda_rns2.TC_MAX_W
    wins = torch.from_numpy(
        np.random.default_rng(B).integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    before = cuda_rns2.LAUNCHES["fb_modexp2"]
    got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=mont_out)
    assert cuda_rns2.LAUNCHES["fb_modexp2"] == before + 1
    want = cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=mont_out)
    assert got.is_cuda and torch.equal(got, want)


def _wide_set(dev):
    """A one-system set beyond 320 lanes: a 4600-bit modulus, 352 lanes
    (integer Barrett), which the wide tensor-core layout pads to 384."""
    N = random.Random(4600).getrandbits(4600) | (1 << 4599) | 1
    kc = cuda_rns2.stack_group_consts2([RNSContext.create(N)], device=dev)
    assert cuda_rns2._kernel_pack(kc)["W"] == 352
    return kc


def test_wider_set_runs_the_tensor_core_fixed_base_modexp(dev):
    """A one-system set beyond 320 lanes runs the tensor-core K2 in the wide
    layout (a cluster of eight at 384 lanes), equal to the plain version, in
    both output forms."""
    r = np.random.default_rng(4600)
    kc = _wide_set(dev)
    tcp = cuda_rns2._tc_pack(kc, "fb_modexp2")
    assert (tcp["cluster"], tcp["mt"], tcp["W"]) == (8, 9, 384)
    NP, B = 2, 37
    gA = _residues(r, kc["modsA"][0], NP, dev)[None]
    gB = _residues(r, kc["modsBx"][0], NP, dev)[None]
    tabs = cuda_rns2.fb_table2(gA, gB, kc)
    tab = cuda_rns2.fb_gather_table(*tabs)
    wins = torch.from_numpy(r.integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    for mont_out in (False, True):
        before = cuda_rns2.LAUNCHES["fb_modexp2"]
        got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=mont_out)
        assert cuda_rns2.LAUNCHES["fb_modexp2"] == before + 1
        want = cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=mont_out)
        assert got.is_cuda and torch.equal(got, want)


@pytest.mark.parametrize("width", [1024, 4600])
def test_tc_fixed_base_table_equal_plain(dev, width):
    """K1 on tensor cores: the n^2 set of a 512-bit key (a 1024-bit modulus,
    the narrow K1 layout) and the 352-lane set (the wide one at 384 lanes),
    ragged row counts."""
    r = np.random.default_rng(width)
    if width == 4600:
        kc = _wide_set(dev)
    else:
        N = random.Random(width).getrandbits(width) | (1 << (width - 1)) | 1
        kc = cuda_rns2.stack_group_consts2([RNSContext.create(N)], device=dev)
    layout = cuda_rns2.TC_LAYOUTS["k1_wide" if width == 4600 else "k1_narrow"]
    tcp = cuda_rns2._tc_pack(kc, "fb_table2")
    assert (tcp["cluster"], tcp["mt"]) == layout[:2]
    NP = 11
    gA = _residues(r, kc["modsA"][0], NP, dev)[None]
    gB = _residues(r, kc["modsBx"][0], NP, dev)[None]
    before = cuda_rns2.LAUNCHES["fb_table2"]
    tabA, tabB = cuda_rns2.fb_table2(gA, gB, kc)
    assert cuda_rns2.LAUNCHES["fb_table2"] == before + 1
    pA, pB = cuda_rns2.fb_table2_plain(gA, gB, kc)
    assert tabA.is_cuda and torch.equal(tabA, pA) and torch.equal(tabB, pB)


@pytest.mark.parametrize("form", ["tc", "unsplit"])
@pytest.mark.parametrize("ext", [True, False])
def test_product_probe_equal_plain(dev, folded256, form, ext):
    """P5: the product alone, in K3's two halves and in one, with and
    without its extensions."""
    kc2 = folded256[0]
    r = np.random.default_rng(5)
    B = 70
    x = torch.cat([_residues(r, kc2["modsA"][0], B, dev),
                   _residues(r, kc2["modsBx"][0], B, dev)], dim=1)
    got = cuda_probes.mont_chain(x, kc2, 3, form=form, ext=ext)
    assert torch.equal(got, cuda_probes.mont_chain_plain(x, kc2, 3, ext=ext))


def _crt_ctxs(pbits):
    p, q = sorted((get_prime(pbits), get_prime(pbits)))
    in_limbs = 2 * lb.limbs_for_bits(2 * pbits)
    bits = 2 * pbits + lb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [
        RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
        for h in (p, q)
    ]
    return p, q, in_limbs, ctxs


@pytest.mark.parametrize("form", ["shared", "var", "grouped"])
@pytest.mark.parametrize("bits,B", [(256, 19), (1024, 130)])
def test_generic_modexp_kernel_equal_plain(dev, form, bits, B):
    """K5 in its three forms: one shared exponent, per-row exponents (both
    integer-Barrett over one modulus), and the stacked f32 p^2/q^2 pair with
    one base copy read by both groups."""
    rng = random.Random(bits)
    r = np.random.default_rng(bits)
    ebits = 32
    if form == "grouped":
        p, q, L, ctxs = _crt_ctxs(bits // 2)
        kc = cuda_rns2.stack_group_consts2(ctxs, f32_mu=True, device=dev)
        exps = [p - 1, q - 1]
        ebits = max(8, -(-lb.num_windows(bits // 2) // 8) * 8) * 4
    else:
        N = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        ctx = RNSContext.create(N)
        kc = cuda_rns2.stack_group_consts2([ctx], device=dev)
        L = ctx.Lin
        exps = [rng.getrandbits(ebits) for _ in range(B if form == "var" else 1)]
    x = to_i32(r.integers(0, 1 << 15, (1, B, L)), dev)
    wins = to_i32(lb.ints_to_windows(exps, ebits), dev)
    shared = form != "var"
    if not shared:
        wins = wins[None].contiguous()
    before = cuda_rns2.LAUNCHES["rns_modexp2"]
    got = cuda_rns2.rns_modexp2(x, wins, kc, shared=shared)
    want = cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=shared)
    assert got.is_cuda and got.shape == want.shape and torch.equal(got, want)
    assert cuda_rns2.LAUNCHES["rns_modexp2"] == before + 1
    if form == "grouped":  # one copy per group gives the same
        both = cuda_rns2.rns_modexp2(x.expand(2, -1, -1).contiguous(), wins, kc,
                                     shared=True)
        assert torch.equal(both, got)


_TC_K5 = [("shared", 2048), ("var", 2048), ("grouped", 2048), ("shared", 640),
          ("var", 640)]


@pytest.mark.parametrize("form,width", _TC_K5)
def test_tc_generic_modexp_equal_plain(dev, form, width):
    """K5 on tensor cores at the main paths' widths: the n^2 set of a
    2048-bit key (320 lanes, integer Barrett; shared and per-row windows),
    its stacked p^2 / q^2 pair (grouped, f32 lean: a cluster of two) and the n^2 set of a
    4096-bit key (640 lanes, f32 full fold: the cluster of eight).  Ragged
    batches, short exponents; the CUDA-core form computes the same."""
    rng = random.Random(width)
    r = np.random.default_rng(width)
    B, ebits = (2048, 32) if width == 2048 else (300, 16)
    if form == "grouped":
        p, q, L, ctxs = _crt_ctxs(1024)
        kc = cuda_rns2.stack_group_consts2(ctxs, f32_mu=True, device=dev)
        exps = [p - 1, q - 1]
        ebits = max(8, -(-lb.num_windows(1024) // 8) * 8) * 4
    else:
        bits = 4096 if width == 2048 else 8192
        ctx = RNSContext.create(rng.getrandbits(bits) | (1 << (bits - 1)) | 1)
        kc = cuda_rns2.stack_group_consts2([ctx], device=dev)
        L = ctx.Lin
        exps = [rng.getrandbits(ebits) for _ in range(B if form == "var" else 1)]
    tcp = cuda_rns2._tc_pack(kc, "rns_modexp2")
    if form == "grouped":  # two 160-lane sets: the small layout
        assert (tcp["G"], tcp["W"], tcp["cluster"]) == (2, 160, 2)
    else:
        assert (tcp["W"], tcp["cluster"]) == {2048: (320, 4), 640: (640, 8)}[width]
    x = to_i32(r.integers(0, 1 << 15, (1, B, L)), dev)
    wins = to_i32(lb.ints_to_windows(exps, ebits), dev)
    shared = form != "var"
    if not shared:
        wins = wins[None].contiguous()
    before = cuda_rns2.LAUNCHES["rns_modexp2"]
    got = cuda_rns2.rns_modexp2(x, wins, kc, shared=shared)
    assert cuda_rns2.LAUNCHES["rns_modexp2"] == before + 1
    want = cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=shared)
    assert got.is_cuda and torch.equal(got, want)


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


def _mont_group(rng, bits, G, dev):
    """G odd moduli of ``bits`` bits and their stacked Montgomery constants."""
    ns = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(G)]
    cs = [MontConstants.create(n) for n in ns]
    stack = lambda f: to_i32(np.stack([f(c) for c in cs]), dev)  # noqa: E731
    return ns, cs[0].num_limbs, dict(
        n=stack(lambda c: c.n_limbs), r2=stack(lambda c: c.r2_limbs),
        one=stack(lambda c: c.one_limbs),
        n0=to_i32(np.array([c.n0inv for c in cs]), dev),
    )


@pytest.mark.parametrize("bits,G,B", [(128, 1, 5), (1024, 2, 70), (8190, 1, 3)])
def test_cios_modexp_kernel_equal_plain_and_pow(dev, bits, G, B):
    """K6 with per-row exponents (0 and 1 among them), with one shared
    exponent, and with one shared base, against the plain version and
    pow(); 8190 bits is the widest operand the kernel takes (547 limbs)."""
    rng = random.Random(bits)
    ns, L, c = _mont_group(rng, bits, G, dev)
    ebits = 32
    bases = [[rng.randrange(n) for _ in range(B)] for n in ns]
    exps = [[rng.getrandbits(ebits) for _ in range(B - 2)] + [0, 1] for _ in ns]
    base = to_i32(np.stack([lb.ints_to_limbs(b, L) for b in bases]), dev)
    wins = to_i32(np.stack([lb.ints_to_windows(e, ebits) for e in exps]), dev)
    before = cuda_modexp.LAUNCHES["modexp"]
    args = (c["n"], c["n0"], c["r2"], c["one"])
    got = cuda_modexp.modexp(base, wins, *args)
    assert got.is_cuda and torch.equal(got, cuda_modexp.modexp_plain(base, wins, *args))
    for g, n in enumerate(ns):
        assert lb.limbs_to_ints(got[g].cpu().numpy().astype(np.uint32)) == [
            pow(b, e, n) for b, e in zip(bases[g], exps[g])
        ]
    shared_w = cuda_modexp.modexp(base, wins[:, :1], *args)  # one exponent a group
    assert torch.equal(shared_w, cuda_modexp.modexp_plain(base, wins[:, :1], *args))
    shared_b = cuda_modexp.modexp(base[:, :1], wins, *args)  # one base a group
    assert shared_b.shape == got.shape
    assert torch.equal(shared_b, cuda_modexp.modexp_plain(base[:, :1], wins, *args))
    assert cuda_modexp.LAUNCHES["modexp"] == before + 3


def _top_consts(rng, L, dev):
    """Two moduli of exactly L limbs at the top of the range (the second
    2^(15 L) - 1) and their 15-bit constants at L limbs."""
    top = (1 << (15 * L)) - 1
    ns = [top - 2 * rng.getrandbits(max(1, 15 * L - 8)), top]
    R = 1 << (15 * L)
    stack = lambda vals: to_i32(np.stack([lb.ints_to_limbs([v], L)[0] for v in vals]), dev)  # noqa: E731
    return ns, (stack(ns), to_i32(np.array([(-pow(n, -1, 1 << 15)) & 0x7FFF for n in ns]), dev),
                stack([R * R % n for n in ns]), stack([R % n for n in ns]))


def _limb_value(row):
    return sum(int(d) << (15 * i) for i, d in enumerate(row))


# both sides of every boundary of the 32-bit kernels' dispatch over words a
# lane, and its ends
_LANE_WIDTHS = sorted({1, cuda_modexp.KERNEL_MAX_L} | {
    L + d for L in range(1, cuda_modexp.KERNEL_MAX_L) for d in (0, 1)
    if cuda_modexp.lane_words_for(L) != cuda_modexp.lane_words_for(L + 1)})


@pytest.mark.parametrize("L", _LANE_WIDTHS)
def test_cios_modexp_w32_at_every_lane_width(dev, L):
    """K6 on both sides of every words-a-lane boundary of its dispatch, at
    the edges of its input range: two groups whose moduli have exactly L
    limbs (the second 2^(15 L) - 1), bases below R = 2^(15 L) with digits of
    2^15, equal to n and above it, exponents 0 and 1, all-zero windows and
    no windows; against pow()."""
    rng = random.Random(L)
    ns, args = _top_consts(rng, L, dev)
    R = 1 << (15 * L)
    rows = []
    for n in ns:
        red = [rng.choice((1 << 15, rng.getrandbits(15))) for _ in range(L - 1)] + [0]
        rows.append([red if L > 1 else [rng.getrandbits(15)],
                     lb.ints_to_limbs([n], L)[0].tolist(),
                     lb.ints_to_limbs([R - 1], L)[0].tolist(),
                     lb.ints_to_limbs([rng.randrange(n)], L)[0].tolist()])
    base = to_i32(np.array(rows), dev)
    exps = [[rng.getrandbits(8), 0, 1, rng.getrandbits(8)] for _ in ns]
    wins = to_i32(np.stack([lb.ints_to_windows(e, 8) for e in exps]), dev)
    got = cuda_modexp.modexp(base, wins, *args)
    for g, n in enumerate(ns):
        assert [_limb_value(r) for r in got[g].tolist()] == [
            pow(_limb_value(b), e, n) for b, e in zip(rows[g], exps[g])]
    for nw in (2, 0):  # all-zero windows, no windows: 1 mod n
        ones = cuda_modexp.modexp(base, torch.zeros((2, 1, nw), dtype=torch.int32,
                                                    device=dev), *args)
        assert all(_limb_value(r) == 1 for g in range(2) for r in ones[g].tolist())


def test_cios_modexp_w32_shared_base_over_2048_rows(dev):
    """One base read through stride 0 by 2048 rows (the DJN encrypt's hs),
    against the same base copied to every row and against pow()."""
    rng = random.Random(2048)
    ns, L, c = _mont_group(rng, 4096, 1, dev)
    args = (c["n"], c["n0"], c["r2"], c["one"])
    b = rng.randrange(ns[0])
    exps = [rng.getrandbits(16) for _ in range(2048)]
    base = to_i32(lb.ints_to_limbs([b], L)[None], dev)
    wins = to_i32(lb.ints_to_windows(exps, 16)[None], dev)
    got = cuda_modexp.modexp(base, wins, *args)
    assert torch.equal(got, cuda_modexp.modexp(base.expand(1, 2048, L).contiguous(), wins,
                                               *args))
    sample = range(0, 2048, 97)
    assert [_limb_value(got[0, i].tolist()) for i in sample] == [
        pow(b, exps[i], ns[0]) for i in sample]


@pytest.mark.parametrize("bits,G,B", [(128, 1, 5), (1024, 2, 70), (8190, 1, 3)])
def test_cios_mont_raw_and_wide_mod_mul_equal_plain(dev, bits, G, B):
    """K7, the canonical value of the plain version's output; and K4 at
    widths beyond the decrypt tails', with a shared and a per-row
    multiplier."""
    rng = random.Random(bits + 1)
    r = np.random.default_rng(bits)
    ns, L, c = _mont_group(rng, bits, G, dev)
    a = to_i32(np.stack([lb.ints_to_limbs([rng.randrange(n) for _ in range(B)], L)
                         for n in ns]), dev)
    b_row = to_i32(np.stack([lb.ints_to_limbs([rng.randrange(n) for _ in range(B)], L)
                             for n in ns]), dev)
    b_one = b_row[:, :1]
    # redundant digits (<= 2**15, value below R) are part of K7's contract
    a_red = to_i32(r.integers(0, (1 << 15) + 1, (G, B, L)), dev)
    a_red[..., -1] = 0
    before = dict(cuda_modexp.LAUNCHES)
    for x, y in ((a, b_row), (a, b_one), (a_red, b_one)):
        want = cuda_modexp.mont_raw_plain(x, y, c["n"], c["n0"])
        got = cuda_modexp.mont_raw(x, y, c["n"], c["n0"])
        assert got.is_cuda
        assert torch.equal(got, cond_sub_n(canonicalize(want), c["n"][:, None, :]))
    for y in (b_row, b_one):
        got = cuda_modexp.mod_mul(a, y, c["n"], c["n0"], c["r2"])
        assert torch.equal(got, cuda_modexp.mod_mul_plain(a, y, c["n"], c["n0"], c["r2"]))
    made = {k: cuda_modexp.LAUNCHES[k] - before[k] for k in before}
    assert made == {"mod_mul": 2, "modexp": 0, "mont_raw": 3}
    if bits == 8190:  # one limb more than the kernels take: refused, not served
        wide = torch.zeros((1, 2, cuda_modexp.KERNEL_MAX_L + 1), dtype=torch.int32,
                           device=dev)
        for call in (lambda: cuda_modexp.mod_mul(wide, wide, wide[0, :1], c["n0"],
                                                 wide[0, :1]),
                     lambda: cuda_modexp.mont_raw(wide, wide, wide[0, :1], c["n0"])):
            with pytest.raises(NotImplementedError):
                call()


@pytest.mark.parametrize("L", _LANE_WIDTHS)
def test_cios_mod_mul_and_mont_raw_w32_at_every_lane_width(dev, L):
    """The 32-bit K4 and K7 on both sides of every words-a-lane boundary of
    their dispatch, in two groups and in one, on 37 rows (not a whole number
    of blocks): a with redundant digits, a = 0, n - 1, R - 1; b per row,
    shared (stride 0) and r2; against Python ints, and against the plain
    versions in group 0, whose modulus meets the 15-bit form's 4n < R (group
    1's is 2^(15 L) - 1, the largest L limbs hold, which the 32-bit forms
    take: 4n < 2^(32 L32))."""
    rng = random.Random(L + 547)
    R, B = 1 << (15 * L), 37
    ns = [rng.getrandbits(15 * L - 2) | 1 << (15 * L - 3) | 1, R - 1]
    stack = lambda vals: to_i32(np.stack([lb.ints_to_limbs([v], L)[0] for v in vals]), dev)  # noqa: E731
    n, r2 = stack(ns), stack([R * R % m for m in ns])
    n0 = to_i32(np.array([(-pow(m, -1, 1 << 15)) & 0x7FFF for m in ns]), dev)
    rows = []
    for m in ns:
        red = [rng.choice((1 << 15, rng.getrandbits(15))) for _ in range(L - 1)] + [0]
        vals = [0, m - 1, R - 1] + [rng.randrange(m) for _ in range(B - 4)]
        rows.append([red if L > 1 else [rng.getrandbits(15)]]
                    + [lb.ints_to_limbs([v], L)[0].tolist() for v in vals])
    a = to_i32(np.array(rows), dev)
    b_row = to_i32(np.stack([lb.ints_to_limbs([rng.randrange(m) for _ in range(B)], L)
                             for m in ns]), dev)
    for G in (2, 1):
        ag, cg = a[:G], (n[:G], n0[:G], r2[:G])
        for b in (b_row[:G], b_row[:G, 5:6], r2[:G, None, :]):
            got = cuda_modexp.mod_mul(ag, b, *cg)
            raw = cuda_modexp.mont_raw(ag, b, *cg[:2])
            assert torch.equal(got[0], cuda_modexp.mod_mul_plain(ag, b, *cg)[0])
            want = cuda_modexp.mont_raw_plain(ag, b, *cg[:2])
            assert torch.equal(raw[0], cond_sub_n(canonicalize(want), cg[0][:, None, :])[0])
            be = b.expand(ag.shape)
            for g, m in enumerate(ns[:G]):
                av = [_limb_value(x) for x in rows[g]]
                bv = [_limb_value(x) for x in be[g].tolist()]
                assert [_limb_value(x) for x in got[g].tolist()] == [
                    x * y % m for x, y in zip(av, bv)]
                rinv = pow(R, -1, m)
                assert [_limb_value(x) for x in raw[g].tolist()] == [
                    x * y * rinv % m for x, y in zip(av, bv)]
                assert int(got[g].max()) < 1 << 15 and int(raw[g].max()) < 1 << 15


@pytest.mark.parametrize("bits", [2048, 4096])
def test_cios_crt_decrypt_equals_rns_and_pow(dev, bits):
    """The CRT decrypt on ``"cios"`` (K7 fold, K6, K4 tail, all in their
    32-bit form) against the one on ``"rns"`` and against Python ints, on
    ciphertexts made with pow() (normal mode, injected r)."""
    key = ptorch.generate_keypair(bits, enable_DJN=False)
    pk, sk = key.pub_key, key.priv_key
    rng = random.Random(bits)
    n, n2 = pk.n, pk.nsquare
    vals = [rng.getrandbits(64) for _ in range(11)] + [0, n - 1]
    ct = ptorch.CipherText(pk, [(n * m + 1) * pow(rng.randrange(1, n), n, n2) % n2
                                for m in vals])
    assert sk._engine.backend == "rns"
    want = sk.decrypt(ct).texts
    sk._engine.backend = "cios"
    before = dict(cuda_modexp.LAUNCHES)
    got = sk.decrypt(ct).texts
    made = {k: cuda_modexp.LAUNCHES[k] - before[k] for k in before}
    assert made == {"mod_mul": 2, "modexp": 1, "mont_raw": 1}
    assert got == want == vals


def test_cios_backend_on_gpu(dev):
    """A 512-bit round trip and the homomorphic chain on the ``"cios"``
    backend through the public API, against the ``"rns"`` backend's
    ciphertexts for the same injected r; modexp on the card."""
    from pailliercryptolib_tpu_torch.convert import keys_from_ints

    key = ptorch.generate_keypair(512, enable_DJN=True)  # device="cuda", rns
    pk, sk = key.pub_key, key.priv_key
    twin = keys_from_ints(pk.n, sk.p, sk.q, pk.hs, pk.randbits)
    cpk, csk = twin.pub_key, twin.priv_key
    cpk._engine.backend = csk._engine.backend = "cios"
    rng = random.Random(3)
    B = 45
    vals = [rng.getrandbits(64) for _ in range(B)]
    rs = [rng.getrandbits(pk.randbits) for _ in range(B)]
    pk.set_random(rs)
    cpk.set_random(rs)
    launches = cuda_modexp.LAUNCHES
    before = dict(launches)
    ct = cpk.encrypt(ptorch.PlainText(vals))
    assert launches["modexp"] == before["modexp"] + 1
    assert launches["mod_mul"] == before["mod_mul"] + 1
    assert ct.device_payload().arr.is_cuda
    assert ct.texts == pk.encrypt(ptorch.PlainText(vals)).texts
    out = cpk.apply_obfuscator((ct + ct) * ptorch.PlainText([3]))
    want = [6 * v % pk.n for v in vals]
    before = dict(launches)
    assert csk.decrypt(out).texts == want
    assert launches["mont_raw"] == before["mont_raw"] + 1
    assert launches["modexp"] == before["modexp"] + 1
    assert launches["mod_mul"] == before["mod_mul"] + 2
    csk.enable_crt = False
    assert csk.decrypt(out).texts == want  # RAW
    assert sk.decrypt(out).texts == want  # the rns engine reads cios ciphertexts
    assert cpk._engine._secondary is None and csk._engine._secondary is None
    m = rng.getrandbits(1024) | (1 << 1023) | 1
    bs = [rng.randrange(m) for _ in range(9)]
    es = [rng.getrandbits(100) for _ in range(9)]
    assert ptorch.modexp(bs, es, m) == [pow(b, e, m) for b, e in zip(bs, es)]


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


def test_homomorphic_chain_on_gpu(dev):
    """Normal-mode encrypt -> CT+CT -> CT+PT -> CT*PT (per-row and scalar) ->
    apply_obfuscator -> CRT, RAW and grouped-CRT decrypt on a non-DJN key,
    with the launches each step makes; then the DJN obfuscator and an
    oversized injected r."""
    key = ptorch.generate_keypair(512, enable_DJN=False)  # device="cuda"
    pk, sk = key.pub_key, key.priv_key
    n, n2 = pk.n, pk.nsquare
    rng = random.Random(2)
    B = 45
    a = [rng.getrandbits(64) for _ in range(B)]
    b = [rng.getrandbits(64) for _ in range(B)]
    e = [rng.getrandbits(64) for _ in range(B)]
    forms = cuda_rns2.MODEXP2_FORMS
    before = dict(forms)
    ca, cb = pk.encrypt(ptorch.PlainText(a)), pk.encrypt(ptorch.PlainText(b))
    ct = ((ca + cb + ptorch.PlainText([5])) * ptorch.PlainText(e)) * ptorch.PlainText([3])
    ct = pk.apply_obfuscator(ct)
    assert ct.device_payload().arr.is_cuda and ct._texts is None
    assert forms["shared"] == before["shared"] + 4 and forms["var"] == before["var"] + 1
    want = [((x + y + 5) * z * 3) % n for x, y, z in zip(a, b, e)]
    assert sk.decrypt(ct).texts == want
    sk.enable_crt = False
    assert sk.decrypt(ct).texts == want  # RAW
    sk.enable_crt = True
    assert forms["shared"] == before["shared"] + 5
    grouped = sk._engine._decrypt_crt_impl(ct.device_payload(), grouped=True)
    assert grouped.fetch() == want and forms["grouped"] == before["grouped"] + 1
    rs = [rng.randrange(1, n) for _ in range(3)]
    pk.set_random(rs)
    got = pk.encrypt(ptorch.PlainText(a[:3])).texts
    assert got == [(n * m + 1) * pow(r, n, n2) % n2 for m, r in zip(a, rs)]
    # DJN key: re-obfuscation through the fixed-base kernel, oversized r
    dkey = ptorch.generate_keypair(512, enable_DJN=True)
    dpk, dsk = dkey.pub_key, dkey.priv_key
    c = dpk.encrypt(ptorch.PlainText(a))
    o = dpk.apply_obfuscator(c)
    assert o.texts != c.texts and dsk.decrypt(o).texts == a
    big = [rng.getrandbits(dpk.randbits + 40) for _ in range(3)]
    dpk.set_random(big)
    got = dpk.apply_obfuscator(ptorch.CipherText(dpk, c.texts[:3])).texts
    assert got == [x * pow(dpk.hs, r, dpk.nsquare) % dpk.nsquare
                   for x, r in zip(c.texts, big)]


# ---------------------------------------------------------------------------
# constant sets beyond 320 lanes, the probes, wide keys
# ---------------------------------------------------------------------------

_WIDE_FORMS = {
    # form -> (modulus bits, f32_mu asked, expected (f32, lean, W))
    "int_wide": (5000, False, (False, False, 384)),
    "f32_lean_wide": (4312, True, (True, True, 352)),
    "f32_full_480": (6143, False, (True, False, 480)),
    "f32_full_640": (8191, False, (True, False, 640)),
}


@pytest.mark.parametrize("form", sorted(_WIDE_FORMS))
def test_wide_forms_equal_plain(dev, form):
    """K1, K2 and K5 (shared and per-row) on one-system constant sets of
    more than 320 lanes, in every compiled form: integer Barrett beyond
    320 lanes, f32 lean at the 320-lane edge, and the f32 full fold of
    wide-pool moduli (n^2 of 3072- and 4096-bit keys)."""
    bits, f32_mu, want_form = _WIDE_FORMS[form]
    rng = random.Random(bits)
    r = np.random.default_rng(bits)
    N = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    ctx = RNSContext.create(N)
    kc = cuda_rns2.stack_group_consts2([ctx], f32_mu=f32_mu, device=dev)
    p = cuda_rns2._kernel_pack(kc)
    assert (p["f32"], p["lean"], p["W"]) == want_form
    NP, B = 8, 11
    gA = _residues(r, kc["modsA"][0], NP, dev)[None]
    gB = _residues(r, kc["modsBx"][0], NP, dev)[None]
    tabA, tabB = cuda_rns2.fb_table2(gA, gB, kc)
    pA, pB = cuda_rns2.fb_table2_plain(gA, gB, kc)
    assert torch.equal(tabA, pA) and torch.equal(tabB, pB)
    tab = cuda_rns2.fb_gather_table(tabA, tabB)
    wins = torch.from_numpy(r.integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    for mont_out in (False, True):
        got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=mont_out)
        assert torch.equal(got, cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=mont_out))
    x = to_i32(r.integers(0, 1 << 15, (1, B, ctx.Lin)), dev)
    for shared in (True, False):
        exps = [rng.getrandbits(32) for _ in range(1 if shared else B)]
        w = to_i32(lb.ints_to_windows(exps, 32), dev)
        w = w if shared else w[None].contiguous()
        got = cuda_rns2.rns_modexp2(x, w, kc, shared=shared)
        assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, w, kc, shared=shared))


def test_grouped_modexp_at_4096_bit_crt_width(dev):
    """K5 grouped over a stacked f32 pair of 4096-bit moduli fed 548 input
    limbs (the CRT decrypt of a 4096-bit key), and the limits the wrappers
    refuse."""
    rng = random.Random(5)
    r = np.random.default_rng(5)
    hs = [rng.getrandbits(2048) | (1 << 2047) | 1 for _ in range(2)]
    in_limbs = 2 * lb.limbs_for_bits(4096)
    bits = 4096 + lb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits) for h in hs]
    kc = cuda_rns2.stack_group_consts2(ctxs, f32_mu=True, device=dev)
    p = cuda_rns2._kernel_pack(kc)
    assert in_limbs == 548 and (p["f32"], p["lean"], p["W"], p["G"]) == (True, True, 320, 2)
    B = 13
    x = to_i32(r.integers(0, 1 << 15, (1, B, in_limbs)), dev)
    wins = to_i32(lb.ints_to_windows([rng.getrandbits(32), rng.getrandbits(32)], 32), dev)
    got = cuda_rns2.rns_modexp2(x, wins, kc, shared=True)
    assert torch.equal(got, cuda_rns2.rns_modexp2_plain(x, wins, kc, shared=True))
    with pytest.raises(NotImplementedError):  # a folded pair beyond 320 lanes
        cuda_rns2._kernel_pack(cuda_rns2.fold_group_consts2(
            ctxs, f32_mu=True, shared_input=True, device=dev))


def test_probe_kernels_equal_plain(dev):
    """P1-P4 at reduced sizes and step counts: every chain and every product
    body equals its plain version bit for bit, and the products numpy's."""
    before = dict(cuda_probes.LAUNCHES)
    for _, (R, C), byrow in cuda_probes.P1_CASES[:2]:
        x = cuda_probes.to_words(cuda_probes.make_inputs("p1", (R, C))[:2], dev)
        nconst = R if byrow else C
        m = torch.full((nconst,), cuda_probes.P1_MODULUS, dtype=torch.int32, device=dev)
        mu = torch.full((nconst,), (1 << 28) // cuda_probes.P1_MODULUS,
                        dtype=torch.int32, device=dev)
        got = cuda_probes.barrett_chain(x, m, mu, byrow, iters=40)
        assert torch.equal(got, cuda_probes.barrett_chain_plain(x, m, mu, byrow, iters=40))
    for _, op in cuda_probes.P2_CHAINS:
        x, c = cuda_probes.make_inputs("p2", op)
        x, c = cuda_probes.to_words(x[:1, :16], dev), cuda_probes.to_words(c, dev)
        got = cuda_probes.op_chain(x, c, op, 50)
        assert torch.equal(got.view(torch.int32),
                           cuda_probes.op_chain_plain(x, c, op, 50).view(torch.int32)), op
    for _, op in cuda_probes.P4_CHAINS:
        x, y = (cuda_probes.to_words(a[:16], dev) for a in cuda_probes.make_inputs("p4", op))
        got = cuda_probes.op_chain(x, y, op, 50)
        assert torch.equal(got.view(torch.int32),
                           cuda_probes.op_chain_plain(x, y, op, 50).view(torch.int32)), op
    x, c = cuda_probes.make_inputs("p2", "add")
    x, c = cuda_probes.to_words(x[:1, :16], dev), cuda_probes.to_words(c, dev)
    for _, op in cuda_probes.LAG_CHAINS:  # 53: not a multiple of the unrolling
        assert torch.equal(cuda_probes.lag_chain(x, c, op, 53),
                           cuda_probes.lag_chain_plain(x, c, op, 53)), op
    xn, tn = cuda_probes.make_inputs("p3")
    want = xn.astype(np.int64) @ tn.astype(np.int64)
    x8 = torch.from_numpy(xn.astype(np.int8)).to(dev)
    t8 = torch.from_numpy(tn.astype(np.int8)).to(dev)
    xp, tTp = cuda_probes.pack_i8(x8, t8)
    for body in ("dp4a", "mma"):
        for reps in (1, 3):
            got = cuda_probes.i8mm(xp, tTp, body=body, reps=reps)
            assert torch.equal(got, cuda_probes.i8mm_plain(xp, tTp, reps=reps)), body
            assert np.array_equal(got.cpu().numpy().astype(np.int64), want * reps), body
    xf, tf = x8.to(torch.float32), t8.to(torch.float32)
    for body in ("tiled", "thread"):  # the tiled body and the first one
        for reps in (1, 3):  # exact: 3 * 152 * 127^2 < 2^24
            got = cuda_probes.f32mm(xf, tf, reps=reps, body=body)
            assert torch.equal(got, cuda_probes.f32mm_plain(xf, tf, reps=reps)), body
            assert np.array_equal(got.cpu().numpy().astype(np.int64), want * reps), body
    ragged = cuda_probes.f32mm(xf[:37, :101].contiguous(), tf[:101, :45].contiguous())
    assert torch.equal(ragged, cuda_probes.f32mm_plain(xf[:37, :101], tf[:101, :45]))
    made = {k: cuda_probes.LAUNCHES[k] - before[k] for k in before}
    assert made == {"barrett_chain": 2, "op_chain": 18, "lag_chain": 3, "i8mm": 4,
                    "f32mm": 5, "mont_chain": 0}
    with pytest.raises(ValueError):  # the probes have no CPU path
        cuda_probes.f32mm(xf.cpu(), tf.cpu())


def test_wide_key_on_gpu(dev):
    """A 3072-bit DJN key through the public API on the card, on "rns" and on
    "cios": round trip, the injected-r oracle, equal ciphertexts across the
    backends, the grouped CRT decrypt and the RAW one."""
    from pailliercryptolib_tpu_torch.convert import keys_from_ints
    from pailliercryptolib_tpu_torch.utils.config import Config, set_config

    key = ptorch.generate_keypair(3072, enable_DJN=True)  # device="cuda"
    pk, sk = key.pub_key, key.priv_key
    assert not sk._engine.crt_folded
    rng = random.Random(3)
    vals = [rng.getrandbits(64) for _ in range(21)]
    forms = cuda_rns2.MODEXP2_FORMS
    before = dict(forms), cuda_rns2.LAUNCHES["rns_modexp2f"]
    ct = pk.encrypt(ptorch.PlainText(vals))
    assert sk.decrypt(ct).texts == vals
    assert forms["grouped"] == before[0]["grouped"] + 1
    assert cuda_rns2.LAUNCHES["rns_modexp2f"] == before[1]
    rs = [rng.getrandbits(pk.randbits) for _ in range(3)]
    pk.set_random(rs)
    got = pk.encrypt(ptorch.PlainText(vals[:3]))
    n, n2 = pk.n, pk.nsquare
    assert got.texts == [(n * m + 1) * pow(pk.hs, r, n2) % n2 for m, r in zip(vals, rs)]
    set_config(Config(backend="cios"))
    try:
        ckey = keys_from_ints(n, sk.p, sk.q, pk.hs, pk.randbits)
        cpk, csk = ckey.pub_key, ckey.priv_key
        assert cpk._engine.backend == csk._engine.backend == "cios"
    finally:
        set_config(Config())
    cpk.set_random(rs)
    assert cpk.encrypt(ptorch.PlainText(vals[:3])).texts == got.texts
    chain = (ct + ct) * ptorch.PlainText([3])
    want = [6 * v % n for v in vals]
    assert csk.decrypt(chain).texts == want
    sk.enable_crt = False
    assert sk.decrypt(chain).texts == want  # RAW at n^2 width, f32 full fold
    sk.enable_crt = True


def test_mesh_split_on_one_card(dev):
    """A mesh of two entries on one card ([cuda:0, cuda:0]): a 512-bit DJN
    key, 300 rows cut at 256; each entry's ciphertexts equal the unsplit
    engine's on its rows with its seed row, K2 runs once an entry, the round
    trip and CT+CT / CT*PT hold on the split payload."""
    from pailliercryptolib_tpu_torch.convert import keys_from_ints
    from pailliercryptolib_tpu_torch.models.engine import ShardedLimbs
    from pailliercryptolib_tpu_torch.parallel import context as pctx
    from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

    key = ptorch.generate_keypair(512, enable_DJN=True, device=dev)
    upk, usk = key.pub_key, key.priv_key
    upk._engine, usk._engine
    d0 = torch.device("cuda", 0)
    pctx.initialize_context(devices=[d0, d0])
    try:
        skey = keys_from_ints(upk.n, usk.p, usk.q, upk.hs, upk.randbits, device=d0)
        spk, ssk = skey.pub_key, skey.priv_key
        rows = np.stack([DeviceSeed().data for _ in range(2)])
        spk._engine._seed_rows = lambda r: rows
        vals = [random.Random(3).getrandbits(64) for _ in range(300)]
        before = dict(cuda_rns2.LAUNCHES)
        ct = spk.encrypt(ptorch.PlainText(vals))
        torch.cuda.synchronize()
        assert cuda_rns2.LAUNCHES["fb_modexp2"] - before["fb_modexp2"] == 2
        pay = ct.device_payload()
        assert isinstance(pay, ShardedLimbs) and pay.bounds == [(0, 256), (256, 300)]
        texts = ct.texts
        for i, (lo, hi) in enumerate(pay.bounds):
            solo = upk._engine.encrypt_djn_dev(vals[lo:hi], DeviceSeed(rows[i]))
            assert solo.fetch() == texts[lo:hi]
        assert ssk.decrypt(ct).texts == vals
        m = (ct + ct) * ptorch.PlainText([3])
        assert isinstance(m.device_payload(), ShardedLimbs)
        assert ssk.decrypt(m).texts == [6 * v % upk.n for v in vals]
    finally:
        pctx.terminate_context()
