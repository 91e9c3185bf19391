"""The tensor-core tiling of the fixed-base kernels in plain PyTorch: K2
(csrc/fb_modexp2.cu, fb_modexp2_tc_kernel) beyond 320 lanes, in the wide
layout (a cluster of eight CTAs, the lanes padded to a multiple of 64), and
K1 (csrc/fb_table2.cu, fb_table2_tc_kernel) in its own layouts of fewer rows
a cluster, walking the reference's chain acc_{j+1} = mont(acc_j, g) with
canonical outputs.  Each walk runs ``mont_mul2_tc_plain`` on the layout's
pack (digit fragments, the B fragments of every CTA, the alpha tiles)
against the port's plain versions, and K1's against ``pallas_fb_table2`` in
interpret mode.

Sets: the 256-bit fixed-base set-up of test_torch_kernels.py, and one
4600-bit modulus (a one-system set of 352 lanes, integer Barrett), a few
rows.  Tolerance: exact integer equality."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.ops import cuda_rns2 as tr2  # noqa: E402
from pailliercryptolib_tpu_torch.ops import rns as trns  # noqa: E402
from test_torch_kernels import _fb_setup, _t  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool only costs, and under
    parallel test workers it oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _residues(rng, mods, rows):
    m = mods.numpy().astype(np.int64)
    return torch.from_numpy(rng.integers(0, 1 << 30, (rows, m.shape[0])) % m)


@pytest.fixture(scope="module")
def wide352():
    """A 4600-bit modulus: k = 342, 352 lanes, beyond the narrow layout."""
    N = random.Random(4600).getrandbits(4600) | (1 << 4599) | 1
    consts = tr2.stack_group_consts2([trns.RNSContext.create(N)])
    p = tr2._kernel_pack(consts)
    assert (p["W"], p["k"], p["f32"]) == (352, 342, False)
    return consts


@pytest.fixture(scope="module")
def fb256():
    return _fb_setup(256)


@pytest.mark.parametrize("W,padded", [(352, 384), (480, 512), (640, 640)])
def test_wide_sets_take_the_wide_layouts(W, padded):
    """K2 and K1 sets beyond 320 lanes run a cluster of eight with the lanes
    padded to whole warps (a multiple of 64): K2 the wide layout of K5, K1 its
    own of fewer m-tiles; the folded K3 still refuses them."""
    assert tr2.tc_layout(W, "fb_modexp2") == (tr2.TC_WIDE_CLUSTER, tr2.TC_WIDE_MT, padded, 1)
    assert tr2.tc_layout(W, "fb_modexp2") == tr2.tc_layout(W, "rns_modexp2")
    assert tr2.tc_layout(W, "fb_table2") == (*tr2.TC_LAYOUTS["k1_wide"][:2], padded, 1)
    with pytest.raises(NotImplementedError):
        tr2.tc_layout(W, "rns_modexp2f")


def test_wide_pack_holds_the_planes(wide352):
    """The wide pack of the 352-lane set: 8 CTAs of 48 lanes, 11 chunks; its
    fragments give the plane sums of T1 (with the alpha column) and T2, zero
    in the pad lanes; row table and Cin at the padded stride; K1's pack
    shares its tensors."""
    tcp = tr2._tc_pack(wide352, "fb_modexp2")
    p = tr2._kernel_pack(wide352)
    assert (tcp["cluster"], tcp["mt"], tcp["W"], tcp["KC"]) == (8, 9, 384, 11)
    assert tcp["T1"].shape == tcp["T2"].shape == (1, 8, 11, 12, 32, 2)
    assert torch.equal(tcp["rowc"][..., :352], p["rowc"])
    assert not bool(tcp["rowc"][..., 352:].any())
    rng = np.random.default_rng(352)
    x = torch.from_numpy(rng.integers(0, 1 << 14, (8, tcp["k"])))
    x[0] = (1 << 14) - 1
    A = tr2.tc_digit_fragments(x, tcp["KC"])
    for ext in (1, 2):
        cols = wide352[f"T{ext}lo"].shape[-1]
        got = tr2.tc_extend_plain(A, tcp[f"T{ext}"][0])
        want = tr2._plane_sums(x, wide352[f"T{ext}lo"][0], wide352[f"T{ext}hi"][0])
        for g, w in zip(got, want):
            assert torch.equal(g[:, :cols], w) and not bool(g[:, cols:].any())
    k1 = tr2._tc_pack(wide352, "fb_table2")
    assert k1["mt"] == tr2.TC_LAYOUTS["k1_wide"][1] and k1["T1"] is tcp["T1"]


def _fb_modexp2_tc_walk(tab, wins, consts, tcp, mont_out):
    """fb_modexp2_plain with every product walked through the tiling of
    ``tcp``: step i gathers each row's entry by the one-hot product over the
    planes ``tab`` (the kernel's gather), then multiplies it into the
    accumulator."""
    c = tr2._plain_consts(consts)
    k = c["sig0"].shape[-1]
    w = wins[0]
    for i in range(tab.shape[0]):
        sel = tr2.fb_onehot_gather_plain(tab[i], w[:, i], k)
        if i == 0:
            accA, accB = sel[:, :k], sel[:, k:]
        else:
            accA, accB = tr2.mont_mul2_tc_plain(c, tcp, accA, accB, sel[:, :k], sel[:, k:])
    if not mont_out:
        one = torch.ones((1, k), dtype=torch.int64)
        accA, accB = tr2.mont_mul2_tc_plain(c, tcp, accA, accB, one, c["poneB"][None])
    outB = tr2.red_mu(accB * c["winv"], c["modsBx"], c["muBx"])
    return torch.cat([accA, outB], dim=-1)[None].to(torch.int32)


@pytest.mark.parametrize("mont_out", [False, True])
def test_wide_fixed_base_modexp_walk_equals_plain(wide352, mont_out):
    """K2's wide tiling, NP = 2 byte positions, B = 8 rows (one with the
    largest byte everywhere), against fb_modexp2_plain."""
    rng = np.random.default_rng(7)
    NP, B = 2, 8
    gA = _residues(rng, wide352["modsA"][0], NP).to(torch.int32)[None]
    gB = _residues(rng, wide352["modsBx"][0], NP).to(torch.int32)[None]
    tab = tr2.fb_gather_table(*tr2.fb_table2_plain(gA, gB, wide352))
    wins = torch.from_numpy(rng.integers(0, 256, (1, B, NP), dtype=np.uint8))
    wins[0, 0] = 255
    tcp = tr2._tc_pack(wide352, "fb_modexp2")
    got = _fb_modexp2_tc_walk(tab, wins, wide352, tcp, mont_out)
    assert torch.equal(got, tr2.fb_modexp2_plain(tab, wins, wide352, mont_out=mont_out))


def _fb_table2_tc_walk(gA, gB, consts, tcp):
    """K1's chain through the tiling of ``tcp``: acc_0 = one, acc_{j+1} =
    mont(acc_j, g) with canonical outputs, every acc_j stored."""
    c = tr2._plain_consts(consts)
    NP = gA.shape[1]
    accA, accB = c["oneA"].expand(NP, -1), c["oneB"].expand(NP, -1)
    yA, yB = gA[0].to(torch.int64), gB[0].to(torch.int64)
    tabA, tabB = [], []
    for j in range(tr2.FB_TABLE):
        tabA.append(accA)
        tabB.append(accB)
        if j < tr2.FB_TABLE - 1:
            accA, accB = tr2.mont_mul2_tc_plain(c, tcp, accA, accB, yA, yB,
                                                canonical_out=True)
    return (torch.stack(tabA)[None].to(torch.int32),
            torch.stack(tabB)[None].to(torch.int32))


def test_fixed_base_table_walk_equals_plain_and_pallas(fb256):
    """K1's whole chain (255 products) at 256 bits through the tiling of its
    layout for the set (the narrow K1 layout): equal to fb_table2_plain and
    to pallas_fb_table2 in interpret mode."""
    f = fb256
    tcp = tr2._tc_pack(f["tkc"], "fb_table2")
    assert (tcp["cluster"], tcp["mt"]) == tr2.TC_LAYOUTS["k1_narrow"][:2]
    gA, gB = _t(f["gA"]), _t(f["gB"])
    tabA, tabB = _fb_table2_tc_walk(gA, gB, f["tkc"], tcp)
    pA, pB = tr2.fb_table2_plain(gA, gB, f["tkc"])
    assert torch.equal(tabA, pA) and torch.equal(tabB, pB)
    assert np.array_equal(tabA.numpy(), f["jtabA"].astype(np.int32))
    assert np.array_equal(tabB.numpy(), f["jtabB"].astype(np.int32))


def test_wide_fixed_base_table_steps_equal_plain(wide352):
    """The first steps of K1's chain on the 352-lane set through K1's wide
    tiling (8 rows, canonical outputs), against the plain product."""
    c = tr2._plain_consts(wide352)
    tcp = tr2._tc_pack(wide352, "fb_table2")
    rng = np.random.default_rng(11)
    gA, gB = _residues(rng, c["modsA"], 8), _residues(rng, c["modsBx"], 8)
    a, b = c["oneA"].expand(8, -1), c["oneB"].expand(8, -1)
    wa, wb = a, b
    for _ in range(3):
        a, b = tr2.mont_mul2_tc_plain(c, tcp, a, b, gA, gB, canonical_out=True)
        wa, wb = tr2.mont_mul2_plain(c, wa, wb, gA, gB, canonical_out=True)
        assert torch.equal(a, wa) and torch.equal(b, wb)
        assert bool((a < c["modsA"]).all() and (b < c["modsBx"]).all())


def test_table_cpu_route_counts_no_form(fb256):
    """The wrapper's CPU route runs the plain version and counts no form."""
    f = fb256
    before = dict(tr2.KERNEL_FORMS)
    tr2.fb_table2(_t(f["gA"]), _t(f["gB"]), f["tkc"])
    assert tr2.KERNEL_FORMS == before
