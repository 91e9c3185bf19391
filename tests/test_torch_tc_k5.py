"""The tensor-core tiling of K5 (csrc/rns_modexp2.cu, rns_modexp2_tc_kernel)
in plain PyTorch: the grouped packing (G constant sets on the grid's y axis,
each with its own weight fragments, alpha tiles, row table and Cin), and the
wide layout of the n^2 sets of 3072- and 4096-bit keys (a cluster of eight
CTAs, 9 m-tiles, up to 640 lanes, 20 contraction chunks; the 480-lane set
padded to 512) against the port's plain product ``mont_mul2_plain`` and the JAX
package's digit-plane products (``pallas_rns2._mm_terms``).

Sets: the stacked p^2 / q^2 pair of a 256-bit key (K5 grouped, on the
small layout of sets of up to 160 lanes: a cluster of two CTAs), a real
3072-bit key's n^2 set (the f32-reciprocal reduction with the full fold), and
synthetic weight planes at the exact shapes of a 4096-bit key's n^2 set
(k = 637 lanes) for the extension alone, at one cluster's rows.  Tolerance:
exact integer equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import pallas_rns2 as jr2  # noqa: E402
from pailliercryptolib_tpu_torch.ops import cuda_rns2 as tr2  # noqa: E402
from pailliercryptolib_tpu_torch.ops import limbs as tlb  # noqa: E402
from pailliercryptolib_tpu_torch.ops import rns as trns  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool only costs, and under
    parallel test workers it oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _residues(rng, mods, rows):
    m = mods.numpy().astype(np.int64)
    return torch.from_numpy(rng.integers(0, 1 << 30, (rows, m.shape[0])) % m)


@pytest.fixture(scope="module")
def grouped():
    """K5 grouped: the p^2 / q^2 systems of a 256-bit key stacked (f32, lean),
    as the grouped CRT decrypt builds them."""
    rng = random.Random(12)
    pbits = 128
    Lp2 = tlb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [trns.RNSContext.create(_odd(rng, pbits) ** 2, in_limbs=in_limbs,
                                   product_bits=bits) for _ in range(2)]
    return tr2.stack_group_consts2(ctxs, f32_mu=True)


@pytest.fixture(scope="module")
def wide3072():
    """n^2 of a 3072-bit key: 465 lanes, a wide-pool set (f32, full fold)."""
    return tr2.stack_group_consts2(
        [trns.RNSContext.create(_odd(random.Random(6144), 6144))])


def test_grouped_pack_is_one_pack_a_group(grouped):
    """G = 2 sets on the grid: each group's fragments, alpha tiles, row table
    and Cin are its own set's, packed alone."""
    tcp = tr2._tc_pack(grouped, "rns_modexp2")
    assert (tcp["G"], tcp["cluster"], tcp["mt"]) == (2, tr2.TC_SMALL_CLUSTER, tr2.TC_MT)
    assert tcp["f32"] and tcp["lean"] and tcp["T1"].shape[:2] == (2, 2)
    for g in range(2):
        one = {k: v[g:g + 1] for k, v in grouped.items() if isinstance(v, torch.Tensor)}
        alone = tr2._tc_pack(one, "rns_modexp2")
        for key in ("T1", "T2", "T1a", "rowc", "Cin"):
            assert torch.equal(tcp[key][g], alone[key][0]), (g, key)
    assert not torch.equal(tcp["T1"][0], tcp["T1"][1])


@pytest.mark.parametrize("g", [0, 1])
def test_grouped_product_walk_equals_plain(grouped, g):
    """One product of each group on a cluster's 72 rows through that group's
    fragments, and a chain of three: the tile walk equals the plain product."""
    c = tr2._plain_consts(grouped, g)
    tcp = tr2._tc_pack(grouped, "rns_modexp2")
    rng = np.random.default_rng(40 + g)
    xA, yA = (_residues(rng, c["modsA"], tr2.TC_ROWS) for _ in range(2))
    xB, yB = (_residues(rng, c["modsBx"], tr2.TC_ROWS) for _ in range(2))
    xA[0], yA[0] = c["modsA"] - 1, c["modsA"] - 1
    a, b = tr2.mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB, g=g)
    wa, wb = tr2.mont_mul2_plain(c, xA, xB, yA, yB)
    assert torch.equal(a, wa) and torch.equal(b, wb)
    for _ in range(3):
        a, b = tr2.mont_mul2_tc_plain(c, tcp, a, b, a, b, g=g)
        wa, wb = tr2.mont_mul2_plain(c, wa, wb, wa, wb)
    assert torch.equal(a, wa) and torch.equal(b, wb)


def test_wide_layout_at_4096_bits():
    """The wide layout of a 4096-bit key's n^2 set (k = 637, kb = 638, 640
    lanes): 8 CTAs of 80 lanes, 20 chunks, the redundant lane and the alpha
    column in the last CTA, and the shared memory of a CTA
    (csrc/rns_mont_mul_tc.cuh Layout<8, 9, 640, 9, false>: the weights stay in
    device memory) within the card's."""
    assert tr2.tc_layout(640, "rns_modexp2") == (8, 9, 640)
    tcp = {"W": 640, "cluster": 8}
    k, kb = 637, 638
    for lane in (k, kb):
        assert tr2.tc_lane_owner(tcp, lane)[0] == 7
    assert tr2.tc_lane_owner(tcp, 80) == (1, 0, 0, 0)
    assert tr2.tc_lane_owner(tcp, 639) == (7, 9, 1, 3)
    MKC, MW, MT, C = 20, 640, tr2.TC_WIDE_MT, tr2.TC_WIDE_CLUSTER
    threads = 4 * MW // C
    smem = 4 * (2 * MT * MKC * 128 + 4 * 8 * MT
                + len(tr2._ROW_IDS) * MW // C + MT * tr2.TC_NL * threads + MKC * 2 * 64)
    assert threads == 320 and smem == 227072 <= 232448


@pytest.mark.parametrize("ext,cols", [(1, 639), (2, 638)])
def test_wide_extension_walk_at_640_lanes(ext, cols):
    """The extension alone at a 4096-bit key's n^2 shape (synthetic 7-bit
    planes, 637 contraction rows, ``cols`` weight columns), one cluster of
    eight CTAs and its 72 rows: the tile walk equals the port's and the reference's
    plane products, and the padding holds zero."""
    rng = np.random.default_rng(ext)
    k, W = 637, 640
    Tlo = torch.from_numpy(rng.integers(0, 128, (k, cols)).astype(np.int8))
    Thi = torch.from_numpy(rng.integers(0, 128, (k, cols)).astype(np.int8))
    Bf = tr2._pack_tc_planes(Tlo, Thi, W, tr2.TC_WIDE_CLUSTER)
    assert Bf.shape == (8, 20, 20, 32, 2)
    x = torch.from_numpy(rng.integers(0, 1 << 14, (tr2.TC_WIDE_ROWS, k)))
    x[0] = (1 << 14) - 1
    got = tr2.tc_extend_plain(tr2.tc_digit_fragments(x, 20), Bf)
    _, port = tr2._mm_terms(x, Tlo, Thi, 0, 0, cols, False)
    _, ref = jr2._mm_terms(jnp.asarray(x.numpy().astype(np.uint32)),
                           jnp.asarray(Tlo.numpy()), jnp.asarray(Thi.numpy()),
                           jnp.uint32(0), jnp.uint32(0), ncols=cols)
    for gv, p, r in zip(got, port, ref):
        assert torch.equal(gv[:, :cols], p)
        assert np.array_equal(gv[:, :cols].numpy(), np.asarray(r).astype(np.int64))
        assert not bool(gv[:, cols:].any())


def test_wide_pack_pads_480_lanes(wide3072):
    """The 480-lane set takes the wide layout at 512 lanes: the row table and
    Cin at that stride, equal to the 480-lane pack where it exists and zero in
    the pad lanes; the weight fragments hold zero there too."""
    p = tr2._kernel_pack(wide3072)
    tcp = tr2._tc_pack(wide3072, "rns_modexp2")
    assert (p["W"], p["f32"], p["lean"]) == (480, True, False)
    assert (tcp["W"], tcp["cluster"], tcp["mt"], tcp["KC"]) == (512, 8, 9, 15)
    assert tcp["T1"].shape == (1, 8, 15, 16, 32, 2)
    assert torch.equal(tcp["rowc"][..., :480], p["rowc"])
    assert not bool(tcp["rowc"][..., 480:].any())
    assert torch.equal(tcp["Cin"][:, :, :480], p["Cin"])
    assert not bool(tcp["Cin"][:, :, 480:].any())
    assert tr2._tc_pack(wide3072, "fb_modexp2") is tcp  # K2 shares K5's wide layout
    ll, mid, hh = tr2.tc_extend_plain(
        tr2.tc_digit_fragments(torch.full((8, 465), (1 << 14) - 1), 15), tcp["T2"][0])
    assert not bool(ll[:, 466:].any() or mid[:, 466:].any() or hh[:, 466:].any())


@pytest.mark.parametrize("canonical_out", [False, True])
def test_wide_product_walk_equals_plain(wide3072, canonical_out):
    """The f32 full-fold product of the 3072-bit n^2 set through the wide
    tiling (8 CTAs of 64 lanes, 15 chunks, alpha tiles of every CTA) on one
    cluster's 72 rows, then a chain of two, against the plain product."""
    c = tr2._plain_consts(wide3072)
    tcp = tr2._tc_pack(wide3072, "rns_modexp2")
    rng = np.random.default_rng(50)
    xA, yA = (_residues(rng, c["modsA"], tr2.TC_WIDE_ROWS) for _ in range(2))
    xB, yB = (_residues(rng, c["modsBx"], tr2.TC_WIDE_ROWS) for _ in range(2))
    xA[0], yA[0] = c["modsA"] - 1, c["modsA"] - 1
    got = tr2.mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB, canonical_out=canonical_out)
    want = tr2.mont_mul2_plain(c, xA, xB, yA, yB, canonical_out=canonical_out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a, b = got
    wa, wb = want
    for _ in range(2):
        a, b = tr2.mont_mul2_tc_plain(c, tcp, a, b, a, b)
        wa, wb = tr2.mont_mul2_plain(c, wa, wb, wa, wb)
    assert torch.equal(a, wa) and torch.equal(b, wb)
    # the alpha tiles every CTA holds give the alpha column's plane sums
    kb = tcp["kb"]
    x = torch.from_numpy(rng.integers(0, 1 << 14, (8, tcp["k"])))
    Ta = tcp["T1a"][0]
    sums = tr2.tc_extend_plain(tr2.tc_digit_fragments(x, tcp["KC"]),
                               Ta.permute(1, 0, 2, 3)[None].permute(0, 2, 1, 3, 4))
    want_s = tr2._plane_sums(x, wide3072["T1lo"][0], wide3072["T1hi"][0])
    for gv, w in zip(sums, want_s):
        assert torch.equal(gv[:, kb % 4], w[:, kb])
