"""The tensor-core tiling of K2 / K3 (csrc/rns_mont_mul_tc.cuh) in plain
PyTorch: weight fragments, digit fragments, the M/N interleave, the padding
of the contraction and the per-CTA lane split, against the digit-plane
products of the port (``cuda_rns2._mm_terms``) and of the JAX package
(``pallas_rns2._mm_terms``), and the tile-walking Montgomery product
``mont_mul2_tc_plain`` against ``mont_mul2_plain``.  The fragment layouts are
restated here from the PTX ISA ("Matrix Fragments for mma.m16n8k32"), apart
from the module's own index arrays.  256-bit sets, and the constant sets of a
2048-bit key for the shapes.  Tolerance: exact integer equality."""

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
    """The tensors here are small: torch's intra-op thread pool only costs,
    and under parallel test workers it oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _n2_set(bits, seed, f32_mu=False):
    """One residue system over an odd ``bits``-bit modulus (K2's form)."""
    N = _odd(random.Random(seed), bits)
    return tr2.stack_group_consts2([trns.RNSContext.create(N)], f32_mu=f32_mu)


def _crt_set(pbits, seed):
    """The folded p^2 / q^2 set as CRT decrypt builds it (K3's form)."""
    rng = random.Random(seed)
    Lp2 = tlb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [trns.RNSContext.create(_odd(rng, pbits) ** 2, in_limbs=in_limbs,
                                   product_bits=bits) for _ in range(2)]
    return tr2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True)


@pytest.fixture(scope="module", params=["n2-int", "n2-f32", "crt-folded"])
def small_set(request):
    if request.param == "crt-folded":
        return _crt_set(128, seed=5)
    return _n2_set(256, seed=3, f32_mu=request.param == "n2-f32")


def _kernel(consts):
    """The narrow-layout kernel that takes ``consts``: K3 the folded sets, K2
    the one-system ones."""
    return "rns_modexp2f" if "maskB" in consts else "fb_modexp2"


def _residues(rng, mods, rows):
    m = mods.numpy().astype(np.int64)
    return torch.from_numpy(rng.integers(0, 1 << 30, (rows, m.shape[0])) % m)


# the PTX ISA's fragments of mma.m16n8k32 with 8-bit operands, g = lane / 4,
# t = lane % 4: A row-major 16 x 32, four registers of four bytes; B
# column-major 32 x 8, two registers; C 16 x 8, four int32
def _a_elem(lane, reg, byte):
    g, t = lane // 4, lane % 4
    row = g if reg in (0, 2) else g + 8
    col = 4 * t + byte + (16 if reg >= 2 else 0)
    return row, col


def _b_elem(lane, reg, byte):
    g, t = lane // 4, lane % 4
    return 4 * t + byte + 16 * reg, g  # (contraction, column)


def test_fragment_index_is_the_ptx_layout():
    a_row, a_k, b_k, b_col = tr2._tc_frag_index()
    for lane in range(32):
        for reg in range(4):
            for byte in range(4):
                assert (a_row[lane, reg, byte], a_k[lane, reg, byte]) == \
                    _a_elem(lane, reg, byte)
        for reg in range(2):
            for byte in range(4):
                assert (b_k[lane, reg, byte], b_col[lane, reg, byte]) == \
                    _b_elem(lane, reg, byte)


def _unpack_weights(Bf, W):
    """B fragments [4, KC, NT, 32, 2] -> planes (lo, hi) [32 KC, W], by the
    ISA's layout and the port's N interleave: tile column 2h + p is plane p
    of lane 4 nt + h of CTA c."""
    C, KC, NT = Bf.shape[:3]
    by = Bf.contiguous().view(torch.int8).view(C, KC, NT, 32, 2, 4).numpy()
    planes = np.full((2, KC * 32, W), -1, np.int64)
    for lane in range(32):
        for reg in range(2):
            for byte in range(4):
                kk, col = _b_elem(lane, reg, byte)
                h, p = col // 2, col % 2
                for c in range(C):
                    lanes = c * (W // C) + 4 * np.arange(NT) + h
                    planes[p, 32 * np.arange(KC)[:, None] + kk, lanes[None, :]] = \
                        by[c, :, :, lane, reg, byte]
    return planes


def test_weight_fragments_hold_the_planes(small_set):
    """Every (contraction, lane) weight lands in exactly one fragment byte:
    the planes where they exist, zero in the padding."""
    tcp = tr2._tc_pack(small_set, _kernel(small_set))
    W, KC = tcp["W"], tcp["KC"]
    assert tr2._tc_pack(small_set, _kernel(small_set)) is tcp  # cached in the dict
    assert KC * 32 >= tcp["k"] and KC * 32 <= W and W % (4 * tr2.TC_CLUSTER) == 0
    for ext in (1, 2):
        assert tcp[f"T{ext}"].shape == (1, tr2.TC_CLUSTER, KC, W // 16, 32, 2)
        Bf = tcp[f"T{ext}"][0]  # the set's one group
        assert Bf.dtype == torch.int32
        planes = _unpack_weights(Bf, W)
        for p, key in enumerate((f"T{ext}lo", f"T{ext}hi")):
            T = small_set[key][0].numpy().astype(np.int64)
            want = np.zeros((KC * 32, W), np.int64)
            want[: T.shape[0], : T.shape[1]] = T
            assert np.array_equal(planes[p], want), key


def test_digit_fragments_follow_the_isa():
    rng = np.random.default_rng(1)
    k, KC, rows = 70, 3, 16
    x = torch.from_numpy(rng.integers(0, 1 << 14, (rows, k)))
    A = tr2.tc_digit_fragments(x, KC)
    assert A.shape == (rows // 8, KC, 32, 4) and A.dtype == torch.int32
    by = A.view(torch.int8).view(rows // 8, KC, 32, 4, 4).numpy().astype(np.int64)
    xn = x.numpy()
    for mt in range(rows // 8):
        for kc in range(KC):
            for lane in range(32):
                for reg in range(4):
                    for byte in range(4):
                        m, kk = _a_elem(lane, reg, byte)
                        row, pos = 8 * mt + m % 8, 32 * kc + kk
                        v = int(xn[row, pos]) if pos < k else 0
                        want = v & 0x7F if m < 8 else v >> 7  # low digits over high
                        assert by[mt, kc, lane, reg, byte] == want


def test_alpha_tiles_give_the_alpha_sums(small_set):
    """Every CTA's copy of T1's alpha columns (n-tiles kb / 4, kb / 4 + 1)
    gives the plane sums of the columns kb .. kb + G - 1, as the full
    extension does."""
    tcp = tr2._tc_pack(small_set, _kernel(small_set))
    kb, KC = tcp["kb"], tcp["KC"]
    G = 2 if "maskB" in small_set else 1
    assert tcp["T1a"].shape == (1, KC, 2, 32, 2)
    Ta = tcp["T1a"][0]  # the set's one group
    assert Ta.dtype == torch.int32
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 1 << 14, (16, tcp["k"])))
    # the alpha tiles as a one-CTA, two-n-tile weight set
    ll, mid, hh = tr2.tc_extend_plain(tr2.tc_digit_fragments(x, KC),
                                      Ta.permute(1, 0, 2, 3)[None].permute(0, 2, 1, 3, 4))
    want = tr2._plane_sums(x, small_set["T1lo"][0], small_set["T1hi"][0])
    first = 4 * (kb // 4)
    for got, w in zip((ll, mid, hh), want):
        assert torch.equal(got[:, kb - first: kb - first + G], w[:, kb: kb + G])


@pytest.mark.parametrize("ext", [1, 2])
def test_tc_extension_equals_plane_products(small_set, ext):
    """ll / mid / hh of the tile walk equal the port's and the reference's
    digit-plane products column for column (the weight columns beyond the
    residue lanes carry the alpha sums)."""
    tcp = tr2._tc_pack(small_set, _kernel(small_set))
    rng = np.random.default_rng(10 + ext)
    k, rows = tcp["k"], 24
    x = torch.from_numpy(rng.integers(0, 1 << 14, (rows, k)))
    x[0] = (1 << 14) - 1  # the largest digits
    Tlo, Thi = small_set[f"T{ext}lo"][0], small_set[f"T{ext}hi"][0]
    ncols = Tlo.shape[-1]
    got = [v[:, :ncols] for v in tr2.tc_extend_plain(
        tr2.tc_digit_fragments(x, tcp["KC"]), tcp[f"T{ext}"][0])]
    _, port = tr2._mm_terms(x, Tlo, Thi, 0, 0, ncols, False)
    _, ref = jr2._mm_terms(jnp.asarray(x.numpy().astype(np.uint32)),
                           jnp.asarray(Tlo.numpy()), jnp.asarray(Thi.numpy()),
                           jnp.uint32(0), jnp.uint32(0), ncols=ncols)
    for g, p, r in zip(got, port, ref):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))
    # beyond the weight columns the fragments hold zero
    for v in tr2.tc_extend_plain(tr2.tc_digit_fragments(x, tcp["KC"]), tcp[f"T{ext}"][0]):
        assert not bool(v[:, ncols:].any())


@pytest.mark.parametrize("canonical_out", [False, True])
def test_mont_mul2_tc_plain_equals_plain(small_set, canonical_out):
    c = tr2._plain_consts(small_set)
    tcp = tr2._tc_pack(small_set, _kernel(small_set))
    rng = np.random.default_rng(20)
    rows = 16
    xA, yA = (_residues(rng, c["modsA"], rows) for _ in range(2))
    xB, yB = (_residues(rng, c["modsBx"], rows) for _ in range(2))
    xA[0], yA[0] = c["modsA"] - 1, c["modsA"] - 1  # the largest residues
    want = tr2.mont_mul2_plain(c, xA, xB, yA, yB, canonical_out=canonical_out)
    got = tr2.mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB, canonical_out=canonical_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # a chain: the outputs feed the next product as in the kernels
    a, b = got
    for _ in range(3):
        a, b = tr2.mont_mul2_tc_plain(c, tcp, a, b, a, b)
    wa, wb = want
    for _ in range(3):
        wa, wb = tr2.mont_mul2_plain(c, wa, wb, wa, wb)
    assert torch.equal(a, wa) and torch.equal(b, wb)


@pytest.fixture(scope="module",
                params=["K2 n^2 of a 2048-bit key", "K3 p^2/q^2 of a 2048-bit key"])
def set2048(request):
    if request.param.startswith("K2"):
        return request.param, _n2_set(4096, seed=8)
    return request.param, _crt_set(1024, seed=9)


def test_tc_shapes_at_2048_bits(set2048):
    """The main path's sets: 320 lanes, 10 contraction chunks, 20 n-tiles a
    CTA, the trailing alpha and m_r columns owned by the last CTA, and a
    CTA's shared memory within the card's 227 KB.  K3 runs the narrow
    layout's two halves (a warp four n-tiles of a half's rows, three
    mbarriers a half), K2 its one half (a warp two n-tiles of all rows)."""
    name, consts = set2048
    tcp = tr2._tc_pack(consts, _kernel(consts))
    folded = "maskB" in consts
    G = 2 if folded else 1
    k, kb, W, KC = tcp["k"], tcp["kb"], tcp["W"], tcp["KC"]
    assert (W, KC) == (320, 10) and kb == k + G and k + 2 * G <= W
    assert tcp["f32"] == folded and tcp["lean"] == folded
    assert tcp["T1"].shape == tcp["T2"].shape == (1, 4, 10, 20, 32, 2)
    for lane in list(range(kb, kb + G)) + list(range(k, k + G)):
        assert tr2.tc_lane_owner(tcp, lane)[0] == tr2.TC_CLUSTER - 1
    assert tcp["halves"] == (2 if folded else 1)
    assert tr2.tc_lane_owner(tcp, 0) == (0, 0, 0, 0)
    assert tr2.tc_lane_owner(tcp, 5) == (0, 0, 1, 1)
    if folded:  # warp 4 of half 0 (rows 0-39), warp 9 = 4 of half 1 (rows 40-71)
        assert tr2.tc_lane_owner(tcp, W - 1) == (3, 4, 3, 3)
        assert tr2.tc_lane_owner(tcp, W - 1, row=39) == (3, 4, 3, 3)
        assert tr2.tc_lane_owner(tcp, W - 1, row=40) == (3, 9, 3, 3)
    else:
        assert tr2.tc_lane_owner(tcp, W - 1) == (3, 9, 1, 3)
    # csrc/rns_mont_mul_tc.cuh SMEM_BYTES, laid out for the widest set:
    # two digit buffers, T1 / T2 fragments, alpha / alpha', lane constants,
    # v_B / t_A (the same words in either layout: a half's threads hold twice
    # the lanes of half the rows), T1's alpha columns, and with two halves
    # three mbarriers of 8 bytes a half
    MKC, MNT, MW = 10, 20, tr2.TC_MAX_W
    assert KC <= MKC and W // 16 <= MNT and W // 4 <= MW // 4
    smem = 4 * (2 * tr2.TC_MT * MKC * 128 + 2 * MKC * MNT * 64 + 4 * tr2.TC_ROWS
                + len(tr2._ROW_IDS) * MW // 4 + tr2.TC_MT * tr2.TC_NL * MW + MKC * 2 * 64)
    smem += 8 * 3 * 2 if folded else 0
    assert smem == (232240 if folded else 232192)
    assert smem <= 232448, name


def test_tc_product_at_2048_bits(set2048):
    """One product on a cluster's 72 rows, tile walk against the plain one."""
    _, consts = set2048
    c = tr2._plain_consts(consts)
    tcp = tr2._tc_pack(consts, _kernel(consts))
    rng = np.random.default_rng(30)
    xA, yA = (_residues(rng, c["modsA"], tr2.TC_ROWS) for _ in range(2))
    xB, yB = (_residues(rng, c["modsBx"], tr2.TC_ROWS) for _ in range(2))
    got = tr2.mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB)
    want = tr2.mont_mul2_plain(c, xA, xB, yA, yB)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tc_pack_refuses_what_the_kernels_do_not_take(small_set):
    """Two groups of a folded set (K3 runs one), a folded set for the
    one-system kernels and a one-system set for K3, sets beyond 320 lanes for
    K3's narrow layout and beyond 640 for the wide ones (K1, K2, K5) are
    refused; two groups of a one-system set are K5's grouped form, one pack a
    group."""
    pair = {k: torch.cat([v, v]) for k, v in small_set.items()
            if isinstance(v, torch.Tensor)}
    folded = "maskB" in small_set
    if folded:
        with pytest.raises(NotImplementedError):
            tr2._tc_pack(pair, "rns_modexp2f")
        with pytest.raises(ValueError):
            tr2._tc_pack(small_set, "fb_modexp2")
    else:
        tcp, one = tr2._tc_pack(pair, "rns_modexp2"), tr2._tc_pack(small_set, "rns_modexp2")
        assert tcp["G"] == 2 and tcp["T1"].shape[0] == 2
        for key in ("T1", "T2", "T1a", "rowc", "Cin"):
            assert torch.equal(tcp[key][1], one[key][0]), key
        with pytest.raises(ValueError):
            tr2._tc_pack(small_set, "rns_modexp2f")
    W = tr2._kernel_pack(small_set)["W"]
    # K3 in the narrow layout's two halves (lanes padded to whole warps of a
    # half: a multiple of 64), K2 in its one half (a multiple of 32)
    halves = 2 if folded else 1
    padded = -(-W // (32 * halves)) * 32 * halves
    assert tr2.tc_layout(W, _kernel(small_set)) == (tr2.TC_CLUSTER, tr2.TC_MT, padded, halves)
    with pytest.raises(NotImplementedError):  # K3: the narrow layout only
        tr2.tc_layout(352, "rns_modexp2f")
    for kernel in ("fb_table2", "fb_modexp2", "rns_modexp2"):
        with pytest.raises(NotImplementedError):
            tr2.tc_layout(672, kernel)
    if not folded:  # K5: a cluster of two up to 160 lanes; pads to whole warps of eight
        assert tr2.tc_layout(W, "rns_modexp2") == (2, 9, W, 1)
        assert tr2.tc_layout(480, "rns_modexp2") == (8, 9, 512, 1)


def test_cuda_only_forms_refuse_cpu_tensors(small_set):
    """The CUDA-core forms kept for timing have no plain route; the wrappers'
    CPU route counts no form."""
    before = dict(tr2.KERNEL_FORMS)
    if "maskB" in small_set:
        x = torch.zeros((3, small_set["CinA"].shape[-2]), dtype=torch.int32)
        w = torch.zeros((2, 2), dtype=torch.int32)
        with pytest.raises(ValueError):
            tr2.rns_modexp2f_dp4a(x, w, small_set)
        with pytest.raises(ValueError):
            tr2.rns_modexp2f_indexed(x, w, small_set)
        tr2.rns_modexp2f(x, w, small_set)
    else:
        k = small_set["sig0"].shape[-1]
        tab = torch.zeros((2, 256, 2 * k + 1), dtype=torch.int32)
        wins = torch.zeros((1, 3, 2), dtype=torch.uint8)
        with pytest.raises(ValueError):
            tr2.fb_modexp2_dp4a(tab, wins, small_set)
        with pytest.raises(ValueError):
            tr2.fb_modexp2_indexed(tab, wins, small_set)
        tr2.fb_modexp2(tr2.fb_pack_planes(tab), wins, small_set)
    assert tr2.KERNEL_FORMS == before


# The narrow layout in two halves out of step (csrc/rns_mont_mul_tc.cuh
# Narrow): K3 on the folded sets, K5 on one-system sets of up to 320 lanes.

def _crt_stacked_set(pbits, seed):
    """The (p^2, q^2) pair of the grouped CRT decrypt (K5, G = 2), as the
    engine builds it for keys above 2048 bits."""
    rng = random.Random(seed)
    Lp2 = tlb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [trns.RNSContext.create(_odd(rng, pbits) ** 2, in_limbs=in_limbs,
                                   product_bits=bits) for _ in range(2)]
    return tr2.stack_group_consts2(ctxs, f32_mu=True)


@pytest.fixture(scope="module", params=[
    "K5 n^2 of a 2048-bit key", "K3 p^2/q^2 of a 2048-bit key",
    "K5 grouped p^2/q^2 of a 4096-bit key"])
def split_set(request):
    """The split layout's sets of the cells: (name, constants, kernel, G)."""
    if request.param.startswith("K5 n^2"):
        return request.param, _n2_set(4096, seed=8), "rns_modexp2", 1
    if request.param.startswith("K3"):
        return request.param, _crt_set(1024, seed=9), "rns_modexp2f", 2
    return request.param, _crt_stacked_set(2048, seed=12), "rns_modexp2", 1


def test_split_tiling_owns_every_element_once(split_set):
    """Every (row, lane) of a cluster has exactly one owner (half, CTA, warp,
    n-tile, t) among the kernel's threads, as place() puts them; the owner's
    CTA holds the lane and its accumulator fragment (m-tile, n-tile, g, t)
    is the one of that (row, lane); tc_lane_owner agrees."""
    name, consts, kernel, _ = split_set
    tcp = tr2._tc_pack(consts, kernel)
    assert (tcp["cluster"], tcp["mt"], tcp["W"], tcp["halves"]) == (4, 9, 320, 2), name
    if "4096" in name:
        assert (tcp["k"], tcp["G"]) == (305, 2)
    e = tr2.tc_elements(tcp)
    W, Wc = tcp["W"], tcp["W"] // 4
    assert e["row"].numel() == tr2.TC_ROWS * W
    flat = e["row"] * W + e["lane"]
    assert torch.equal(torch.sort(flat).values, torch.arange(tr2.TC_ROWS * W))
    assert torch.equal(e["rank"], e["lane"] // Wc)
    assert torch.equal(e["mt"], e["row"] // 8) and torch.equal(e["g"], e["row"] % 8)
    assert torch.equal(e["nt"], (e["lane"] % Wc) // 4) and torch.equal(e["t"], e["lane"] % 4)
    # a warp's n-tiles are four adjacent ones of its CTA; each thread holds
    # 4 lanes x 5 m-tiles in half 0, 4 x 4 in half 1
    assert torch.equal(e["nt"] // 4, e["warp"])
    for half, per_thread in ((0, 20), (1, 16)):
        sel = e["half"] == half
        owners = e["rank"][sel] * 1000 + e["thread"][sel]
        assert torch.equal(torch.bincount(owners)[torch.unique(owners)],
                           torch.full((4 * 160,), per_thread))
    for i in range(0, e["row"].numel(), 997):
        row, lane = int(e["row"][i]), int(e["lane"][i])
        warp = int(e["half"][i]) * 5 + int(e["warp"][i])
        assert tr2.tc_lane_owner(tcp, lane, row) == (int(e["rank"][i]), warp, int(e["nl"][i]),
                                                      lane % 4)


def test_split_halves_partition_the_rows(split_set):
    """The halves' rows partition the cluster's 72: half 0 the m-tiles 0-4
    (rows 0-39), half 1 the m-tiles 5-8 (rows 40-71); each half runs on five
    warps of every CTA, and every thread of a half holds all of its rows
    (with its g)."""
    _, consts, kernel, _ = split_set
    tcp = tr2._tc_pack(consts, kernel)
    e = tr2.tc_elements(tcp)
    rows = [set(e["row"][e["half"] == h].tolist()) for h in (0, 1)]
    assert rows[0] == set(range(40)) and rows[1] == set(range(40, 72))
    places = [tr2.tc_place(tcp, 0, th) for th in range(320)]
    assert [p["h"] for p in places] == [0] * 160 + [1] * 160
    assert {p["v"] for p in places} == set(range(5))
    assert [(p["mt0"], p["nmt"]) for p in (places[0], places[160])] == [(0, 5), (5, 4)]


def test_split_exchange_bytes_match_the_pushes(split_set):
    """For every (CTA, half, buffer) the bytes a receiver arms its mbarrier
    with (expect_tx) are the bytes the other CTAs push into it, store by
    store; its digit barriers count one arrival besides its own for each
    other CTA that pushes no digit.  Also for sets whose last CTA owns no lane
    of the contraction, which arrives instead."""
    _, consts, kernel, G = split_set
    tcp = tr2._tc_pack(consts, kernel)
    # a set of 256 lanes with k = 191: the last CTA's lanes (192..255) lie past
    # the contraction (32 KC = 192)
    odd = dict(tcp, W=256, k=191, kb=192, KC=6)
    for t, g in ((tcp, G), (odd, 1)):
        for half in (0, 1):
            pushed = {s: tr2.tc_exchange_pushed(t, s, half, g) for s in range(4)}
            for r in range(4):
                want = tr2.tc_exchange_expected(t, r, half, g)
                got = [sum(pushed[s][r][i] for s in range(4) if s != r) for i in range(3)]
                assert got[0] == want["digit_bytes"]
                assert 1 + got[1] == want["arrivals"]
                assert got[2] == want["alpha2_bytes"]
    assert tr2.tc_exchange_expected(odd, 0, 0, 1)["arrivals"] == 2
    assert tr2.tc_exchange_expected(tcp, 3, 1, G)["alpha2_bytes"] == 0  # owns the redundant lanes
    assert tr2.tc_exchange_expected(tcp, 0, 1, G)["alpha2_bytes"] == 32 * 4 * G


def test_split_product_equals_plain(split_set):
    """mont_mul2_tc_plain walked through the split tiling (the accumulators
    read back by each (row, lane)'s owner of its half) equals
    mont_mul2_plain on a cluster's 72 rows and on a ragged second cluster,
    and in a chain of products."""
    _, consts, kernel, _ = split_set
    tcp = tr2._tc_pack(consts, kernel)
    g = 1 if tcp["G"] > 1 else 0
    c = tr2._plain_consts(consts, g)
    rng = np.random.default_rng(40)
    rows = tr2.TC_ROWS + 48
    xA, yA = (_residues(rng, c["modsA"], rows) for _ in range(2))
    xB, yB = (_residues(rng, c["modsBx"], rows) for _ in range(2))
    got = tr2.mont_mul2_tc_plain(c, tcp, xA, xB, yA, yB, g=g)
    want = tr2.mont_mul2_plain(c, xA, xB, yA, yB)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a, b = got
    wa, wb = want
    for _ in range(2):
        a, b = tr2.mont_mul2_tc_plain(c, tcp, a, b, a, b, g=g)
        wa, wb = tr2.mont_mul2_plain(c, wa, wb, wa, wb)
    assert torch.equal(a, wa) and torch.equal(b, wb)
