"""The table selects of K2, K3 and K5 read no address that takes a secret.

K2 gathers a table entry by the JAX package's one-hot product over int8 digit
planes; K3 and K5 read all 16 entries of a row's power table and keep one by
masks.  On the CPU (256-bit moduli, the JAX side in interpret mode or through
its own plane functions, as the JAX package's tests run them):

* the port's planes packing, unpacked, against ``fb_digit_planes2``;
* the plain one-hot gather against the indexed gather and the reference's
  ``_mm8`` one-hot product, and ``fb_modexp2``'s plain version against
  ``pallas_fb_modexp2``, under adversarial bytes (all 0, all 255, one value
  repeated, random);
* walks of what the kernels compute from those layouts: K2's one-hot
  ``mma.sync`` fragments (narrow and wide layouts), the masked select of
  K3's two groups and K5's windows;
* K3's and K5's plain versions against ``pallas_rns_modexp2f`` /
  ``pallas_rns_modexp2`` for windows all 0, all 15, alternating and random.

GPU-marked cases (``cuda``, skipped without a card) launch each library form
and its indexed form under the same patterns, bit-equal to the plain
version; they import no JAX, so they also run where only the port is
installed:

    python -m pytest tests/test_torch_ct_select.py -q --noconftest -o addopts="" -m cuda

Tolerance everywhere: exact integer equality.
"""

import random
import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.ops import cuda_rns2 as tr2
from pailliercryptolib_tpu_torch.ops import limbs as tlb
from pailliercryptolib_tpu_torch.ops.montgomery import to_i32
from pailliercryptolib_tpu_torch.ops.rns import RNSContext

BYTE_PATTERNS = ["zeros", "ones", "repeated", "random"]
WINDOW_PATTERNS = ["zeros", "ones", "alternating", "random"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jref():
    """The JAX package, for the CPU comparisons only (the GPU cases below
    need none of it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from pailliercryptolib_tpu.ops import pallas_rns2 as jr2
    from pailliercryptolib_tpu.ops import rns as jrns

    return types.SimpleNamespace(jnp=jnp, jr2=jr2, jrns=jrns)


def _pattern(name, shape, top, rng):
    """Window values in [0, top]: all 0, all ``top``, ``top`` and 0 in turn
    along the last axis (shifted by one on every row), a value drawn once
    and repeated, or uniform."""
    if name == "zeros":
        return np.zeros(shape, np.int64)
    if name == "ones":
        return np.full(shape, top, np.int64)
    if name == "alternating":
        idx = np.indices(shape).sum(axis=0)
        return np.where(idx % 2 == 0, top, 0).astype(np.int64)
    if name == "repeated":
        return np.full(shape, int(rng.integers(1, top)), np.int64)
    return rng.integers(0, top + 1, shape).astype(np.int64)


def _canonical_table(rng, mods, NP):
    """A table [NP, 256, lanes] of canonical residues (below each modulus)."""
    m = np.asarray(mods, np.int64)
    return rng.integers(0, 1 << 30, (NP, 256, m.shape[0])) % m


# ---------------------------------------------------------------------------
# K2: planes, the one-hot gather and its kernel walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fb(jref):
    """A 256-bit modulus, its constants in both packages, and a real table
    (K1's plain version on Montgomery-form g_i = base^(256^i))."""
    rng = random.Random(1212)
    N = rng.getrandbits(256) | (1 << 255) | 1
    c = jref.jrns.RNSContext.create(N)
    jkc = jref.jr2.stack_group_consts2([c])
    tkc = tr2.stack_group_consts2([RNSContext.create(N)])
    k, NP = c.k, 4
    r = np.random.default_rng(1212)
    gA = torch.from_numpy(_canonical_table(r, c.mods[:k], 1)[0, :NP].astype(np.int32))
    gB = torch.from_numpy(_canonical_table(r, c.mods[k:], 1)[0, :NP].astype(np.int32))
    tabA, tabB = tr2.fb_table2_plain(gA[None], gB[None], tkc)
    jplanes = jref.jr2.fb_digit_planes2(jref.jnp.asarray(tabA.numpy().astype(np.uint32)),
                                        jref.jnp.asarray(tabB.numpy().astype(np.uint32)))
    return dict(N=N, k=k, NP=NP, jkc=jkc, tkc=tkc, tabA=tabA, tabB=tabB,
                indexed=tr2.fb_indexed_table(tabA, tabB),
                planes=tr2.fb_gather_table(tabA, tabB),
                jplanes=[np.asarray(p) for p in jplanes])


def test_planes_unpack_to_fb_digit_planes2(fb):
    """The port's planes, read back, are the reference's int8 digit planes
    (lo, hi per side), zero in the padding lanes."""
    k = fb["k"]
    P = tr2.fb_unpack_planes(fb["planes"])  # [NP, side, plane, 256, W]
    assert P.dtype == torch.int8 and P.shape[-1] == tr2.fb_planes_width(k)
    tAlo, tAhi, tBlo, tBhi = fb["jplanes"]  # [1, NP, 256, w]
    for got, want in ((P[:, 0, 0, :, :k], tAlo), (P[:, 0, 1, :, :k], tAhi),
                      (P[:, 1, 0, :, : k + 1], tBlo), (P[:, 1, 1, :, : k + 1], tBhi)):
        assert np.array_equal(got.numpy(), want[0])
    assert not P[:, 0, :, :, k:].any() and not P[:, 1, :, :, k + 1:].any()


@pytest.mark.parametrize("pattern", BYTE_PATTERNS)
def test_onehot_gather_equals_indexed_and_mm8(fb, jref, pattern):
    """One step's gather: the plain one-hot product, the indexed load and the
    reference's _mm8(onehot, plane) recombined give the same entries."""
    rng = np.random.default_rng(len(pattern))
    B, k = 45, fb["k"]
    w = _pattern(pattern, (B,), 255, rng)
    wt = torch.from_numpy(w.astype(np.uint8))
    i = fb["NP"] - 1
    got = tr2.fb_onehot_gather_plain(fb["planes"][i], wt, k)
    assert torch.equal(got, fb["indexed"][i][torch.from_numpy(w)].to(torch.int64))
    jnp, jr2 = jref.jnp, jref.jr2
    onehot = jnp.asarray((w[:, None] == np.arange(256)).astype(np.int8))
    tAlo, tAhi, tBlo, tBhi = (jnp.asarray(p[0, i]) for p in fb["jplanes"])
    selA = np.asarray(jr2._mm8(onehot, tAlo)) + (np.asarray(jr2._mm8(onehot, tAhi)) << 7)
    selB = np.asarray(jr2._mm8(onehot, tBlo)) + (np.asarray(jr2._mm8(onehot, tBhi)) << 7)
    assert np.array_equal(got.numpy(), np.concatenate([selA, selB], axis=-1))


def _fb_modexp2_indexed_plain(tab, wins, consts, mont_out):
    """fb_modexp2_plain with the entries loaded by index (the indexed table)."""
    c = tr2._plain_consts(consts)
    k = c["sig0"].shape[-1]
    w = wins[0].to(torch.int64)
    for i in range(tab.shape[0]):
        sel = tab[i][w[:, i]].to(torch.int64)
        if i == 0:
            accA, accB = sel[:, :k], sel[:, k:]
        else:
            accA, accB = tr2.mont_mul2_plain(c, accA, accB, sel[:, :k], sel[:, k:])
    if not mont_out:
        one = torch.ones((1, k), dtype=torch.int64)
        accA, accB = tr2.mont_mul2_plain(c, accA, accB, one, c["poneB"][None])
    outB = tr2.red_mu(accB * c["winv"], c["modsBx"], c["muBx"])
    return torch.cat([accA, outB], dim=-1)[None].to(torch.int32)


@pytest.mark.parametrize("pattern", BYTE_PATTERNS)
def test_fb_modexp2_plain_equals_pallas_and_indexed(fb, jref, pattern):
    rng = np.random.default_rng(7 + len(pattern))
    B = 8
    wb = _pattern(pattern, (1, B, fb["NP"]), 255, rng).astype(np.uint8)
    wins = torch.from_numpy(wb)
    mont_out = pattern in ("ones", "random")
    got = tr2.fb_modexp2(fb["planes"], wins, fb["tkc"], mont_out=mont_out)
    assert torch.equal(got, _fb_modexp2_indexed_plain(fb["indexed"], wins, fb["tkc"], mont_out))
    want = jref.jr2.pallas_fb_modexp2(
        *(jref.jnp.asarray(p) for p in fb["jplanes"]), jref.jnp.asarray(wb), fb["jkc"],
        interpret=True, batch_tile=B, streams=2, mont_out=mont_out)
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def _onehot_tc_walk(planes_step, w, W, cluster):
    """One step of K2's gather as csrc/fb_modexp2_tc.cuh computes it for one
    cluster of 72 rows: each thread's one-hot A fragment from its rows'
    bytes (pos / hot), the B fragments read at the kernel's offsets, one
    mma.sync m16n8k32 per (m-tile pair, chunk, n-tile, side) with the
    fragments as PTX lays them out, the accumulators read back by the thread
    that owns them.  Returns the staged words [72, W] (A | B << 16)."""
    MT, MP = 9, 5
    b = np.zeros((2 * MP, 8), np.int64)  # [m-tile, g]: the rows' bytes
    b[:MT] = np.pad(w, (0, 72 - w.shape[0])).reshape(MT, 8)
    t = np.arange(4)
    hot = np.where(((b[..., None] >> 2) & 3) == t, 1 << (8 * (b[..., None] & 3)), 0)
    pos = np.where(np.arange(2 * MP)[:, None] < MT, b >> 4, 0xFF)  # [m-tile, g]
    # A fragments [pair, chunk, tile row 16, k 32]: thread (g, t), register r,
    # byte e holds row g + 8 (r & 1), k 16 (r >> 1) + 4 t + e
    A = np.zeros((MP, 8, 16, 32), np.int64)
    for mp in range(MP):
        for kc in range(8):
            for r in range(4):
                mt = 2 * mp + (r & 1)
                word = np.where(pos[mt][:, None] == 2 * kc + (r >> 1), hot[mt], 0)  # [g, t]
                for e in range(4):
                    A[mp, kc, (r & 1) * 8 + np.arange(8)[:, None],
                      16 * (r >> 1) + 4 * t[None, :] + e] = (word >> (8 * e)) & 0xFF
    # B fragments [side, chunk, n-tile, k 32, column 8]: thread 4g + t, word
    # r, byte e holds k 16 r + 4 t + e, column g
    NTg = W // 4
    words = planes_step.numpy().reshape(2, 8, NTg, 32, 2).astype(np.int64) & 0xFFFFFFFF
    Bf = np.zeros((2, 8, NTg, 32, 8), np.int64)
    for lane in range(32):
        g_, t_ = lane // 4, lane % 4
        for r in range(2):
            for e in range(4):
                byte = (words[:, :, :, lane, r] >> (8 * e)) & 0xFF
                Bf[:, :, :, 16 * r + 4 * t_ + e, g_] = np.where(byte > 127, byte - 256, byte)
    C = np.einsum("pkmx,sknxy->psnmy", A, Bf)  # [pair, side, n-tile, 16, 8]
    out = np.zeros((72, W), np.int64)
    Wc = W // cluster
    for rank in range(cluster):
        for warp in range(Wc // 8):
            for lane in range(32):
                g_, t_ = lane // 4, lane % 4
                j0 = rank * Wc + 8 * warp + t_  # tc::place
                for nl in range(2):
                    nt = (j0 >> 2) + nl  # the kernel's B offset
                    j = j0 + 4 * nl
                    assert 4 * nt + t_ == j
                    for mp in range(MP):
                        for h in range(2):
                            mt = 2 * mp + h
                            if mt >= MT:
                                continue
                            ya = C[mp, 0, nt, g_ + 8 * h, 2 * t_] + (
                                C[mp, 0, nt, g_ + 8 * h, 2 * t_ + 1] << 7)
                            yb = C[mp, 1, nt, g_ + 8 * h, 2 * t_] + (
                                C[mp, 1, nt, g_ + 8 * h, 2 * t_ + 1] << 7)
                            out[8 * mt + g_, j] = ya | (yb << 16)
    return out


@pytest.mark.parametrize("pattern", BYTE_PATTERNS)
@pytest.mark.parametrize("k", [40, 600])
def test_onehot_tc_walk_equals_indexed(pattern, k):
    """The kernel's one-hot fragments on the narrow layout (k = 40: 64 lanes,
    a cluster of four) and the wide one (k = 600: 640 lanes, a cluster of
    eight): each staged operand is the indexed entry, for 61 live rows."""
    rng = np.random.default_rng(k + len(pattern))
    W = tr2.fb_planes_width(k)
    cluster = tr2.tc_layout(W, "fb_modexp2")[0]
    assert (W, cluster) == ((64, 4) if k == 40 else (640, 8))
    mods = rng.integers(1 << 13, 1 << 14, 2 * k + 1)
    tab = torch.from_numpy(_canonical_table(rng, mods, 1).astype(np.int32))
    w = _pattern(pattern, (61,), 255, rng)
    got = _onehot_tc_walk(tr2.fb_pack_planes(tab)[0], w, W, cluster)
    sel = tab[0][torch.from_numpy(w)].numpy().astype(np.int64)
    want = np.zeros((72, W), np.int64)
    want[:61, :k] = sel[:, :k]
    want[:61, : k + 1] |= sel[:, k:] << 16
    want[61:, :k] = tab[0, 0, :k].numpy()  # rows past the batch take entry 0
    want[61:, : k + 1] |= tab[0, 0, k:].numpy().astype(np.int64) << 16
    assert np.array_equal(got, want)


def test_gather_table_refuses_noncanonical_entries():
    """The hi plane holds 7 bits only while every residue is below 2^14."""
    tab = torch.zeros((1, 256, 81), dtype=torch.int32)
    tab[0, 3, 5] = 1 << 14
    with pytest.raises(ValueError):
        tr2.fb_pack_planes(tab)


# ---------------------------------------------------------------------------
# K3 / K5: the masked select and the plain versions under window patterns
# ---------------------------------------------------------------------------


def _ct_select_walk(entries, wa, wb):
    """The select of csrc/ct_select.cuh on a (row, lane) table laid out as
    the library's kernels lay it out: entries [..., 16] words A | B << 16, all
    read; window_masks(wa, wb) keeps the A half of entry wa and the B half of
    entry wb."""
    t = np.arange(16)
    m = (np.where(t == wa[..., None], 0x0000FFFF, 0)
         | np.where(t == wb[..., None], 0xFFFF0000, 0))
    return np.bitwise_or.reduce(entries & m, axis=-1)


@pytest.mark.parametrize("pattern", WINDOW_PATTERNS)
def test_masked_select_walk_takes_each_groups_window(pattern):
    """K3's folded lanes: each lane keeps its A group's entry in the low half
    and its B group's in the high half (the group ids of the packed row
    table); K5's lanes the one window of their row."""
    rng = np.random.default_rng(3 + len(pattern))
    p, q = 1000003, 1000033
    in_limbs = 2 * tlb.limbs_for_bits(40)
    bits = 40 + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits) for h in (p, q)]
    kc2 = tr2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True)
    pack = tr2._kernel_pack(kc2)
    gidA = pack["rowc"][0, tr2._ROW_IDS.index("gidA")].numpy()
    gidB = pack["rowc"][0, tr2._ROW_IDS.index("gidB")].numpy()
    B, W = 5, pack["W"]
    A = rng.integers(0, 1 << 15, (B, W, 16))
    Bv = rng.integers(0, 1 << 15, (B, W, 16))
    entries = A | (Bv << 16)
    wins = _pattern(pattern, (2,), 15, rng)
    got = _ct_select_walk(entries, wins[gidA][None].repeat(B, 0), wins[gidB][None].repeat(B, 0))
    lanes = np.arange(W)
    assert np.array_equal(got & 0xFFFF, A[:, lanes, wins[gidA]])
    assert np.array_equal(got >> 16, Bv[:, lanes, wins[gidB]])
    wrow = _pattern(pattern, (B,), 15, rng)[:, None].repeat(W, 1)
    got = _ct_select_walk(entries, wrow, wrow)
    assert np.array_equal(got, np.take_along_axis(entries, wrow[..., None], -1)[..., 0])


@pytest.fixture(scope="module")
def crt_pair(jref):
    """A 64-bit p, q pair as the CRT decrypt folds (K3) and stacks (K5
    grouped) it, in both packages."""
    from pailliercryptolib_tpu_torch.convert import consts_from_jax
    from pailliercryptolib_tpu_torch.models.keygen import miller_rabin

    rng = random.Random(9090)

    def prime():
        while True:
            c = rng.getrandbits(64) | (1 << 63) | 1
            if miller_rabin(c):
                return c

    p, q = sorted((prime(), prime()))
    in_limbs = 2 * tlb.limbs_for_bits(128)
    bits = 128 + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [jref.jrns.RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits)
            for h in (p, q)]
    jkc2 = jref.jr2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True)
    tkc2 = consts_from_jax({k: np.asarray(v) for k, v in jkc2.items()})
    B = 8
    x = np.random.default_rng(9090).integers(0, 1 << 15, (B, in_limbs)).astype(np.int32)
    return dict(jkc2=jkc2, tkc2=tkc2, x=x, B=B)


@pytest.mark.parametrize("pattern", WINDOW_PATTERNS)
def test_folded_plain_equals_pallas_under_window_patterns(crt_pair, jref, pattern):
    """K3's plain version against pallas_rns_modexp2f (interpret mode), the
    windows of both groups' exponents in the pattern, 6 windows."""
    f = crt_pair
    wins = _pattern(pattern, (2, 6), 15, np.random.default_rng(len(pattern))).astype(np.int32)
    got = tr2.rns_modexp2f(torch.from_numpy(f["x"]), torch.from_numpy(wins), f["tkc2"])
    want = jref.jr2.pallas_rns_modexp2f(
        jref.jnp.asarray(f["x"]), jref.jnp.asarray(wins), f["jkc2"], interpret=True,
        batch_tile=f["B"], streams=4)
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def one_system(jref):
    from pailliercryptolib_tpu_torch.convert import consts_from_jax

    rng = random.Random(5151)
    N = rng.getrandbits(256) | (1 << 255) | 1
    c = jref.jrns.RNSContext.create(N)
    jkc = jref.jr2.stack_group_consts2([c])
    tkc = consts_from_jax({k: np.asarray(v) for k, v in jkc.items()})
    B = 8
    x = np.random.default_rng(5151).integers(0, 1 << 15, (1, B, c.Lin)).astype(np.int32)
    return dict(jkc=jkc, tkc=tkc, x=x, B=B)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("pattern", WINDOW_PATTERNS)
def test_generic_plain_equals_pallas_under_window_patterns(one_system, jref, pattern, shared):
    """K5's plain version against pallas_rns_modexp2 (interpret mode) with one
    shared exponent and with per-row exponents, 5 windows in the pattern."""
    f = one_system
    shape = (1, 5) if shared else (1, f["B"], 5)
    wins = _pattern(pattern, shape, 15, np.random.default_rng(len(pattern))).astype(np.int32)
    got = tr2.rns_modexp2(torch.from_numpy(f["x"]), torch.from_numpy(wins), f["tkc"],
                          shared=shared)
    want = jref.jr2.pallas_rns_modexp2(
        jref.jnp.asarray(f["x"]), jref.jnp.asarray(wins), f["jkc"], shared=shared,
        interpret=True, batch_tile=f["B"])
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# On the card: each library form and its indexed form under the patterns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU form")
    return torch.device("cuda")


def _counted(name, fn, also=()):
    """Run ``fn``; it must launch the form ``name`` once and no other (but the
    forms ``also`` counts besides it, once each: the split of the narrow
    layout)."""
    before = dict(tr2.KERNEL_FORMS)
    out = fn()
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in tr2.KERNEL_FORMS.items() if v != before[k]}
    assert made == {name: 1, **{a: 1 for a in also}}, made
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", BYTE_PATTERNS)
@pytest.mark.parametrize("bits", [1024, 4600])
def test_fixed_base_forms_on_card(dev, pattern, bits):
    """K2's one-hot form (narrow layout at 1024 bits, wide at 4600) and its
    indexed form, equal to the plain version under each byte pattern."""
    r = np.random.default_rng(bits + len(pattern))
    N = random.Random(bits).getrandbits(bits) | (1 << (bits - 1)) | 1
    kc = tr2.stack_group_consts2([RNSContext.create(N)], device=dev)
    k, NP, B = kc["sig0"].shape[-1], 3, 77
    gA = torch.from_numpy(_canonical_table(r, kc["modsA"][0].cpu(), 1)[0, :NP]).to(dev)
    gB = torch.from_numpy(_canonical_table(r, kc["modsBx"][0].cpu(), 1)[0, :NP]).to(dev)
    tabA, tabB = tr2.fb_table2(gA.to(torch.int32)[None], gB.to(torch.int32)[None], kc)
    planes, indexed = tr2.fb_gather_table(tabA, tabB), tr2.fb_indexed_table(tabA, tabB)
    wins = torch.from_numpy(_pattern(pattern, (1, B, NP), 255, r).astype(np.uint8)).to(dev)
    want = tr2.fb_modexp2_plain(planes, wins, kc, mont_out=True)
    got = _counted("fb_modexp2_tc", lambda: tr2.fb_modexp2(planes, wins, kc, mont_out=True))
    assert torch.equal(got, want)
    got = _counted("fb_modexp2_indexed",
                   lambda: tr2.fb_modexp2_indexed(indexed, wins, kc, mont_out=True))
    assert torch.equal(got, want) and k > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", WINDOW_PATTERNS)
def test_folded_forms_on_card(dev, pattern):
    """K3 and its indexed form, 256-bit primes, 12 windows in the pattern."""
    from pailliercryptolib_tpu_torch.models.keygen import get_prime

    p, q = sorted((get_prime(256), get_prime(256)))
    in_limbs = 2 * tlb.limbs_for_bits(512)
    bits = 512 + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    ctxs = [RNSContext.create(h * h, in_limbs=in_limbs, product_bits=bits) for h in (p, q)]
    kc2 = tr2.fold_group_consts2(ctxs, f32_mu=True, shared_input=True, device=dev)
    r = np.random.default_rng(len(pattern))
    x = to_i32(r.integers(0, 1 << 15, (150, in_limbs)), dev)
    wins = to_i32(_pattern(pattern, (2, 12), 15, r), dev)
    want = tr2.rns_modexp2f_plain(x, wins, kc2)
    assert torch.equal(_counted("rns_modexp2f_tc", lambda: tr2.rns_modexp2f(x, wins, kc2),
                                also=("rns_modexp2f_tc_split",)), want)
    assert torch.equal(_counted("rns_modexp2f_indexed",
                                lambda: tr2.rns_modexp2f_indexed(x, wins, kc2)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["shared", "var", "grouped"])
@pytest.mark.parametrize("pattern", WINDOW_PATTERNS)
def test_generic_forms_on_card(dev, pattern, form):
    """K5 and its indexed form in its three modes, 10 windows in the
    pattern: one 1024-bit modulus (shared, per row), the stacked f32 pair of
    256-bit primes' squares (grouped)."""
    r = np.random.default_rng(len(pattern) + len(form))
    B = 100
    if form == "grouped":
        from pailliercryptolib_tpu_torch.models.keygen import get_prime

        p, q = sorted((get_prime(256), get_prime(256)))
        L = 2 * tlb.limbs_for_bits(512)
        bits = 512 + tlb.LIMB_BITS + L.bit_length() + 1
        ctxs = [RNSContext.create(h * h, in_limbs=L, product_bits=bits) for h in (p, q)]
        kc = tr2.stack_group_consts2(ctxs, f32_mu=True, device=dev)
        shape = (2, 10)
    else:
        N = random.Random(1024).getrandbits(1024) | (1 << 1023) | 1
        ctx = RNSContext.create(N)
        kc = tr2.stack_group_consts2([ctx], device=dev)
        L = ctx.Lin
        shape = (1, 10) if form == "shared" else (1, B, 10)
    shared = form != "var"
    x = to_i32(r.integers(0, 1 << 15, (1, B, L)), dev)
    wins = to_i32(_pattern(pattern, shape, 15, r), dev)
    want = tr2.rns_modexp2_plain(x, wins, kc, shared=shared)
    got = _counted("rns_modexp2_tc", lambda: tr2.rns_modexp2(x, wins, kc, shared=shared))
    assert torch.equal(got, want)
    got = _counted("rns_modexp2_indexed",
                   lambda: tr2.rns_modexp2_indexed(x, wins, kc, shared=shared))
    assert torch.equal(got, want)
