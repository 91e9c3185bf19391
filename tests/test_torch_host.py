"""Host layer of the PyTorch/CUDA port against the JAX package: codecs and
every precomputed constant.  Tolerance: exact equality everywhere."""

import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as jlb
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops import pallas_rns2 as jr2
from pailliercryptolib_tpu.ops import rns as jrns
from pailliercryptolib_tpu_torch.ops import cuda_rns2 as tr2
from pailliercryptolib_tpu_torch.ops import limbs as tlb
from pailliercryptolib_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_tpu_torch.ops import rns as trns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _np(t):
    """Port tensor -> numpy in the JAX package's dtype convention."""
    a = t.numpy()
    return a.astype(np.uint32) if a.dtype == np.int32 else a


def _assert_same(got, want, key):
    want = np.asarray(want)
    assert got.shape == want.shape, key
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    assert np.array_equal(got, want), key


@pytest.mark.parametrize("bits,L", [(64, 8), (1024, 69), (4096, 274)])
def test_limb_codecs_equal(bits, L):
    rng = random.Random(bits)
    xs = [rng.getrandbits(bits) for _ in range(9)] + [0, 1, (1 << bits) - 1]
    got = tlb.ints_to_limbs(xs, L)
    assert np.array_equal(got, jlb.ints_to_limbs(xs, L))
    assert tlb.limbs_to_ints(got) == xs == jlb.limbs_to_ints(got)
    assert np.array_equal(tlb.pack_pairs_np(got), jlb.pack_pairs_np(got))
    assert np.array_equal(
        tlb.unpack_pairs_np(tlb.pack_pairs_np(got), L), got
    )
    assert tlb.limbs_for_bits(bits) == jlb.limbs_for_bits(bits)


@pytest.mark.parametrize("ebits", [12, 64, 1024])
def test_window_and_byte_codecs_equal(ebits):
    rng = random.Random(ebits)
    es = [rng.getrandbits(ebits) for _ in range(7)] + [0, 1, (1 << ebits) - 1]
    assert np.array_equal(
        tlb.ints_to_windows(es, ebits), jlb.ints_to_windows(es, ebits)
    )
    nb = -(-ebits // 8) + 3
    assert np.array_equal(
        tlb.ints_to_bytes_le(es, nb), jlb.ints_to_bytes_le(es, nb)
    )
    assert tlb.num_windows(ebits) == jlb.num_windows(ebits)
    assert tlb.max_bitlength(es) == jlb.max_bitlength(es)


@pytest.mark.parametrize("bits", [256, 1024, 2048])
def test_mont_constants_equal(bits):
    N = _odd(random.Random(bits + 1), bits)
    a, b = tmg.MontConstants.create(N), jmg.MontConstants.create(N)
    assert (a.num_limbs, a.n0inv, a.nbits) == (b.num_limbs, b.n0inv, b.nbits)
    for f in ("n_limbs", "r2_limbs", "one_limbs"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    n, n0, r2, one = a.as_device_args("cpu")
    assert n.dtype == torch.int32 and n0 == b.n0inv
    assert np.array_equal(_np(r2), b.r2_limbs) and np.array_equal(_np(one), b.one_limbs)


_CTX_FIELDS_ARR = (
    "mods", "barrett", "neg_Ninv_A", "MAi_inv_A", "sigma_c_A", "T1ext",
    "inv_a_f32", "T1", "MA_mod_B", "N_B", "MAinv_B", "MBj_inv_B", "T2", "T2r",
    "MB_mod_A", "Cin", "Aout_limbs", "MA_limbs", "mont_sq", "mont_one",
    "plain_one",
)
_CTX_FIELDS_INT = ("N", "k", "K", "MA", "MB", "mr", "MBinv_mr", "Lin", "Lout")


def _ctx_pair(N, **kw):
    return trns.RNSContext.create(N, **kw), jrns.RNSContext.create(N, **kw)


def _assert_ctx_equal(a, b):
    for f in _CTX_FIELDS_INT:
        assert getattr(a, f) == getattr(b, f), f
    for f in _CTX_FIELDS_ARR:
        _assert_same(getattr(a, f), getattr(b, f), f)


def _assert_consts_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        _assert_same(_np(got[key]), want[key], key)


@pytest.fixture(scope="module", params=[256, 1024, 2048])
def ctxs(request):
    bits = request.param
    N = _odd(random.Random(bits + 7), bits)
    return _ctx_pair(N)


def test_rns_context_equal(ctxs):
    a, b = ctxs
    _assert_ctx_equal(a, b)
    assert trns.is_wide_pool(a) == jrns.is_wide_pool(b)


def test_rns_device_consts_equal(ctxs):
    a, b = ctxs
    got = a.device_consts("cpu")
    want = b.device_consts()
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        _assert_same(_np(got[key]).reshape(w.shape), w, key)


@pytest.mark.parametrize("f32_mu", [False, True])
def test_stack_group_consts2_equal(ctxs, f32_mu):
    a, b = ctxs
    _assert_consts_equal(
        tr2.stack_group_consts2([a], f32_mu=f32_mu),
        jr2.stack_group_consts2([b], f32_mu=f32_mu),
    )


def _crt_pair(pbits, seed):
    """(p^2, q^2) contexts as the engines build them: full n^2-width input
    and product_bits sized above it."""
    rng = random.Random(seed)
    p, q = _odd(rng, pbits), _odd(rng, pbits)
    Lp2 = tlb.limbs_for_bits(2 * pbits)
    in_limbs = 2 * Lp2
    bits = 2 * pbits + tlb.LIMB_BITS + in_limbs.bit_length() + 1
    mine, theirs = [], []
    for h in (p, q):
        a, b = _ctx_pair(h * h, in_limbs=in_limbs, product_bits=bits)
        mine.append(a)
        theirs.append(b)
    return mine, theirs


@pytest.mark.parametrize("pbits", [128, 512, 1024])
def test_fold_group_consts2_crt_pair_equal(pbits):
    mine, theirs = _crt_pair(pbits, seed=pbits)
    for a, b in zip(mine, theirs):
        _assert_ctx_equal(a, b)
    assert mine[0].k == mine[1].k
    _assert_consts_equal(
        tr2.fold_group_consts2(mine, f32_mu=True, shared_input=True),
        jr2.fold_group_consts2(theirs, f32_mu=True, shared_input=True),
    )


def test_fold_group_consts2_block_diagonal_equal():
    mine, theirs = _crt_pair(128, seed=5)
    _assert_consts_equal(
        tr2.fold_group_consts2(mine), jr2.fold_group_consts2(theirs)
    )


def test_alloc_bases_quantized_k():
    """k is a function of the key-size class only (quantized target)."""
    rng = random.Random(3)
    ks = {trns.RNSContext.create(_odd(rng, 512)).k for _ in range(3)}
    assert len(ks) == 1
    assert trns._alloc_bases(4096)[1] == jrns._alloc_bases(4096)[1]


def test_kernel_pack_layout():
    """The device-side packing of a constant set, one slab per group: row
    table, 4-to-a-word weight planes (little-endian, contraction row 4*i4+e
    in byte e), interleaved Cin weights."""
    a, _ = _ctx_pair(_odd(random.Random(11), 256))
    kc = tr2.stack_group_consts2([a])
    p = tr2._kernel_pack(kc)
    k, W = p["k"], p["W"]
    assert W % 32 == 0 and W >= k + 2 and p["kb"] == k + 1 and not p["f32"]
    assert tr2._kernel_pack(kc) is p  # cached in the dict
    assert p["G"] == 1 and p["rowc"].shape == (1, len(tr2._ROW_IDS), W)
    rows = dict(zip(tr2._ROW_IDS, p["rowc"][0]))
    assert torch.equal(rows["sig0"][:k], kc["sig0"][0])
    assert torch.equal(rows["winv"][: k + 1], kc["winv"][0])
    assert int(rows["mr"][0]) == a.mr and int(rows["twomr"][0]) == 2 * a.mr
    T1 = p["T1"][0].numpy().view(np.int8).reshape(-1, W, 2, 4)  # [k4, W, lo/hi, e]
    lo = T1[:, :, 0, :].transpose(0, 2, 1).reshape(-1, W)[:k, : k + 2]
    hi = T1[:, :, 1, :].transpose(0, 2, 1).reshape(-1, W)[:k, : k + 2]
    assert np.array_equal(lo, kc["T1lo"][0].numpy())
    assert np.array_equal(hi, kc["T1hi"][0].numpy())
    assert torch.equal(p["Cin"][0, :, :k, 0], kc["CinA"][0])
    assert torch.equal(p["Cin"][0, :, : k + 1, 1], kc["CinB"][0])
    # a stacked pair packs group by group
    b, _ = _ctx_pair(_odd(random.Random(12), 256))
    p2 = tr2._kernel_pack(tr2.stack_group_consts2([a, b], f32_mu=True))
    assert p2["G"] == 2 and p2["f32"] and p2["T2"].shape[0] == 2
    assert torch.equal(p2["T1"][0], p["T1"][0])  # the planes do not depend on mu
    assert int(p2["rowc"][1][tr2._ROW_IDS.index("mr"), 0]) == b.mr


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with ``jax`` and
    the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['pailliercryptolib_tpu'] = None\n"
        "import pailliercryptolib_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(names) >= 19, names\n"
        "for n in ('ops.dispatch', 'ops.api', 'ops.cuda_modexp', 'ops.cuda_probes',\n"
        "          'utils.serialize'):\n"
        "    assert p.__name__ + '.' + n in names, n\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'pailliercryptolib_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_without_gpu_raises():
    """device='cuda' (the default) never carries on on the CPU."""
    import pailliercryptolib_tpu_torch as ptorch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError):
        ptorch.generate_keypair(256)
    with pytest.raises(RuntimeError):
        ptorch.PublicKey(3 * 5, 8)


def test_build_library_named_by_sources_and_flags(monkeypatch):
    """The library's path lies in ``build/`` of the repository and changes
    with a compiler flag, so a stale library is never loaded."""
    from pailliercryptolib_tpu_torch.ops import _build

    here = _build.lib_path()
    assert here.parent == pathlib.Path(REPO) / "build" and here.suffix == ".so"
    assert _build.lib_path() == here
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.lib_path() != here


def test_build_parses_ptxas_report():
    from pailliercryptolib_tpu_torch.ops import _build

    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN4prns17fb_modexp2_kernelEPKiPKhPKjPK4int2S8_Piiii4Dims' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4prns17fb_modexp2_kernelE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 5440 bytes smem, "
        "600 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'mod_mul_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for mod_mul_kernel\n"
        "    608 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 412 bytes cmem[0]\n"
    )
    assert _build.parse_ptxas(report) == [
        {"kernel": "fb_modexp2_kernel", "registers": 96, "smem_bytes": 5440,
         "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0},
        {"kernel": "mod_mul_kernel", "registers": 40, "smem_bytes": 0,
         "stack_bytes": 608, "spill_store_bytes": 8, "spill_load_bytes": 12},
    ]


def test_build_names_integer_template_kernels():
    """The CIOS kernels are templates over the digits a lane holds."""
    from pailliercryptolib_tpu_torch.ops import _build

    assert _build._kernel_name("_ZN4cios13modexp_kernelILi9EEEvPKixxS2_") == "modexp_kernel<9>"
    assert _build._kernel_name("_ZN4cios14mod_mul_kernelILi18EEEvPKi") == "mod_mul_kernel<18>"
    assert {"mod_mul_launch", "mont_raw_launch", "modexp_launch"} <= set(_build.SIGNATURES)
    sources = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"modexp.cu", "mont_raw.cu", "mod_mul.cu", "cios_mont_mul.cuh"} <= sources


def test_config_backend_and_seed_materialize(monkeypatch):
    from pailliercryptolib_tpu_torch.utils import config, rng

    monkeypatch.delenv("PAILLIER_TORCH_BACKEND", raising=False)
    assert config.Config.from_env().backend is None and config.Config().backend is None
    monkeypatch.setenv("PAILLIER_TORCH_BACKEND", "plain")
    assert config.Config.from_env().backend == "plain"
    drawn = rng.DeviceSeed().materialize(9, 13)
    assert drawn.dtype == np.uint8 and drawn.shape == (9, 2)
    assert int(drawn[:, 1].max()) < 1 << 5  # 13 bits: the top byte keeps 5
    assert not np.array_equal(drawn, rng.DeviceSeed().materialize(9, 13))


def test_build_without_nvcc_raises(monkeypatch):
    """No compiler: the build raises, nothing stands in for the kernels."""
    from pailliercryptolib_tpu_torch.ops import _build

    if _build.lib_path().exists():
        pytest.skip("the library is already built here")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
