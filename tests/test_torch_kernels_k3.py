"""K3, the CRT-folded modexp: its plain version against the Pallas kernel
it replaces (interpret mode on the CPU) and against Python pow(), in the
configuration that ships.  Split from test_torch_kernels.py, whose helpers it
uses, so that pytest-xdist's ``--dist loadfile`` runs these interpret-mode
fixtures on a worker of their own.  Tolerance: exact integer equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as lb  # noqa: E402
from pailliercryptolib_tpu.ops import pallas_rns2 as jr2  # noqa: E402
from pailliercryptolib_tpu.ops import rns as jrns  # noqa: E402
from pailliercryptolib_tpu_torch.convert import consts_from_jax  # noqa: E402
from pailliercryptolib_tpu_torch.ops import cuda_rns2  # noqa: E402
from pailliercryptolib_tpu_torch.ops import rns as trns  # noqa: E402
from test_torch_kernels import (  # noqa: E402,F401  (_one_torch_thread: autouse)
    B, _eq, _ints, _np_dict, _one_torch_thread, _prime, _t,
)


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
