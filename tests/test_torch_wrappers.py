"""The list-returning engine wrappers, ``mod_mul_stage`` and ``carry_round2``
of the port against the JAX package's functions of the same names, on the CPU.

The wrappers (``PublicEngine.encrypt_djn`` / ``encrypt_normal`` /
``encrypt_noobf`` / ``add_ctct`` / ``mul_ctpt``, ``PrivateEngine.decrypt_crt``
/ ``decrypt_raw``) run on a 256-bit DJN key built in both packages from the
same p, q, hs (``convert.keys_from_ints``), the port's engines on ``"rns"``
and ``"cios"`` (their kernels' plain versions on CPU tensors), the JAX
engines on ``"xla"``, with the same injected obfuscators.  Each wrapper's list
equals the JAX wrapper's, the port's ``*_dev(...).fetch()`` and the ``pow()``
oracle.  ``mod_mul_stage`` at 18 and 69 limbs against the JAX stage on
``"xla"`` and Python ints; ``carry_round2`` on random redundant digits.
Tolerance: none, integers must be equal."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import pailliercryptolib_tpu as ptpu
from pailliercryptolib_tpu.ops import montgomery as jmg
from pailliercryptolib_tpu.ops import paillier_ops as jops
from pailliercryptolib_tpu.ops.limbs import ints_to_limbs, limbs_to_ints
from pailliercryptolib_tpu_torch.convert import keys_from_ints
from pailliercryptolib_tpu_torch.models.engine import DevLimbs, sync_device
from pailliercryptolib_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_tpu_torch.ops import paillier_ops as tops
from test_torch_slice import _djn_ints

BITS, ROWS = 256, 5
PORT_BACKENDS = ("rns", "cios")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: torch's intra-op threads only cost under test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case():
    """One key in both packages, inputs from a seed, and the JAX wrappers'
    lists (computed once, on "xla")."""
    n, p, q, hs, randbits = _djn_ints(BITS, seed=1401)
    n2 = n * n
    rng = random.Random(1402)
    m = [0, n - 1] + [rng.randrange(n) for _ in range(ROWS - 2)]
    r_djn = [0, (1 << randbits) - 1] + [rng.getrandbits(randbits) for _ in range(ROWS - 2)]
    r_normal = [1] + [rng.randrange(1, n) for _ in range(ROWS - 1)]
    ca = [rng.randrange(n2) for _ in range(ROWS)]
    cb = [rng.randrange(n2) for _ in range(ROWS)]
    pt = [0, 1] + [rng.getrandbits(64) for _ in range(ROWS - 2)]
    scalar = [rng.getrandbits(64)]
    # ciphertexts of known plaintexts for the decrypts
    dec_m = [rng.randrange(n) for _ in range(ROWS)]
    dec_ct = [(n * v + 1) * pow(rng.randrange(1, n), n, n2) % n2 for v in dec_m]

    jpk = ptpu.PublicKey(n, BITS, hs=hs, randbits=randbits)
    jsk = ptpu.PrivateKey(jpk, p, q)
    jpe, jse = jpk._engine, jsk._engine
    jpe.backend = jse.backend = "xla"
    calls = {
        "encrypt_djn": ((m, r_djn), [(n * a + 1) * pow(hs, r, n2) % n2
                                     for a, r in zip(m, r_djn)]),
        "encrypt_normal": ((m, r_normal), [(1 + n * a) * pow(r, n, n2) % n2
                                           for a, r in zip(m, r_normal)]),
        "encrypt_noobf": ((m,), [(1 + n * a) % n2 for a in m]),
        "add_ctct": ((ca, cb), [a * b % n2 for a, b in zip(ca, cb)]),
        "mul_ctpt": ((ca, pt), [pow(a, e, n2) for a, e in zip(ca, pt)]),
        "mul_ctpt[scalar]": ((ca, scalar), [pow(a, scalar[0], n2) for a in ca]),
        "decrypt_crt": ((dec_ct,), dec_m),
        "decrypt_raw": ((dec_ct,), dec_m),
    }
    jax_out = {}
    for what, (args, _) in calls.items():
        name = what.split("[")[0]
        eng = jse if name.startswith("decrypt") else jpe
        jax_out[what] = getattr(eng, name)(*args)
    return dict(ints=(n, p, q, hs, randbits), calls=calls, jax=jax_out)


@pytest.fixture(scope="module", params=PORT_BACKENDS)
def port(request, case):
    key = keys_from_ints(*case["ints"], device="cpu")
    pe, se = key.pub_key._engine, key.priv_key._engine
    pe.backend = se.backend = request.param
    return pe, se


@pytest.mark.parametrize("what", [
    "encrypt_djn", "encrypt_normal", "encrypt_noobf", "add_ctct", "mul_ctpt",
    "mul_ctpt[scalar]", "decrypt_crt", "decrypt_raw"])
def test_wrapper_equals_jax_dev_and_oracle(case, port, what):
    name = what.split("[")[0]
    eng = port[1] if name.startswith("decrypt") else port[0]
    args, oracle = case["calls"][what]
    got = getattr(eng, name)(*args)
    assert isinstance(got, list)
    assert got == oracle
    assert got == case["jax"][what]
    dev = getattr(eng, name + "_dev")(*args)
    assert isinstance(dev, DevLimbs) and dev.fetch() == got


def test_sync_device_returns(case, port):
    dev = port[0].encrypt_noobf_dev(case["calls"]["encrypt_noobf"][0][0])
    assert sync_device(dev) is None
    assert dev.fetch() == case["calls"]["encrypt_noobf"][1]


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.mark.parametrize("bits", [256, 1024])  # 18 and 69 limbs
@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared_b"])
@pytest.mark.parametrize("backend", ["rns", "cios", "plain", None])
def test_mod_mul_stage_equals_jax(bits, shared, backend):
    rng = random.Random(bits * 7 + shared)
    n = _odd(rng, bits)
    jc, tc = jmg.MontConstants.create(n), tmg.MontConstants.create(n)
    L = tc.num_limbs
    assert L == (18 if bits == 256 else 69)
    a = [0, n - 1] + [rng.randrange(n) for _ in range(ROWS - 2)]
    b = [rng.randrange(n)] if shared else [n - 1] + [rng.randrange(n) for _ in range(ROWS - 1)]
    a_l, b_l = ints_to_limbs(a, L), ints_to_limbs(b, L)
    if shared:
        b_l = b_l[0]
    jn, jn0, jr2, _ = jc.as_device_args()
    want = jops.mod_mul_stage(jnp.asarray(a_l), jnp.asarray(b_l), jn, jn0, jr2,
                              backend="xla")
    tn, tn0, tr2, _ = tc.as_device_args("cpu")
    got = tops.mod_mul_stage(tmg.to_i32(a_l, "cpu"), tmg.to_i32(b_l, "cpu"), tn, tn0,
                             tr2, backend=backend)
    assert got.shape == (ROWS, L) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    bb = b * ROWS if shared else b
    assert limbs_to_ints(got.numpy().astype(np.uint32)) == [
        x * y % n for x, y in zip(a, bb)]


def test_mod_mul_stage_rejects_an_unknown_backend():
    tc = tmg.MontConstants.create(_odd(random.Random(3), 256))
    n_, n0, r2, _ = tc.as_device_args("cpu")
    x = torch.zeros((2, tc.num_limbs), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.mod_mul_stage(x, x, n_, n0, r2, backend="pallas")


@pytest.mark.parametrize("top", [26, 30])
def test_carry_round2_equals_jax(top):
    """Redundant digits below 2**top (the top digit small enough that no
    carry leaves the last limb), 3 x 24 of them."""
    x = np.random.default_rng(top).integers(0, 1 << top, (3, 24), dtype=np.int64)
    x[:, -2:] = 0
    got = tmg.carry_round2(torch.from_numpy(x).to(torch.int32))
    want = np.asarray(jmg.carry_round2(jnp.asarray(x.astype(np.uint32))))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert _values(got.numpy()) == _values(x)  # the value is kept


def _values(digits):
    return [sum(int(v) << (15 * i) for i, v in enumerate(row)) for row in digits]
