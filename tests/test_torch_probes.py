"""The instruction-rate probes P1-P4 of the PyTorch/CUDA port: each plain
version against the kernel body of the Pallas probe it replaces, run in
interpret mode on the CPU, on the same numpy inputs.  Tolerance: bit equality
(the float chains too).

The probe scripts under ``benchmarks/`` time a TPU when they are run and one
of them launches its kernels at import, so they are not imported: their
kernel bodies (function definitions, the table of ops, the ``lambda`` steps
handed to ``run``) are read out of the files' syntax trees and compiled as
they stand.  The shapes here are a few rows of the probes' own widths; the
step counts are the probes' own."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.experimental import pallas as pl

from pailliercryptolib_tpu_torch.ops import cuda_probes as cp

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(name):
    with open(os.path.join(BENCH, name)) as f:
        return ast.parse(f.read())


def _defs(name, wanted):
    """The top-level functions and assignments ``wanted`` of a probe script,
    compiled in a namespace that holds what the scripts import."""
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl}
    body = [
        node for node in _tree(name).body
        if (isinstance(node, ast.FunctionDef) and node.name in wanted)
        or (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in wanted)
    ]
    assert len(body) == len(wanted), (name, wanted)
    exec(compile(ast.Module(body=body, type_ignores=[]), name, "exec"), ns)
    return ns


def _interpret(kernel, out_like, *operands, grid=None, specs=None, out_spec=None):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_like.shape, out_like.dtype),
        interpret=True,
        **({} if grid is None else dict(grid=grid, in_specs=specs, out_specs=out_spec)),
    )(*[jnp.asarray(a) for a in operands]))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


# -- P1 ------------------------------------------------------------------------


@pytest.mark.parametrize("tag,shape,byrow", cp.P1_CASES)
def test_p1_barrett_chain_matches_pallas(tag, shape, byrow):
    ns = _defs("probe_layout.py", ("ITERS", "GRID", "chain_kernel"))
    assert (ns["ITERS"], ns["GRID"], cp.P1_MODULUS) == (cp.P1_ITERS, cp.P1_GRID, 12289)
    full = cp.make_inputs("p1", shape)
    assert full.shape == (32,) + shape and full.dtype == np.uint32
    # a few rows (batch-major) or a few columns (residue-major) of the probe's
    # input: the constants' axis keeps its length
    x = np.ascontiguousarray(full[:2, :, :8] if byrow else full[:2, :8, :])
    R, C = x.shape[1:]
    cshape = (R, 1) if byrow else (1, C)
    m = np.full(cshape, 12289, np.uint32)
    mu = np.full(cshape, (1 << 28) // 12289, np.uint32)
    want = _interpret(
        ns["chain_kernel"], x, m, mu, x, grid=(x.shape[0],),
        specs=[pl.BlockSpec(cshape, lambda i: (0, 0)),
               pl.BlockSpec(cshape, lambda i: (0, 0)),
               pl.BlockSpec((1, R, C), lambda i: (i, 0, 0))],
        out_spec=pl.BlockSpec((1, R, C), lambda i: (i, 0, 0)))
    got = cp.barrett_chain_plain(
        cp.to_words(x, "cpu"), cp.to_words(m.reshape(-1), "cpu"),
        cp.to_words(mu.reshape(-1), "cpu"), byrow)
    assert np.array_equal(_bits(got), _bits(want))
    assert int(want.max()) < 12289  # the chain stays reduced


# -- P2 ------------------------------------------------------------------------


def _p2_steps():
    """tag -> (step lambda, dtype name) out of probe_ops.py's ``run`` calls."""
    steps = {}
    for node in ast.walk(_tree("probe_ops.py")):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "run"
                and isinstance(node.args[0], ast.Lambda)):
            fn = eval(compile(ast.Expression(node.args[0]), "probe_ops.py", "eval"),
                      {"jnp": jnp})
            f32 = any(k.arg == "dtype" and "float32" in ast.unparse(k.value)
                      for k in node.keywords)
            steps[node.args[1].value] = (fn, f32)
    return steps


_P2_STEPS = _p2_steps()


def test_p2_chain_list_is_the_probes():
    assert set(_P2_STEPS) == {tag for tag, _ in cp.P2_CHAINS}
    assert len(cp.P2_CHAINS) == 11 and len(cp.P4_CHAINS) == 7
    ns = _defs("probe_ops.py", ("ITERS", "GRID", "SHAPE"))
    assert (ns["GRID"],) + ns["SHAPE"] == cp.P2_SHAPE and ns["ITERS"] == cp.P2_ITERS


@pytest.mark.parametrize("tag,op", cp.P2_CHAINS)
def test_p2_op_chain_matches_pallas(tag, op):
    ns = _defs("probe_ops.py", ("ITERS", "make_kernel"))
    step, f32 = _P2_STEPS[tag]
    assert f32 == (op in ("fmul", "fmul_add"))
    xf, c = cp.make_inputs("p2", op)
    assert xf.shape == cp.P2_SHAPE and c.shape == (1, 256)
    x = np.ascontiguousarray(xf[:2, :4])  # [2, 4, 256]
    want = _interpret(
        ns["make_kernel"](step), x, c, x, grid=(2,),
        specs=[pl.BlockSpec((1, 256), lambda i: (0, 0)),
               pl.BlockSpec((1, 4, 256), lambda i: (i, 0, 0))],
        out_spec=pl.BlockSpec((1, 4, 256), lambda i: (i, 0, 0)))
    got = cp.op_chain_plain(cp.to_words(x, "cpu"), cp.to_words(c, "cpu"), op,
                            cp.P2_ITERS)
    assert np.array_equal(_bits(got), _bits(want)), tag


# -- P3 ------------------------------------------------------------------------


def test_p3_products_match_pallas_and_numpy():
    ns = _defs("probe_i8mm.py", ("kernel_i8", "kernel_f32"))
    x, t = cp.make_inputs("p3")
    assert x.shape == (128, 152) and t.shape == (152, 152) and int(x.max()) < 128
    want = x.astype(np.int64) @ t.astype(np.int64)
    out_i = _interpret(ns["kernel_i8"], np.zeros((128, 152), np.int32), x, t)
    out_f = _interpret(ns["kernel_f32"], np.zeros((128, 152), np.float32), x, t)
    assert np.array_equal(out_i.astype(np.int64), want)
    assert np.array_equal(out_f.astype(np.int64), want)
    x8, t8 = torch.from_numpy(x.astype(np.int8)), torch.from_numpy(t.astype(np.int8))
    xp, tTp = cp.pack_i8(x8, t8)
    assert xp.shape == (128, 160) and tTp.shape == (152, 160)
    assert not bool(xp[:, 152:].any()) and torch.equal(tTp[:, :152], t8.t())
    got_i = cp.i8mm_plain(xp, tTp)
    assert got_i.dtype == torch.int32 and np.array_equal(got_i.numpy(), out_i)
    assert np.array_equal(cp.i8mm_plain(xp, tTp, reps=3).numpy().astype(np.int64), 3 * want)
    got_f = cp.f32mm_plain(x8.to(torch.float32), t8.to(torch.float32))
    assert got_f.dtype == torch.float32
    assert np.array_equal(_bits(got_f), _bits(out_f))


# -- P4 ------------------------------------------------------------------------


@pytest.mark.parametrize("tag,op", cp.P4_CHAINS)
def test_p4_op_chain_matches_pallas(tag, op):
    ns = _defs("probe_vpu_ops.py", ("REPS", "SHAPE", "_mk", "OPS", "F32_OPS"))
    assert ns["REPS"] == cp.P4_ITERS and ns["SHAPE"] == cp.P4_SHAPE
    fn = {**ns["OPS"], **ns["F32_OPS"]}[tag]
    x, y = cp.make_inputs("p4", op)
    assert x.shape == cp.P4_SHAPE and x.dtype == (np.float32 if tag[0] == "f" else np.uint32)
    x, y = np.ascontiguousarray(x[:4]), np.ascontiguousarray(y[:4])
    want = _interpret(ns["_mk"](fn), x, x, y)
    got = cp.op_chain_plain(cp.to_words(x, "cpu"), cp.to_words(y, "cpu"), op, cp.P4_ITERS)
    assert np.array_equal(_bits(got), _bits(want)), tag


# -- the lagged chains (no counterpart in the reference: against numpy) ----------------


def _lag_numpy(x, c, op, iters):
    mask = np.uint64(0xFFFFFFFF)
    a = x.astype(np.uint64)
    b = np.broadcast_to(c, x.shape).astype(np.uint64)
    d, e = a ^ mask, (a + b) & mask
    for _ in range(iters):
        if op == "add_lag":
            t = (a + b) & mask
        elif op == "lop3_lag":
            t = (a & b) ^ (~a & mask & e)
        else:
            t = (((b << np.uint64(32)) | a) >> (d & np.uint64(31))) & mask
        a, b, d, e = t, a, b, d
    return a.astype(np.uint32)


@pytest.mark.parametrize("tag,op", cp.LAG_CHAINS)
def test_lag_chain_plain_matches_numpy(tag, op):
    xf, c = cp.make_inputs("p2", "add")
    x = np.ascontiguousarray(xf[:2, :4])
    xt, ct = cp.to_words(x, "cpu"), cp.to_words(c, "cpu")
    for iters in (13, cp.P2_ITERS):
        want = _lag_numpy(x, c, op, iters)
        assert np.array_equal(_bits(cp.lag_chain_plain(xt, ct, op, iters)), _bits(want)), tag
    # the chain does not collapse to a few values (the funnel shift drains
    # bits and settles at some 400 distinct ones of these 2048)
    assert len(np.unique(want)) > want.size // 8
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.lag_chain(xt, ct, op, 4)


# -- the wrappers -------------------------------------------------------------------


def test_probe_wrappers_have_no_cpu_path():
    """A probe wrapper launches its kernel on a CUDA tensor or raises; the
    plain versions are reached by name only and count no launch."""
    before = dict(cp.LAUNCHES)
    x = cp.to_words(cp.make_inputs("p4", "add")[0][:2], "cpu")
    m = torch.full((512,), 12289, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.op_chain(x, x, "add", 4)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.barrett_chain(x[None], m, m, False, iters=4)
    x8 = torch.zeros((16, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.i8mm(*cp.pack_i8(x8, x8.t().contiguous()))
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.f32mm(x8.float(), x8.t().contiguous().float())
    with pytest.raises(ValueError, match="unknown primitive"):
        cp.op_chain(x, x, "div", 4)
    with pytest.raises(ValueError, match="unknown lagged chain"):
        cp.lag_chain(x, x, "add", 4)
    folded = {"maskB": torch.ones(4, dtype=torch.int32), "sig0": torch.zeros((1, 2))}
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.mont_chain(x, folded, 2)
    assert cp.LAUNCHES == before == {"barrett_chain": 0, "op_chain": 0, "lag_chain": 0,
                                     "i8mm": 0, "f32mm": 0, "mont_chain": 0}
    assert sorted(cp.OPS.values()) == list(range(14))
    # wrap-around as the 32-bit registers do it
    big = torch.tensor([[-1, 1 << 30]], dtype=torch.int32)  # 0xFFFFFFFF, 2^30
    assert cp.op_chain_plain(big, big, "mul_self", 1).tolist() == [[1, 0]]
    assert cp.op_chain_plain(big, big, "add", 1).tolist() == [[-2, -(1 << 31)]]
