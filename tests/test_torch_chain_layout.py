"""The P2 / P4 chain kernel of the PyTorch/CUDA port (``chain_kernel<OP, E>``,
``csrc/probe_chain.cu``): a Python model of its index arithmetic, run on the
CPU, and the kernel against its plain version on a GPU.

The model restates the kernel's thread -> element map as the source writes
it: the grid ``min(ceil(ceil(n / E) / 128), SMs x resident blocks)``, thread
t of block b taking the groups g = b * 128 + t + k * grid * 128 below
ceil(n / E), group g the elements g * E .. g * E + E - 1 below n, the
operand index run from g * E % cmod either as one vector (a whole group,
cmod a multiple of E) or word by word, wrapping at cmod.  It must cover
every element exactly once with the operand ``c[idx % cmod]``, for P2's and
P4's shapes, ragged n and both operand lengths.  The SASS helpers that
``chip_smoke.py`` holds the step table with are checked on made-up dumps.

The GPU cases need an NVIDIA GPU and ``nvcc`` and skip without one; the file
imports nothing of JAX:

    python -m pytest tests/test_torch_chain_layout.py -q --noconftest -o addopts="" -m cuda
"""

from collections import Counter

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.ops import cuda_probes as cp

T = cp.CHAIN_THREADS
SMS = 132  # an H100 SXM's SMs
P2_N = int(np.prod(cp.P2_SHAPE))
P4_N = int(np.prod(cp.P4_SHAPE))


def model_grid(n, elems, sm_count, per_sm):
    need = -(-(-(-n // elems)) // T)
    return min(need, sm_count * per_sm)


def model_layout(n, cmod, elems, sm_count=SMS, per_sm=16):
    """Per element: the global thread that computes it and the operand
    index it reads, as chain_kernel<OP, E> computes them."""
    groups = -(-n // elems)
    grid = model_grid(n, elems, sm_count, per_sm)
    stride = grid * T
    rounds = -(-groups // stride)
    g = (np.arange(stride)[None, :] + np.arange(rounds)[:, None] * stride).ravel()
    g = g[g < groups]
    thread = g % stride
    i0 = g * elems
    whole = i0 + elems <= n
    vec_c = cmod % elems == 0
    thread_of = np.full(n, -1, np.int64)
    c_of = np.full(n, -1, np.int64)
    hits = np.zeros(n, np.int64)
    ci0 = i0 % cmod
    for e in range(elems):
        idx = i0 + e
        ok = idx < n
        vector = whole & vec_c
        # vector run: c[ci0 + e]; word by word: the index wraps at cmod
        ci = np.where(vector, ci0 + e, (ci0 + e) % cmod)
        np.add.at(hits, idx[ok], 1)
        thread_of[idx[ok]] = thread[ok]
        c_of[idx[ok]] = ci[ok]
        assert (ci[ok] < cmod).all()
    return {"grid": grid, "hits": hits, "thread": thread_of, "c": c_of,
            "groups_per_block": np.bincount(g % stride // T, minlength=grid)}


CASES = [(P2_N, cp.P2_SHAPE[-1]), (P2_N, P2_N), (P4_N, P4_N), (P4_N, cp.P4_SHAPE[-1])]
RAGGED = [1, 255, 1000, 131_073]


@pytest.mark.parametrize("elems", cp.CHAIN_ELEMS)
@pytest.mark.parametrize("n,cmod", CASES + [(n, 7) for n in RAGGED]
                         + [(n, n) for n in RAGGED] + [(n, 256) for n in RAGGED])
def test_layout_covers_every_element_once(n, cmod, elems):
    lay = model_layout(n, cmod, elems)
    assert (lay["hits"] == 1).all()
    assert np.array_equal(lay["c"], np.arange(n) % cmod)
    # every block resident from the start, shares within one chunk of T groups
    assert lay["grid"] <= SMS * 16
    per_block = lay["groups_per_block"]
    assert per_block.max() - per_block.min() <= T
    # a thread's elements are contiguous runs of E
    first = lay["thread"][: (n // elems) * elems].reshape(-1, elems)
    assert (first == first[:, :1]).all()


@pytest.mark.parametrize("n,cmod", CASES)
def test_reference_shapes_pick_vector_loads(n, cmod):
    """At the probes' shapes the library's E divides the operand's length
    (one vector load of the operands a group) and n (no ragged group)."""
    elems = cp.chain_elems(n, cmod)
    assert elems in cp.CHAIN_ELEMS
    assert cmod % elems == 0 and n % elems == 0
    lay = model_layout(n, cmod, elems)
    assert (lay["hits"] == 1).all()


def test_grid_is_sm_balanced_at_p4():
    """P4's 131 072 elements: at every E the blocks hold whole chunks and the
    SMs' shares of warps differ by at most one warp a scheduler."""
    for elems in cp.CHAIN_ELEMS:
        per_sm = 16
        grid = model_grid(P4_N, elems, SMS, per_sm)
        warps = -(-P4_N // elems) // 32
        assert grid <= SMS * per_sm
        # blocks handed out round robin: an SM's blocks differ by at most one
        blocks = np.bincount(np.arange(grid) % SMS, minlength=SMS)
        assert blocks.max() - blocks.min() <= 1
        assert warps == grid * (T // 32) or grid == SMS * per_sm


def test_block_steps_keep_the_counter_under_five_percent():
    for elems in cp.CHAIN_ELEMS:
        steps = cp.chain_block_steps(elems) * elems  # one-instruction steps a loop
        assert 3 / (steps + 3) < 0.05


# -- the SASS helpers -------------------------------------------------------------


def _fake_sass(body):
    """A made-up dump: a prologue, an outer loop holding an inner one whose
    body is ``body`` (a list of instruction texts), an epilogue."""
    lines, addr = [], 0

    def emit(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 0x10

    emit("LDG.E R2, desc[UR4][R2.64]")
    outer = addr
    emit("MOV R4, RZ")
    inner = addr
    for text in body:
        emit(text)
    emit("VIADD R4, R4, 0x1")
    emit("ISETP.NE.AND P0, PT, R4, R5, PT")
    emit(f"@P0 BRA 0x{inner:x}")
    emit("IADD3 R6, R6, 0x1, RZ")
    emit("ISETP.NE.AND P1, PT, R6, R7, PT")
    emit(f"@P1 BRA 0x{outer:x}")
    emit("STG.E desc[UR4][R8.64], R2")
    emit("EXIT")
    return "\n".join(lines)


def test_sass_loop_counts_takes_the_innermost_loop():
    body = ["FMUL R2, R2, R3"] * 64
    counts = cp.sass_loop_counts(_fake_sass(body))
    assert counts == Counter({"FMUL": 64, "VIADD": 1, "ISETP.NE.AND": 1, "BRA": 1})
    rep = cp.check_step_sass("fmul", counts, 64)
    assert rep["matches_table"] and rep["loop_control"] == {
        "VIADD": 1, "ISETP.NE.AND": 1, "BRA": 1}
    assert rep["per_step"]["FMUL"] == 1.0
    # E = 4 elements, 32 steps a block
    counts4 = cp.sass_loop_counts(_fake_sass(["FMUL R2, R2, R3"] * 128))
    assert cp.check_step_sass("fmul", counts4, 32, elems=4)["matches_table"]


def test_check_step_sass_refuses_a_changed_step():
    # a multiply chain that lost half its steps (folded), or gained an instruction
    assert not cp.check_step_sass("mul", Counter({"IMAD": 32, "BRA": 1}), 64)["matches_table"]
    assert not cp.check_step_sass(
        "mul", Counter({"IMAD": 64, "LOP3.LUT": 64, "BRA": 1}), 64)["matches_table"]
    # more than LOOP_CONTROL_MAX instructions of its own loop
    assert not cp.check_step_sass(
        "fmul", Counter({"FMUL": 64, "VIADD": 3, "ISETP.NE.AND": 1, "BRA": 1}), 64
    )["matches_table"]
    # a folded chain: its instructions an element and block
    assert cp.check_step_sass(
        "xor", Counter({**cp.FOLDED_SASS["xor"], "BRA": 1}), 64)["matches_table"]


def test_check_step_sass_reads_unrolled_blocks_and_either_mnemonic():
    # ptxas unrolled the loop over the blocks once more: two blocks a loop
    doubled = Counter({"IMAD": 128, "IADD3": 1, "ISETP.NE.AND": 1, "BRA": 1})
    rep = cp.check_step_sass("mul", doubled, 64)
    assert rep["matches_table"] and rep["blocks_a_loop"] == 2
    assert rep["per_step"]["IMAD"] == 1.0
    # P1's step: its two subtracts' adds on IMAD.IADD or IADD3, as ptxas chose
    barrett = Counter({"IMAD": 12, "SHF.R.U32.HI": 8, "ISETP.GE.U32.AND": 8, "SEL": 8,
                       "IMAD.IADD": 7, "IADD3": 1, "IMAD.MOV": 4, "VIADD": 1,
                       "ISETP.NE.AND": 1, "BRA": 1})
    assert cp.check_step_sass("barrett", barrett, 4)["matches_table"]
    barrett.update({"SEL": 1})  # a select more than two a step
    assert not cp.check_step_sass("barrett", barrett, 4)["matches_table"]


def test_pipe_time_of_a_step():
    clock, n, iters = 1.98e9, P4_N, cp.P4_ITERS
    ms, pipe = cp.pipe_ms("fmul", n, iters, SMS, clock)
    assert pipe == "fp32"
    assert ms == pytest.approx(n * iters / 128 / (SMS * clock) * 1e3)
    ms_mul, pipe_mul = cp.pipe_ms("mul", n, iters, SMS, clock)
    assert pipe_mul == "imad" and ms_mul == pytest.approx(2 * ms)
    ms_cvt, pipe_cvt = cp.pipe_ms("cvt_roundtrip", n, iters, SMS, clock)
    assert pipe_cvt == "conversion" and ms_cvt == pytest.approx(8 * ms)
    # where-sub: two ALU instructions a step (ISETP, SEL) outweigh one IMAD
    assert cp.pipe_ms("where_sub", n, iters, SMS, clock)[1] == "alu"
    # P1: IMAD 3 + IMAD.MOV 1 against SHF, ISETP, SEL 2 each; the two adds
    # that may go to either pipe balance them at 6 a step
    assert cp.pipe_ms("barrett", n, iters, SMS, clock)[0] == pytest.approx(6 * 2 * ms)
    # a folded chain: one instruction an element and block of the E's steps
    for elems in cp.CHAIN_ELEMS:
        assert cp.pipe_ms("xor", n, iters, SMS, clock, elems)[0] == pytest.approx(
            2 * ms / cp.chain_block_steps(elems))
    for op in list(cp.STEP_SASS) + list(cp.FOLDED_SASS):
        assert all(m in cp.PIPES for key in cp.step_instructions(op, 4)
                   for m in key.split("|"))
    with pytest.raises(ValueError, match="unknown chain"):
        cp.step_instructions("div")


def test_chain_wrappers_refuse_cpu_tensors():
    before = (dict(cp.LAUNCHES), dict(cp.CHAIN_FORMS))
    x = cp.to_words(cp.make_inputs("p4", "add")[0][:2], "cpu")
    with pytest.raises(ValueError, match="CUDA tensor only"):
        cp.op_chain(x, x, "add", 4)
    with pytest.raises(ValueError, match="unknown primitive"):
        cp.op_chain(x, x, "div", 4)
    assert (dict(cp.LAUNCHES), dict(cp.CHAIN_FORMS)) == before
    assert set(cp.CHAIN_FORMS) == {f"op_chain_x{e}" for e in cp.CHAIN_ELEMS}


# -- on a GPU -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU form")
    return torch.device("cuda")


def _inputs(op, shape, cmod, seed, dev):
    r = np.random.default_rng(seed)
    if op in ("fmul", "fmul_add"):
        x = r.uniform(1.0, 1.3, shape).astype(np.float32)
        c = r.uniform(0.9, 1.1, cmod).astype(np.float32)
    else:
        # the round trip through float32 is exact below 2^24; above, the
        # conversion's rounding and saturation are the compiler's to choose
        top = 1 << (24 if op == "cvt_roundtrip" else 32)
        x = r.integers(1, top, shape, dtype=np.uint64).astype(np.uint32)
        c = r.integers(1, top, cmod, dtype=np.uint64).astype(np.uint32)
    return cp.to_words(x, dev), cp.to_words(c, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(cp.OPS))
def test_chain_forms_equal_plain_on_ragged_shapes(dev, op):
    """Every E against the plain version: n = 1000 and
    131 073 (a ragged last group), the operand a column (cmod 25 or 125:
    never a multiple of E) or an array like x; x misaligned for the vector
    loads (a view one word in); 100 steps (a block and a remainder)."""
    for shape, cmod, seed in (((40, 25), 25, 1), ((131_073,), 131_073, 2), ((8, 125), 125, 3)):
        x, c = _inputs(op, shape, cmod, seed, dev)
        want = cp.op_chain_plain(x, c, op, 100)
        for elems in cp.CHAIN_ELEMS:
            got = cp.op_chain(x, c, op, 100, elems=elems)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (op, shape, elems)
    # a view one word into its storage: no vector load of x may be taken
    xs, cs = _inputs(op, (1025,), 1025, 4, dev)
    x1, c1 = xs[1:], cs[1:]
    assert x1.data_ptr() % 16 and x1.is_contiguous()
    want = cp.op_chain_plain(x1, c1, op, 40)
    for elems in cp.CHAIN_ELEMS:
        got = cp.op_chain(x1, c1, op, 40, elems=elems)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (op, elems)


@pytest.mark.cuda
def test_chain_grid_matches_the_model(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for elems in cp.CHAIN_ELEMS:
        full = cp.chain_grid(1 << 30, "fmul", elems)  # SMs x resident blocks
        assert full % sms == 0
        per_sm = full // sms
        for n in RAGGED + [P2_N, P4_N]:
            assert cp.chain_grid(n, "fmul", elems) == model_grid(n, elems, sms, per_sm)


@pytest.mark.cuda
def test_library_path_counts_its_form(dev):
    x, c = (cp.to_words(a, dev) for a in cp.make_inputs("p4", "fmul"))
    before = dict(cp.CHAIN_FORMS)
    cp.op_chain(x, c, "fmul", 8)
    made = {k: cp.CHAIN_FORMS[k] - before[k] for k in before if cp.CHAIN_FORMS[k] != before[k]}
    assert made == {f"op_chain_x{cp.chain_elems(x.numel(), c.numel())}": 1}
