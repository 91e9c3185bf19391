"""Instruction-rate probes for Hopper, with their plain versions.

Counterpart of the JAX package's ``benchmarks/probe_layout.py`` (P1),
``probe_ops.py`` (P2), ``probe_i8mm.py`` (P3) and ``probe_vpu_ops.py`` (P4):
small kernels that time one primitive each, for the design of the RNS
kernels — which axis should run along ``threadIdx.x``, what a 32-bit multiply
costs beside an add, and what the int8 tensor core gives over ``__dp4a`` on
the base extensions' own shape.  They are measurements, not functions of the
library; nothing else in the package calls them.

=======================  ==========================  =========================
wrapper                  plain version               kernel (csrc/probes.cu)
=======================  ==========================  =========================
``barrett_chain``        ``barrett_chain_plain``     ``barrett_chain_kernel``
``op_chain``             ``op_chain_plain``          ``chain_kernel<OP, E>``
                                                     (csrc/probe_chain.cu)
``lag_chain``            ``lag_chain_plain``         ``lag_chain_kernel<OP>``
``i8mm`` (``pack_i8``)   ``i8mm_plain``              ``i8mm_dp4a_kernel`` /
                                                     ``i8mm_mma_kernel``
``f32mm``                ``f32mm_plain``             ``f32mm_tiled_kernel`` /
                                                     ``f32mm_kernel``
``mont_chain``           ``mont_chain_plain``        ``mont_chain_tc_kernel<H, EXT>``
=======================  ==========================  =========================

``mont_chain`` (P5) has no counterpart in the reference either: ``iters``
RNS Montgomery squarings on the CRT-folded constant set of K3, on the
tensor-core product in K3's layout (two halves of the rows out of step) or in
its one half, with or without the base extensions.  Without them what remains
is the part of a product linear in k.

The plain versions are loops of torch ops on int64 (32-bit wrap-around by
masking) or float32 tensors: a check of the arithmetic, slow by design, and
the only form that runs on the CPU.  The wrappers have no CPU path: they
launch their kernel on a CUDA tensor and raise on anything else.  Kernel and
plain version agree bit for bit, the float chains too (the kernels round
every multiply and every add on its own, as torch does).

``op_chain`` runs P2 and P4 on the form redesigned for Hopper: E
independent elements a thread, interleaved step by step (E from
:func:`chain_elems`, a function of n and the operand's length only), steps in
blocks unrolled at compile time, a grid of the SM count times the blocks an
SM holds.  :data:`CHAIN_FORMS` counts its launches by E.

:data:`STEP_SASS` is what one step of each chain compiles to on sm_90a
(``cuobjdump -sass``), :data:`PIPES` / :data:`PIPE_LANES` the pipe each of
those instructions issues to and its lanes a SM and clock; with them
:func:`pipe_ms` bounds a chain by its busiest pipe (``chip_smoke.py``'s
``pipe_bound_ms``, beside its published-peak bound), and ``chip_smoke.py``
holds the table against the SASS of the built library
(:func:`sass_loop_counts`, :func:`check_step_sass`).

``lag_chain`` has no counterpart in the reference.  Its three chains (one
``IADD3``, ``LOP3`` or ``SHF`` a step, the other operands earlier values of
the chain) give the rate of the instruction where the compiler folds the
reference's add, xor and shift chains, whose other operand is a constant.

Shapes and step counts of the four probes are the reference's own and are
listed in :data:`P1_CASES`, :data:`P2_CHAINS`, :data:`P3_SHAPE` and
:data:`P4_CHAINS`; :func:`make_inputs` builds their inputs from a numpy seed
exactly as the probe scripts do.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np
import torch

from . import _build

_I64 = torch.int64
_I32 = torch.int32
_F32 = torch.float32
_M32 = 0xFFFFFFFF

#: Launch counts of the probe kernels, one per wrapper.
LAUNCHES = {"barrett_chain": 0, "op_chain": 0, "lag_chain": 0, "i8mm": 0, "f32mm": 0,
            "mont_chain": 0}

#: Launches of the P2 / P4 chain by form: ``op_chain_x<E>`` with E elements
#: a thread.
CHAIN_FORMS = {"op_chain_x1": 0, "op_chain_x2": 0, "op_chain_x4": 0, "op_chain_x8": 0}
#: Elements a thread the library's chain kernel is compiled for.
CHAIN_ELEMS = (1, 2, 4, 8)
#: Threads a block of the library's chain kernel (csrc/probe_chain.cu).
CHAIN_THREADS = 128

#: Primitive -> its number in csrc/probe_ops.cuh (enum Op).
OPS = {
    "add": 0, "xor": 1, "shift": 2, "mul": 3, "mul_const": 4, "mul_self": 5,
    "where_sub": 6, "cvt_roundtrip": 7, "fmul": 8, "mul_i32": 9,
    "mul_mask12": 10, "shift_add": 11, "mul_add": 12, "fmul_add": 13,
}
_FLOAT_OPS = ("fmul", "fmul_add")
#: Lagged chain -> its number in csrc/probes.cu (enum LagOp).
LAG_OPS = {"add_lag": 0, "lop3_lag": 1, "shf_lag": 2}

# P1: 600 steps of r <- Barrett(r * r) on [32, R, C]; constants by column
# (batch-major: the residue lanes along the fast axis) or by row.
P1_ITERS = 600
P1_GRID = 32
P1_MODULUS = 12289
P1_CASES = (
    ("batch-major [128,149]", (128, 149), False),
    ("residue-major [149,128]", (149, 128), True),
    ("residue-major [152,128]", (152, 128), True),
    ("batch-major [128,256]", (128, 256), False),
)
# P2: 1024 steps of one primitive on [32, 128, 256], one constant a column.
P2_ITERS = 1024
P2_SHAPE = (32, 128, 256)
P2_CHAINS = (
    ("add u32", "add"), ("xor u32", "xor"), ("shift u32", "shift"),
    ("mul u32 (vector x vector-bcast)", "mul"),
    ("mul u32 (by scalar const)", "mul_const"), ("mul u32 (x*x)", "mul_self"),
    ("where(cmp, sub)", "where_sub"),
    ("u32<->f32 roundtrip (via i32)", "cvt_roundtrip"), ("mul f32", "fmul"),
    ("mul i32", "mul_i32"), ("mul u32 (12-bit masked)", "mul_mask12"),
)
# The lagged chains run on P2's shape, inputs (those of "add") and step count.
LAG_CHAINS = (
    ("IADD3: s + s'", "add_lag"), ("LOP3: bit select", "lop3_lag"),
    ("SHF: funnel shift", "shf_lag"),
)
# P3: the exact product [128, 152] x [152, 152] of values below 128.
P3_SHAPE = (128, 152, 152)
# P4: 512 steps acc <- op(acc, y) on [256, 512], y a second array.
P4_ITERS = 512
P4_SHAPE = (256, 512)
P4_CHAINS = (
    ("u32_mul", "mul"), ("u32_add", "add"), ("u32_shift_add", "shift_add"),
    ("u32_where_sub", "where_sub"), ("u32_mul_add", "mul_add"),
    ("f32_mul", "fmul"), ("f32_fma", "fmul_add"),
)


def chain_block_steps(elems: int) -> int:
    """Steps a block of the library's chain kernel unrolls at compile time:
    64 with one element a thread, 32 with more (its loop counter then costs
    under 5% of a one-instruction step's issue slots)."""
    return 64 if elems == 1 else 32


def chain_elems(n: int, cmod: int) -> int:
    """Elements a thread (E) of the library's chain kernel for n elements
    whose operand has ``cmod`` words: 4 once n fills a block of 128 threads
    at 4 (on an H100 at P2's and P4's shapes E = 4 ran within 1.3% of the
    fastest E body to body, E = 1 up to 19% slower, E = 8 no faster with
    twice the unrolled code: ``chip_smoke.py`` phase ``probes``,
    ``elems_sweep``), else 1, so that a small n spreads over more threads.  ``cmod`` does not
    change it: a group whose operands are no aligned run of E words reads
    them word by word.  A function of the shapes only, never of the data."""
    del cmod
    return 4 if n >= 4 * CHAIN_THREADS else 1


# ---------------------------------------------------------------------------
# what a step compiles to, and the bound of its busiest pipe
# ---------------------------------------------------------------------------

#: SASS instructions of one step of each chain on sm_90a, as compiled
#: (``cuobjdump -sass`` of the built library; the same at every E): the
#: step's own instructions, not its loop's.
#: ``barrett`` is P1's step, the ``*_lag`` chains the lagged ones; a key
#: "A|B" counts instructions that ptxas puts on either mnemonic.
STEP_SASS = {
    "add": {"IADD3": 0.5},  # two steps in one three-input add
    "mul": {"IMAD": 1.0},
    "mul_self": {"IMAD": 1.0},
    "where_sub": {"ISETP.GE.U32.AND": 1.0, "SEL": 1.0, "IMAD.IADD": 1.0},
    "cvt_roundtrip": {"I2FP.F32.S32": 1.0, "F2I.TRUNC.NTZ": 1.0},
    "fmul": {"FMUL": 1.0},
    "mul_i32": {"IMAD": 1.0},
    "mul_mask12": {"LOP3.LUT": 1.0, "IMAD": 1.0},
    "shift_add": {"LEA.HI": 1.0},
    "mul_add": {"IMAD": 1.0},
    "fmul_add": {"FMUL": 1.0, "FADD": 1.0},
    "add_lag": {"IMAD.IADD": 0.75, "IADD3": 0.25},
    "lop3_lag": {"LOP3.LUT": 1.0},
    "shf_lag": {"SHF.R.W.U32": 1.0},
    # r * r, the quotient's two multiplies and shifts, v - q m, two compare-
    # and-subtracts (ptxas puts their adds on IMAD.IADD or IADD3, its choice
    # differing between the two instances) and a move the unrolling leaves
    "barrett": {"IMAD": 3.0, "SHF.R.U32.HI": 2.0, "ISETP.GE.U32.AND": 2.0, "SEL": 2.0,
                "IMAD.IADD|IADD3": 2.0, "IMAD.MOV": 1.0},
}
#: Chains ptxas folds (x ^ c ^ c = x, shifts by constants merge, powers of a
#: constant multiplier): instructions an element and unrolled block of steps,
#: whatever the block's length.
FOLDED_SASS = {
    "xor": {"LOP3.LUT": 1.0},
    "shift": {"SHF.R.U32.HI": 1.0},
    "mul_const": {"IMAD": 1.0},
}
#: Pipe of each instruction on compute capability 9.0 (NVIDIA CUDA C++
#: Programming Guide, throughput of native arithmetic instructions): float32
#: add / multiply on both FMA pipes, integer multiply-add on the FMA-heavy
#: one, integer add, logic, shift, compare and select on the integer ALU,
#: F2I among "all other type conversions"; I2FP (sm_86 and later) on the ALU.
PIPES = {"FMUL": "fp32", "FADD": "fp32", "FFMA": "fp32",
         "IMAD": "imad", "IMAD.IADD": "imad", "IMAD.MOV.U32": "imad", "IMAD.MOV": "imad",
         "IADD3": "alu", "LOP3.LUT": "alu", "SHF.R.U32.HI": "alu", "SHF.R.W.U32": "alu",
         "ISETP.GE.U32.AND": "alu", "SEL": "alu", "LEA.HI": "alu", "I2FP.F32.S32": "alu",
         "F2I.TRUNC.NTZ": "conversion"}
#: Lanes a SM and clock of each pipe on compute capability 9.0 (same source).
PIPE_LANES = {"fp32": 128, "alu": 64, "imad": 64, "conversion": 16}
#: Instructions a loop of its own may add to the unrolled steps (counter,
#: compare, branch), by mnemonic prefix, and how many at most.
LOOP_CONTROL = ("BRA", "VIADD", "IADD3", "UIADD3", "ISETP", "IMAD.IADD")
LOOP_CONTROL_MAX = 4


def step_instructions(op: str, elems: int = 1) -> dict:
    """SASS instructions of one step of chain ``op`` (:data:`STEP_SASS`; a
    folded chain's count an element and block spread over the block of the
    library's kernel at ``elems``)."""
    if op in STEP_SASS:
        return dict(STEP_SASS[op])
    if op in FOLDED_SASS:
        return {m: k / chain_block_steps(elems) for m, k in FOLDED_SASS[op].items()}
    raise ValueError(f"unknown chain {op!r}")


def pipe_ms(op: str, elements: int, iters: int, sm_count: int, clock_hz: float,
            elems: int = 1):
    """Least time of the instructions of ``iters`` steps of chain ``op`` on
    ``elements``: the step's instructions on their busiest pipe at that
    pipe's lanes a SM and clock, times SMs and clock.  Instructions that may
    go to either of two mnemonics ("A|B") count on the pipe that keeps the
    busiest one least busy.  Returns (ms, the pipe)."""
    load = Counter()
    either = []
    for key, k in step_instructions(op, elems).items():
        if "|" in key:
            either.append((key.split("|"), k))
        else:
            load[PIPES[key]] += k
    for mnemonics, k in either:
        pipes = {PIPES[m] for m in mnemonics}
        best = min(pipes, key=lambda p: (load[p] + k) / PIPE_LANES[p])
        load[best] += k
    pipe = max(load, key=lambda p: load[p] / PIPE_LANES[p])
    return elements * iters * load[pipe] / PIPE_LANES[pipe] / (sm_count * clock_hz) * 1e3, pipe


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRA = re.compile(r"BRA\S*\s+(?:`?\(?\.?L_x_\d+\)?`?|0x([0-9a-f]+))")


def sass_loop_counts(sass: str) -> Counter:
    """Mnemonic counts of the largest innermost loop of one kernel's SASS
    (``cuobjdump -sass -fun``): the instructions from the target of a
    backward branch to the branch, of the loops that hold no other loop.
    In a chain kernel that is its block of unrolled steps."""
    instr = []
    for line in sass.splitlines():
        m = _SASS_LINE.search(line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            instr.append((int(m.group(1), 16), text))
    loops = []
    for n, (addr, text) in enumerate(instr):
        m = _SASS_BRA.match(text)
        if m and m.group(1) and int(m.group(1), 16) < addr:
            start = next(i for i, (a, _) in enumerate(instr) if a >= int(m.group(1), 16))
            loops.append((start, n))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    if not inner:
        return Counter()
    a, b = max(inner, key=lambda ab: ab[1] - ab[0])
    return Counter(text.split()[0] for _, text in instr[a:b + 1])


def check_step_sass(op: str, counts: Counter, block_steps: int, elems: int = 1) -> dict:
    """Hold the SASS of one loop of a chain kernel (``counts``, of
    :func:`sass_loop_counts`) against the table.  The loop runs one or more
    unrolled blocks of ``block_steps`` steps of ``elems`` elements (ptxas
    may unroll the loop over the blocks again): it must hold the step's
    instructions times its steps (a folded chain's: times its elements and
    blocks) and at most :data:`LOOP_CONTROL_MAX` instructions of
    :data:`LOOP_CONTROL` besides.  Returns the per-step counts, the blocks a
    loop, the loop's own instructions and whether they agree."""
    table = STEP_SASS[op] if op in STEP_SASS else FOLDED_SASS[op]
    per_block = block_steps * elems if op in STEP_SASS else elems
    covered = {m for key in table for m in key.split("|")}
    fits = []
    for blocks in (1, 2, 4):
        extra = {}
        for key, k in table.items():
            d = sum(counts.get(m, 0) for m in key.split("|")) - k * per_block * blocks
            if d:
                extra[key] = d
        extra.update({m: n for m, n in counts.items() if m not in covered})
        ok = (all(d > 0 and key.startswith(LOOP_CONTROL) for key, d in extra.items())
              and sum(extra.values()) <= LOOP_CONTROL_MAX)
        fits.append((ok, blocks, extra))
    ok, blocks, extra = next((f for f in fits if f[0]), fits[0])
    steps = block_steps * elems * blocks
    return {"per_step": {m: round(k / steps, 4) for m, k in counts.most_common()},
            "loop_instructions": sum(counts.values()), "steps_a_block": block_steps,
            "blocks_a_loop": blocks, "elems": elems, "loop_control": extra,
            "matches_table": ok}


def make_inputs(probe: str, case=None):
    """The numpy inputs of a probe, as its script makes them.

    ``"p1"``: ``case`` a shape ``(R, C)`` -> x ``[32, R, C]`` uint32;
    ``"p2"``: ``case`` a primitive name -> (x ``[32,128,256]``, c ``[1,256]``),
    float32 for the float primitives, else uint32;
    ``"p3"``: (x ``[128,152]``, t ``[152,152]``) int32 values below 128;
    ``"p4"``: ``case`` a primitive name -> (x, y) ``[256,512]``."""
    if probe == "p1":
        rng = np.random.default_rng(0)
        return rng.integers(3, 1 << 13, (P1_GRID,) + tuple(case), dtype=np.uint32)
    if probe == "p2":
        rng = np.random.default_rng(0)
        if case in _FLOAT_OPS:
            x = rng.uniform(1.0, 1.3, P2_SHAPE).astype(np.float32)
            c = np.full((1, P2_SHAPE[-1]), 1.0000001, np.float32)
        else:
            x = rng.integers(3, 1 << 13, P2_SHAPE).astype(np.uint32)
            c = np.full((1, P2_SHAPE[-1]), 3, np.uint32)
        return x, c
    if probe == "p3":
        rng = np.random.default_rng(0)
        M, K, N = P3_SHAPE
        return (rng.integers(0, 128, (M, K), dtype=np.int32),
                rng.integers(0, 128, (K, N), dtype=np.int32))
    if probe == "p4":
        dt = np.float32 if case in _FLOAT_OPS else np.uint32
        x = np.random.RandomState(0).randint(1, 1 << 12, P4_SHAPE).astype(dt)
        y = np.random.RandomState(1).randint(1, 1 << 12, P4_SHAPE).astype(dt)
        return x, y
    raise ValueError(f"unknown probe {probe!r}")


def to_words(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 or float32 numpy array -> the tensor the chain wrappers take
    (uint32 values as the int32 of the same bits, float32 as it is)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.float32:
        raise TypeError(f"expected uint32 or float32, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned values in int64."""
    return t.to(_I64) & _M32


def _words(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values in int64 -> int32 words of the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(_I32)


def barrett_chain_plain(x, m, mu, byrow: bool, iters: int = P1_ITERS):
    """Plain version of :func:`barrett_chain`."""
    r = _u32(x)
    mm = _u32(m).reshape((-1, 1) if byrow else (1, -1))
    mmu = _u32(mu).reshape(mm.shape)
    for _ in range(iters):
        v = (r * r) & _M32
        q = (((v >> 14) * mmu) & _M32) >> 14
        r = (v - q * mm) & _M32
        r = torch.where(r >= ((mm << 1) & _M32), (r - (mm << 1)) & _M32, r)
        r = torch.where(r >= mm, r - mm, r)
    return _words(r)


def _step_plain(op: str, x, c):
    if op == "add":
        return (x + c) & _M32
    if op == "xor":
        return x ^ c
    if op == "shift":
        return x >> 3
    if op in ("mul", "mul_i32"):  # the low 32 bits do not depend on the sign
        return (x * c) & _M32
    if op == "mul_const":
        return (x * 12289) & _M32
    if op == "mul_self":
        return (x * x) & _M32
    if op == "where_sub":
        return torch.where(x >= c, x - c, x)
    if op == "cvt_roundtrip":
        s = torch.where(x >= (1 << 31), x - (1 << 32), x)  # as int32
        return s.to(_I32).to(_F32).to(_I32).to(_I64) & _M32
    if op == "mul_mask12":
        return (x & 0xFFF) * (c & 0xFFF)
    if op == "shift_add":
        return ((x >> 3) + c) & _M32
    if op == "mul_add":
        return (x * c + c) & _M32
    if op == "fmul":
        return x * c
    if op == "fmul_add":
        return x * c + c
    raise ValueError(f"unknown primitive {op!r}")


def op_chain_plain(x, c, op: str, iters: int):
    """Plain version of :func:`op_chain`."""
    if op in _FLOAT_OPS:
        v, cv = x, c.expand_as(x) if c.numel() != x.numel() else c.reshape(x.shape)
        for _ in range(iters):
            v = _step_plain(op, v, cv)
        return v
    v, cv = _u32(x), _u32(c)
    cv = cv.reshape(x.shape) if cv.numel() == x.numel() else cv
    for _ in range(iters):
        v = _step_plain(op, v, cv)
    return _words(v)


def lag_chain_plain(x, c, op: str, iters: int):
    """Plain version of :func:`lag_chain`."""
    if op not in LAG_OPS:
        raise ValueError(f"unknown lagged chain {op!r}")
    a = _u32(x)
    b = _u32(c).expand_as(a) if c.numel() != x.numel() else _u32(c).reshape(a.shape)
    d, e = a ^ _M32, (a + b) & _M32
    for _ in range(iters):
        if op == "add_lag":
            t = (a + b) & _M32
        elif op == "lop3_lag":
            t = (a & b) ^ ((a ^ _M32) & e)
        else:  # low word of (b : a) >> (d mod 32)
            s = d & 31
            t = (a >> s) | ((b & ((1 << s) - 1)) << (32 - s))
        a, b, d, e = t, a, b, d
    return _words(a)


def pack_i8(x, t):
    """Operands of :func:`i8mm` from x ``[M, K]`` and t ``[K, N]`` (int8
    values 0..127): x padded along the contraction with zeros to a multiple
    of 32, and t transposed and padded likewise — ``(x [M, Kp], tT [N, Kp])``.
    Layout only; kept out of :func:`i8mm` so that its time is the product's."""
    if x.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError("pack_i8: int8 operands expected")
    if x.ndim != 2 or t.ndim != 2 or t.shape[0] != x.shape[1]:
        raise ValueError("pack_i8: x [M, K] and t [K, N] expected")
    Kp = -(-x.shape[1] // 32) * 32

    def pad(a):
        out = torch.zeros((a.shape[0], Kp), dtype=torch.int8, device=a.device)
        out[:, : a.shape[1]] = a
        return out

    return pad(x), pad(t.t())


def i8mm_plain(xp, tTp, reps: int = 1):
    """Plain version of :func:`i8mm` on the same packed operands: the
    broadcast products summed in int64 (no matrix product of any library)."""
    prod = (xp.to(_I64)[:, None, :] * tTp.to(_I64)[None, :, :]).sum(dim=-1)
    return (prod * reps).to(_I32)


def f32mm_plain(x, t, reps: int = 1):
    """Plain version of :func:`f32mm`: broadcast products summed in float32;
    exact in any order while every partial sum stays below 2^24."""
    prod = (x.to(_F32)[:, :, None] * t.to(_F32)[None, :, :]).sum(dim=1)
    return prod * float(reps)


def _chain_consts(consts, ext):
    """Group 0 of a folded constant set for :func:`mont_chain_plain`; without
    the extensions its weight planes are zero (every plane sum is then 0, as
    in the kernel with EXT = false)."""
    from .cuda_rns2 import _plain_consts

    if "maskB" not in consts:
        raise ValueError("mont_chain: the CRT-folded constant set of K3 expected")
    c = _plain_consts(consts)
    if not ext:
        for key in ("T1lo", "T1hi", "T2lo", "T2hi"):
            c[key] = torch.zeros_like(c[key])
    return c


def mont_chain_plain(x, consts, iters: int, ext: bool = True):
    """Plain version of :func:`mont_chain`: ``iters`` squarings of
    :func:`~.cuda_rns2.mont_mul2_plain` on x ``[B, k + kb]`` int32 (the A
    lanes, then the scaled B lanes of the folded set ``consts``)."""
    from .cuda_rns2 import mont_mul2_plain

    c = _chain_consts(consts, ext)
    k = c["sig0"].shape[-1]
    a, b = x[:, :k].to(_I64), x[:, k:].to(_I64)
    for _ in range(iters):
        a, b = mont_mul2_plain(c, a, b, a, b)
    return torch.cat([a, b], dim=-1).to(_I32)


# ---------------------------------------------------------------------------
# wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _launch(name, fn, dev, *args):
    with torch.cuda.device(dev):
        err = fn(*args, _build.current_stream_ptr())
    _build.check_launch(err, name)
    LAUNCHES[name] += 1


def barrett_chain(x, m, mu, byrow: bool, iters: int = P1_ITERS):
    """P1: ``iters`` dependent steps r <- Barrett(r * r) on x ``[G, R, C]``
    (int32 words of uint32 values) with per-column constants m, mu ``[C]``, or
    per-row ``[R]`` when ``byrow``."""
    _build.need_cuda("barrett_chain", x, m, mu)
    if x.ndim != 3 or x.dtype != _I32 or m.dtype != _I32 or mu.dtype != _I32:
        raise TypeError("barrett_chain: x [G, R, C], m, mu int32 words")
    R, C = x.shape[1:]
    if m.numel() != (R if byrow else C) or mu.numel() != m.numel():
        raise ValueError("barrett_chain: one constant a row (byrow) or a column")
    out = torch.empty_like(x)
    _launch("barrett_chain", _build.load().probe_barrett_chain_launch, x.device,
            x.data_ptr(), m.data_ptr(), mu.data_ptr(), out.data_ptr(), x.numel(),
            R, C, int(bool(byrow)), int(iters))
    return out


def _chain_args(name, x, c, op):
    if op not in OPS:
        raise ValueError(f"unknown primitive {op!r}")
    _build.need_cuda("op_chain", x, c)
    want = _F32 if op in _FLOAT_OPS else _I32
    if x.dtype != want or c.dtype != want:
        raise TypeError(f"{name}[{op}]: expected {want} operands")
    if c.numel() not in (x.shape[-1], x.numel()):
        raise ValueError(f"{name}: c is one constant a column or an array like x")


def op_chain(x, c, op: str, iters: int, elems: int = None):
    """P2 / P4: ``iters`` dependent steps x <- op(x, c).  x any shape, int32
    words (uint32 values) or float32 for the float primitives; c one constant
    a column (``x.shape[-1]`` elements) or a second array of x's size.  Runs
    ``chain_kernel<OP, E>`` with E = ``elems`` elements a thread, by default
    :func:`chain_elems` of the shapes (another E only to time the forms)."""
    _chain_args("op_chain", x, c, op)
    elems = chain_elems(x.numel(), c.numel()) if elems is None else elems
    if elems not in CHAIN_ELEMS:
        raise ValueError(f"op_chain: elems must be one of {CHAIN_ELEMS}")
    out = torch.empty_like(x)
    _launch("op_chain", _build.load().probe_chain_launch, x.device,
            x.data_ptr(), c.data_ptr(), out.data_ptr(), x.numel(), c.numel(),
            OPS[op], elems, int(iters))
    CHAIN_FORMS[f"op_chain_x{elems}"] += 1
    return out


def chain_grid(n: int, op: str, elems: int) -> int:
    """Blocks :func:`op_chain` launches for n elements at E = ``elems`` on
    the current CUDA device: ceil(ceil(n / E) / :data:`CHAIN_THREADS`), at
    most the SM count times the blocks an SM holds at once."""
    grid = _build.load().probe_chain_grid(int(n), OPS[op], int(elems))
    if grid <= 0:
        raise RuntimeError(f"probe_chain_grid: CUDA error {-grid}")
    return grid


def lag_chain(x, c, op: str, iters: int):
    """``iters`` steps of a lagged chain (``"add_lag"``, ``"lop3_lag"``,
    ``"shf_lag"``) started from x (int32 words) and c (one constant a column
    or an array like x); see ``lag_chain_kernel``.  Returns the last value."""
    if op not in LAG_OPS:
        raise ValueError(f"unknown lagged chain {op!r}")
    _build.need_cuda("lag_chain", x, c)
    if x.dtype != _I32 or c.dtype != _I32:
        raise TypeError(f"lag_chain[{op}]: expected {_I32} operands")
    if c.numel() not in (x.shape[-1], x.numel()):
        raise ValueError("lag_chain: c is one constant a column or an array like x")
    out = torch.empty_like(x)
    _launch("lag_chain", _build.load().probe_lag_chain_launch, x.device,
            x.data_ptr(), c.data_ptr(), out.data_ptr(), x.numel(), c.numel(),
            LAG_OPS[op], int(iters))
    return out


def i8mm(xp, tTp, body: str = "dp4a", reps: int = 1):
    """P3: the exact int8 x int8 -> int32 product x @ t on the operands of
    :func:`pack_i8` (xp ``[M, Kp]``, tTp ``[N, Kp]``, Kp a multiple of 32),
    accumulated ``reps`` times, by ``body`` ``"dp4a"`` or ``"mma"`` (the int8
    tensor core through ``mma.sync.m16n8k32``; M a multiple of 16, N of 8).
    Returns ``[M, N]`` int32."""
    _build.need_cuda("i8mm", xp, tTp)
    if xp.dtype != torch.int8 or tTp.dtype != torch.int8:
        raise TypeError("i8mm: int8 operands expected")
    if xp.ndim != 2 or tTp.ndim != 2 or xp.shape[1] != tTp.shape[1] or xp.shape[1] % 32:
        raise ValueError("i8mm: operands of pack_i8 expected ([M, Kp], [N, Kp])")
    (M, Kp), N = xp.shape, tTp.shape[0]
    if body not in ("dp4a", "mma"):
        raise ValueError(f"unknown body {body!r}")
    if body == "mma" and (M % 16 or N % 8):
        raise ValueError("i8mm[mma]: M a multiple of 16 and N of 8 expected")
    if reps < 1 or reps * Kp * 127 * 127 >= (1 << 31):
        raise ValueError("i8mm: reps out of range of the int32 accumulator")
    out = torch.empty((M, N), dtype=_I32, device=xp.device)
    _launch("i8mm", _build.load().probe_i8mm_launch, xp.device,
            xp.data_ptr(), tTp.data_ptr(), out.data_ptr(), M, N, Kp,
            int(body == "mma"), int(reps))
    return out


#: Widest contraction the tiled float32 body holds in shared memory.
F32MM_MAX_K = 256


def f32mm(x, t, reps: int = 1, body: str = "tiled"):
    """P3, float32 form: x ``[M, K]`` @ t ``[K, N]`` by fused multiply-adds,
    accumulated ``reps`` times (exact while reps * K * 127^2 < 2^24 for
    operands below 128), by ``body`` ``"tiled"`` (16 x 16 output tiles
    through shared memory, K up to :data:`F32MM_MAX_K`) or ``"thread"`` (the
    first body, one output a thread, kept to time the two)."""
    _build.need_cuda("f32mm", x, t)
    if x.dtype != _F32 or t.dtype != _F32:
        raise TypeError("f32mm: float32 operands expected")
    M, K = x.shape
    if t.shape[0] != K or reps < 1:
        raise ValueError("f32mm: inner dimensions differ or reps < 1")
    if body not in ("tiled", "thread"):
        raise ValueError(f"unknown body {body!r}")
    if body == "tiled" and K > F32MM_MAX_K:
        raise ValueError(f"f32mm[tiled]: K = {K} exceeds {F32MM_MAX_K}")
    N = t.shape[1]
    out = torch.empty((M, N), dtype=_F32, device=x.device)
    _launch("f32mm", _build.load().probe_f32mm_launch, x.device,
            x.data_ptr(), t.data_ptr(), out.data_ptr(), M, N, K,
            int(body == "tiled"), int(reps))
    return out


def mont_chain(x, consts, iters: int, form: str = "tc", ext: bool = True):
    """P5: ``iters`` RNS Montgomery squarings x <- x * x of x ``[B, k + kb]``
    int32 on the CRT-folded constant set ``consts`` (K3's), by the
    tensor-core product (csrc/rns_mont_mul_tc.cuh) of ``form`` ``"tc"``
    (K3's narrow layout: two halves of the rows out of step) or
    ``"unsplit"`` (the same in one half, the form before the split);
    ``ext=False`` leaves the base extensions out."""
    from . import cuda_rns2

    codes = {"tc": 1, "unsplit": 2}
    if form not in codes:
        raise ValueError(f"unknown form {form!r}")
    if "maskB" not in consts:
        raise ValueError("mont_chain: the CRT-folded constant set of K3 expected")
    _build.need_cuda("mont_chain", x, consts["sig0"])
    p = cuda_rns2._tc_pack(consts, "rns_modexp2f")
    if form == "unsplit":
        p = cuda_rns2._tc_pack_layout(consts, (p["cluster"], p["mt"], p["W"], 1))
    k, kb = p["k"], p["kb"]
    if x.dtype != _I32 or x.ndim != 2 or x.shape[1] != k + kb:
        raise ValueError(f"mont_chain: x [B, {k + kb}] int32 expected")
    out = torch.empty_like(x)
    _launch("mont_chain", _build.load().probe_mont_chain_launch, x.device,
            p["rowc"].data_ptr(), p["T1"].data_ptr(), p["T2"].data_ptr(), p["T1a"].data_ptr(),
            x.data_ptr(), out.data_ptr(), x.shape[0], int(iters), k, kb, p["W"],
            codes[form], int(bool(ext)))
    return out
