#!/usr/bin/env python3
"""What one step of each probe chain (P2 / P4, ``csrc/probes.cu``) compiles to.

    python3 tools/probe_sass.py > sass.jsonl        # builds the kernels if needed (nvcc)
    python3 tools/probe_sass.py --rates smoke.log --sass sass.jsonl

Dumps the SASS of every ``chain_kernel<OP>`` and ``lag_chain_kernel<OP>`` of the
built library (``cuobjdump -sass``), finds the chain's unrolled loop (the
largest block that ends in a branch back to its start), and prints one JSON
line a chain: the SASS instructions of the loop body divided by the unroll
(16 steps a loop in ``chain_kernel``, 12 in ``lag_chain_kernel``), that is the
instructions of one step, beside the loop's own counter, compare and branch.
With the issue rates of those instructions on the card's compute capability
(NVIDIA's CUDA C++ Programming Guide, arithmetic instruction throughput) this
says which pipe a chain's measured rate (``chip_smoke.py`` phase ``probes``)
should be held against.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit),
no GPU.

``--rates LOG --sass SASS``: no build; reads the ``probes`` line of a
``chip_smoke.py`` output and the lines above, and prints per chain its
element-steps a second (the 64x chain and body to body) against the issue
rate of the busiest pipe its step needs: SMs x clock (from that line's
instruction limit, 128 lanes a SM and clock) x :data:`PIPE_LANES` lanes a
SM and clock over the step's instructions on that pipe.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pailliercryptolib_tpu_torch.ops import _build  # noqa: E402

#: enum Op / enum LagOp of csrc/probes.cu, in order
CHAIN_OPS = ("add", "xor", "shift", "mul", "mul_const", "mul_self", "where_sub",
             "cvt_roundtrip", "fmul", "mul_i32", "mul_mask12", "shift_add", "mul_add",
             "fmul_add")
LAG_OPS = ("add_lag", "lop3_lag", "shf_lag")
UNROLL = {"chain_kernel": 16, "lag_chain_kernel": 12}

#: Lanes a SM and clock of the pipes on compute capability 9.0 (NVIDIA CUDA C++
#: Programming Guide, throughput of native arithmetic instructions): float32
#: add / multiply on both FMA pipes, integer multiply-add on the FMA-heavy one,
#: integer add, logic, shift, compare and select on the integer ALU, F2I among
#: "all other type conversions".  I2FP (integer to float, sm_86 and later) is
#: taken on the ALU: the measured round trip runs above two conversions at 16.
PIPES = {"FMUL": "fp32", "FADD": "fp32", "FFMA": "fp32",
         "IMAD": "fma_heavy", "IMAD.IADD": "fma_heavy", "IMAD.MOV.U32": "fma_heavy",
         "IADD3": "alu", "LOP3.LUT": "alu", "SHF.R.U32.HI": "alu", "SHF.R.W.U32": "alu",
         "ISETP.GE.U32.AND": "alu", "SEL": "alu", "LEA.HI": "alu", "I2FP.F32.S32": "alu",
         "F2I.TRUNC.NTZ": "conversion"}
PIPE_LANES = {"fp32": 128, "fma_heavy": 64, "alu": 64, "conversion": 16}
#: chip_smoke.py's probe record names -> chain
RECORDS = {"probe_p2[add u32]": "add", "probe_p2[mul u32 (vector x vector-bcast)]": "mul",
           "probe_p2[mul u32 (x*x)]": "mul_self", "probe_p2[where(cmp, sub)]": "where_sub",
           "probe_p2[u32<->f32 roundtrip (via i32)]": "cvt_roundtrip",
           "probe_p2[mul f32]": "fmul", "probe_p2[mul i32]": "mul_i32",
           "probe_p2[mul u32 (12-bit masked)]": "mul_mask12",
           "probe_p2[lagged IADD3: s + s']": "add_lag",
           "probe_p2[lagged LOP3: bit select]": "lop3_lag",
           "probe_p2[lagged SHF: funnel shift]": "shf_lag",
           "probe_p4[u32_mul]": "mul", "probe_p4[u32_add]": "add",
           "probe_p4[u32_shift_add]": "shift_add", "probe_p4[u32_where_sub]": "where_sub",
           "probe_p4[u32_mul_add]": "mul_add", "probe_p4[f32_mul]": "fmul",
           "probe_p4[f32_fma]": "fmul_add"}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def cuobjdump() -> str:
    nvcc = Path(_build.find_nvcc())
    tool = nvcc.with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside {nvcc}")
    return str(tool)


def instructions(sass: str):
    """(address, instruction text without predicate) of every instruction."""
    out = []
    for line in sass.splitlines():
        m = _LINE.search(line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            out.append((int(m.group(1), 16), text))
    return out


def loop_body(instr):
    """The instructions of the largest loop: from the target of a backward
    branch to the branch."""
    best = []
    for n, (addr, text) in enumerate(instr):
        m = re.match(r"BRA\S*\s+(?:`?\(?\.?L_x_\d+\)?`?|0x([0-9a-f]+))", text)
        if not m or not m.group(1):
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [t for a, t in instr[: n + 1] if a >= target]
            if len(body) > len(best):
                best = body
    return best


def mnemonic(text: str) -> str:
    return text.split()[0]


def pipe_rates(log: str, sass: str) -> None:
    """Print each chain's measured rates against its busiest pipe."""
    steps = {}
    for line in open(sass):
        rec = json.loads(line)
        steps[rec["chain"]] = rec["per_step"]
    probes = kernels = None
    for line in open(log):
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("phase") == "probes":
                probes = rec
            elif isinstance(rec.get("kernels"), list):
                kernels = {k["name"]: k for k in rec["kernels"]}
    sm_clock = probes["instruction_limit_G_per_s"] * 1e9 / 128  # SMs x clock
    for name, chain in RECORDS.items():
        load = Counter()
        for mnem, n in steps[chain].items():
            if n >= 0.2:  # the step's own instructions, not the loop's counter
                load[PIPES[mnem]] += n
        pipe, per = max(load.items(), key=lambda kv: kv[1] / PIPE_LANES[kv[0]])
        limit = sm_clock * PIPE_LANES[pipe] / per
        k, r = kernels[name], probes["rates"][name]
        elements = 1 << (20 if name.startswith("probe_p2") else 17)  # [32,128,256], [256,512]
        iters = 1024 if name.startswith("probe_p2") else 512
        graph = elements * iters / (k["graph_ms"] * 1e-3)
        print(json.dumps({
            "record": name, "step": {m: n for m, n in steps[chain].items() if n >= 0.2},
            "pipe": pipe, "pipe_T_steps_per_s": limit / 1e12,
            "long_T_steps_per_s": r["G_element_ops_per_s"] / 1e3,
            "long_share_of_pipe": r["G_element_ops_per_s"] * 1e9 / limit,
            "graph_T_steps_per_s": graph / 1e12, "graph_share_of_pipe": graph / limit,
            "graph_share_of_bound": k["bound_ms"] / k["graph_ms"]}))


def main() -> int:
    if "--rates" in sys.argv:
        args = sys.argv[1:]
        pipe_rates(args[args.index("--rates") + 1], args[args.index("--sass") + 1])
        return 0
    lib = _build.build()
    report = lib.with_suffix(".ptxas.log").read_text()
    mangled = {_build._kernel_name(e[0]): e[0] for e in _build._PTXAS_ENTRY.findall(report)}
    tool = cuobjdump()
    for kernel, ops in (("chain_kernel", CHAIN_OPS), ("lag_chain_kernel", LAG_OPS)):
        for i, op in enumerate(ops):
            name = f"{kernel}<{i}>"
            sass = subprocess.run([tool, "-sass", "-fun", mangled[name], str(lib)],
                                  capture_output=True, text=True, check=True).stdout
            body = loop_body(instructions(sass))
            per_step = Counter(mnemonic(t) for t in body)
            steps = UNROLL[kernel]
            print(json.dumps({
                "chain": op, "kernel": name, "loop_instructions": len(body),
                "steps_a_loop": steps,
                "per_step": {k: round(v / steps, 3) for k, v in per_step.most_common()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
