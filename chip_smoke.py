#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # 2048- and 4096-bit keys, batch 2048
    python3 chip_smoke.py --profile  # also trace one warm call of each path
    python3 chip_smoke.py --kernels-only  # build, phases 3-5, the kernels' times
    python3 chip_smoke.py --probes-only   # build, phase 3, phase probes

Builds the CUDA kernels from ``pailliercryptolib_tpu_torch/csrc`` and drives
the port's paths through its public API: the DJN round trip
``generate_keypair(2048, enable_DJN=True)`` -> ``pub_key.encrypt`` (obfuscators
expanded on the device from a fresh seed) -> ``priv_key.decrypt``, the
homomorphic chain on a non-DJN key, the same operations on the ``"cios"``
backend, the ``modexp`` API, the hybrid batch split, the same operations at
4096- and 3072-bit keys, the instruction-rate probes, serialization, and the
batch split over a mesh of two entries on the one card.
Phases, one JSON line each:

1. ``device``    card name and power limit (nvidia-smi), torch / CUDA versions
2. ``build``     nvcc build of the kernel library: seconds, and per kernel
                 the registers, shared memory and spill bytes ptxas reports
                 (and the dynamic shared memory of the tensor-core layouts);
                 fails if an instance of the tensor-core K1 or K2 spills
3. ``product_probe``  P5: one RNS Montgomery product at K3's shape (the
                 folded set of a 2048-bit key, batch 2048) in K3's layout (two
                 halves of the rows out of step) and in its one half, with
                 and without its base extensions, each against its plain
                 version; us a product
4. ``kernel_checks``  every kernel against its plain PyTorch version on the
                 same CUDA inputs (numpy seed) at the 2048-bit shapes —
                 tolerance: none, the integers must be equal — with times;
                 K4 and K7, single products of a few microseconds, also body
                 to body (``graph_ms``: calls in one CUDA graph)
5. ``ct_select``  K2, K3, K5 per-row and K5 shared at the 2048-bit shapes (no
                 load address, branch or register index takes a window or
                 byte) under windows all 0, all 15, alternating and random
                 (K2: bytes all 0, all 255, one value repeated, random):
                 bit-equal to the plain version (the long modexps on the
                 first 16 windows of every row and at all windows on the
                 first 8 rows), timed by CUDA events at the full window
                 count, median of 5, and the spread across the patterns;
                 the SASS of the kernels (``cuobjdump -sass``): no local
                 memory, K3 / K5 read a (row, lane)'s 16 entries by four
                 16-byte loads at offsets 0-0x30 of one address, K2's
                 one-hot products on IMMA; ``--sass-dir`` keeps the dumps
6. ``main_path`` round trip of 2048 random 64-bit plaintexts, the injected-r
                 oracle ``ct == (n*m+1) * pow(hs, r, n^2) % n^2`` in Python
                 ints, launch counts of every kernel (K3 in the narrow
                 layout's two halves), warm encrypt/decrypt ms
7. ``homomorphic_path``  2048-bit non-DJN keys, batch 2048: normal-mode
                 ``encrypt`` (bases drawn on the device) -> ``ct + ct`` ->
                 ``ct + PlainText`` -> ``ct * PlainText`` (per-row 64-bit
                 scalars, then one shared scalar) -> ``apply_obfuscator`` ->
                 CRT and RAW ``decrypt``, every value against Python ints;
                 the normal-mode injected-r oracle
                 ``ct == (n*m+1) * pow(r, n, n^2) % n^2``; grouped CRT decrypt
                 (stacked constants) against folded; on the DJN key of phase 6
                 ``apply_obfuscator`` and an injected oversized r; the
                 ISO/IEC 18033-6 known-answer vectors; launch counts per call
8. ``legacy_wrappers``  on the DJN key of phase 6 (``"rns"``, batch 2048): the
                 list-returning engine wrappers ``encrypt_djn`` /
                 ``encrypt_normal`` / ``encrypt_noobf`` / ``add_ctct`` /
                 ``mul_ctpt`` / ``decrypt_crt`` / ``decrypt_raw``, each equal to
                 its ``*_dev(...).fetch()`` on the same inputs and to ``pow()``
                 on 8 rows, launch counts per call; ``sync_device`` on a
                 DevLimbs; ``ops/paillier_ops.mod_mul_stage`` on the card: one
                 K4 launch, bit-equal to the stage's plain
                 route and to Python ints on 8 rows, timed (record
                 ``mod_mul[stage]``)
9. ``second_size``  1024-bit keys, batch 300 (ragged against the row tile)
10. ``cios_path`` 2048-bit DJN key, batch 2048, engines on the ``"cios"``
                 backend: encrypt with injected r (against ``pow()`` and
                 against the ``"rns"`` backend's ciphertexts) -> ``ct + ct`` ->
                 ``ct * PlainText`` -> ``apply_obfuscator`` -> CRT and RAW
                 decrypt against Python ints; launch counts per call
11. ``modexp_api``  ``modexp`` on 2048 rows under one 4096-bit modulus, on a
                 vector of three moduli, on scalars, against ``pow()``; K6 at
                 the one-modulus call's shape against its plain version,
                 timed
12. ``rns_mont_exp``  ``ops/rns.rns_mont_exp`` (plain torch on the card, the
                 reference's XLA windowed exponentiation in RNS) on the n^2 of
                 phase 10's 2048-bit key, 4 rows, 128-bit exponents: the
                 canonical value against ``pow()`` and below 2 n^2
13. ``hybrid``    ``set_hybrid_mode`` / ``set_hybrid_ratio`` / ``set_hybrid_off``
                 at a small key width (the plain tail is thousands of small
                 launches a product): where the batch splits, what the plain
                 twin engine gets, results against Python ints

14. ``wide_kernel_checks``  K1, K2 and K5 (shared, per-row) on the n^2 constant
                 set of a 4096-bit key (640 lanes, f32-reciprocal reduction with
                 the full fold; on tensor cores in a cluster of eight), K5
                 grouped on its p^2 / q^2 pair (548 input limbs), K5 shared
                 and K2 on a 3072-bit key's n^2 (480 lanes, padded to 512);
                 K6 (shared base, 512 windows a row; grouped), K7 and K4 at
                 the shapes the ``"cios"`` calls of phase 15 give them; the
                 long modexps are compared at a reduced window count (the
                 plain version is tens to thousands of launches a product;
                 the long K5 also at all windows on 8 rows) and timed at the
                 path's
15. ``wide_path``  4096-bit DJN key, batch 2048: ``encrypt`` (fresh
                 device-expanded obfuscators) -> ``decrypt``; the injected-r
                 oracle on 64 rows; ``ct + ct`` -> ``ct * PlainText`` (per-row,
                 scalar) -> ``apply_obfuscator`` -> CRT (grouped) and RAW decrypt
                 against Python ints; normal-mode encrypt on the same modulus;
                 the same key on ``"cios"``: equal ciphertexts for equal r, it
                 decrypts the ``"rns"`` ones, and a round trip of the whole
                 batch; launch counts per call; ``host_ms``
                 per operation (median of 3); peak device memory
16. ``wide_3072``  3072-bit DJN key, batch 300 (ragged): round trip through
                 the grouped CRT decrypt and the RAW one
17. ``probes``   P1-P4 (``ops/cuda_probes.py``) at the reference probes' shapes
                 and the three lagged chains, each equal to its plain version;
                 G element-ops/s per chain (marked where they exceed what the
                 card can start: folded by ptxas) and TOP/s of the ``dp4a`` and
                 ``mma.sync`` product bodies; P3's one product and its library
                 call timed body to body (one CUDA graph of 200 calls), the
                 tiled float32 body in turns with the first one; P1, P2 and P4
                 body to body (``graph_ms``, 100 calls) and at 64x (P1: 16x)
                 their steps; every P2 / P4 chain (``chain_kernel<OP, E>``)
                 bit-equal to the plain version at the probe's step count and
                 at 64x, timed body to body and at 64x, and at every E
                 (``elems_sweep``); per record ``bound_ms``
                 (published peak) and ``pipe_bound_ms`` (the step's compiled
                 instructions on their busiest pipe); before it the line
                 ``probe_sass``: the SASS of every chain kernel's step against
                 ``cuda_probes.STEP_SASS`` / ``FOLDED_SASS`` (a mismatch fails
                 the phase); the E asserted on every counted call
18. ``serialize``  a 2048-bit key pair and a device-resident ciphertext batch
                 through ``dumps`` / ``loads``, then decrypt
19. ``mesh_path``  a 2048-bit DJN key through the public API under a runtime
                 context whose mesh is ``[cuda:0, cuda:0]`` (the batch split
                 on one card): batches 2048 and 2100, cut at 1024 and 1152
                 (the reference's padded shard boundaries); each entry's
                 ciphertexts equal the unsharded engine's on its rows with its
                 seed row; the injected-r oracle on a sample of both entries;
                 round trips; CT+CT and CT*PT on the split payload on ``"rns"``
                 and ``"cios"``; launch counts per call (K1 once a key, K2 and
                 K3 once an entry); encrypt / decrypt ms split and unsplit; the
                 host-RNG switch (``PAILLIER_TORCH_HOST_RNG=1``) against the
                 device ChaCha20 path (encrypt ms, ChaCha20 launches: none on
                 the host path); the native host codec against the numpy one
                 (2048 rows, 547 limbs, 32 windows; ms of both) and the
                 ``modexp`` API's host wall with each; the four scripts of
                 ``examples_torch/`` (``main(device="cuda")``)

Then one line ``{"kernels": [...]}`` (per kernel: launches on the main path,
error against the plain version, kernel / plain / bound times; P5 and P3's
float32 body also ``ms_before`` in the same call, P5's its one-half form,
P3's its first body; K2 / K3 / K5 their ``select``; K4 / K7 also ``graph_ms``
and both bounds; P1 / P2 / P4 also ``graph_ms`` and ``pipe_bound_ms``), the
card's name and power limit, and the result line.
Exits non-zero without a result line when there is no GPU, when the build
fails or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
# 32-bit integer multiply-adds have no entry in the data sheet; the float32
# (non tensor core) rate is the nearest one and keeps the bound a lower bound.
PEAK_32BIT_OPS = 67e12
# 32 x 32 integer products a clock and SM on Hopper's multiply pipe (half the
# float32 FMA lanes); times the card's SMs and maximum SM clock it bounds the
# 32-bit-word K6 (csrc/cios_mont_mul32.cuh: four products a word step).
INT32_MUL_LANES = 64
# calls in one CUDA graph, for the body-to-body times of short kernels
GRAPH_CALLS = 100


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n: int, reps: int) -> float:
    """Device time of one call of ``fn``, body to body: ``n`` calls captured
    in one CUDA graph, the graph replayed between one pair of CUDA events
    (median of ``reps``), divided by ``n``.  No host work lies between the
    launches, so a call shorter than its host path is timed alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm outside the capture (library workspaces)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps) / n


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a device synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_call(op: str, fn) -> dict:
    """Trace one warm call: wall time, the device's busy time (sum of kernel
    and copy durations; one stream, so no overlap), launches, and the
    kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
            by_name[ev.name] = by_name.get(ev.name, 0.0) + dur / 1e3
            launches += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "profile", "op": op, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy_ms, "device_launches": launches,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "top_device_ms": [[n[:60], round(t, 3)] for n, t in top]}


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_o = ops / peak_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -- phase ct_select: the table selects under adversarial windows ---------------------

CT_PATTERNS = ("zeros", "ones", "alternating", "random")
CT_BYTE_PATTERNS = ("zeros", "ones", "repeated", "random")


def window_pattern(name, shape, top, rng):
    """Windows in [0, top]: all 0, all ``top``, ``top`` and 0 in turn (shifted
    by one on every row), one value drawn and repeated, or uniform."""
    if name == "zeros":
        return np.zeros(shape, np.int64)
    if name == "ones":
        return np.full(shape, top, np.int64)
    if name == "alternating":
        return np.where(np.indices(shape).sum(axis=0) % 2 == 0, top, 0).astype(np.int64)
    if name == "repeated":
        return np.full(shape, int(rng.integers(1, top)), np.int64)
    return rng.integers(0, top + 1, shape).astype(np.int64)


def ct_select_cases(card, cases, reps):
    """Each case (kernel, patterns, make, library, plain, cmp, full): under
    every pattern, the library form equals the plain version on ``cmp`` (the
    windows or bytes it is compared on) and, where ``full`` is given, at the
    full window count on the rows ``full(w, got)`` compares (rows are
    independent); the library form is timed at the full window count by
    CUDA events, ``reps`` runs, median.  Returns per kernel the medians by
    pattern and the spread across patterns ((max - min) / min of the pattern
    medians)."""
    out = {}
    for kernel, patterns, make, run_ct, run_plain, cmp, full in cases:
        rec = {"patterns": {}}
        for pat in patterns:
            w = make(pat)
            got = run_ct(w)
            torch.cuda.synchronize()
            w_cmp = cmp(w)
            want = run_plain(w_cmp)
            got_cmp = got if w_cmp is w else run_ct(w_cmp)
            res = {"equal": torch.equal(got_cmp, want)}
            if full is not None:
                res["full_nw_equal"] = full(w, got)
                res["equal"] = res["equal"] and res["full_nw_equal"]
            t_ct = [cuda_ms(lambda: run_ct(w), 1) for _ in range(reps)]
            rec["patterns"][pat] = dict(res, ms=statistics.median(t_ct), ms_runs=t_ct)
            del got, want, got_cmp
        meds = [v["ms"] for v in rec["patterns"].values()]
        rec["spread"] = (max(meds) - min(meds)) / min(meds)
        rec["equal"] = all(v["equal"] for v in rec["patterns"].values())
        out[kernel] = rec
    return {"phase": "ct_select", "nvidia_smi": card, "reps": reps, "kernels": out}


def find_cuobjdump():
    import os
    import shutil

    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found (on PATH or under CUDA_HOME)")


def sass_of(lib_path, mangled):
    """The SASS of one kernel of the built library, by ``cuobjdump -sass``."""
    out = subprocess.run([find_cuobjdump(), "-sass", "-fun", mangled, str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    if "Function : " + mangled not in out:
        raise RuntimeError(f"cuobjdump shows no function {mangled}")
    return out


SASS_LDG = re.compile(r"LDG\.E\.(\S+)\s+(R\d+), desc\[[^\]]+\]\[(R\d+)\.64(?:\+(0x[0-9a-f]+))?\]")


def sass_select_report(sass, kind):
    """What the SASS of a library kernel shows of its select: local-memory
    instructions (a register array indexed by a value lands there), branches,
    and, for K3 / K5 (``kind`` "masked"), the groups of four 16-byte loads at
    offsets 0, 0x10, 0x20, 0x30 of one base register (a (row, lane)'s 16
    entries, read whole) with the instructions after the first; for K2
    (``kind`` "onehot") the int8 tensor-core products and the 8-byte loads
    of the planes, with the instructions around the first."""
    lines = [ln.strip() for ln in sass.splitlines() if "/*" in ln and ";" in ln]
    instr = [ln.split("*/", 1)[1].split(";")[0].strip() if "*/" in ln else ln for ln in lines]
    rep = {"instructions": len(instr),
           "local_memory": sum(bool(re.search(r"\b(LDL|STL)\b", i)) for i in instr),
           "branches": sum(bool(re.search(r"\bBRA\b", i)) for i in instr)}
    # (instruction index, width of the load: 128, 64, U8, ..., base register, offset)
    loads = [(n, m.group(1).split(".")[0], m.group(3), int(m.group(4) or "0", 16))
             for n, m in ((n, SASS_LDG.search(i)) for n, i in enumerate(instr)) if m]
    if kind == "masked":
        groups, first = 0, None
        for a, (n, width, base, off) in enumerate(loads):
            if width != "128" or off:
                continue
            offs = {o for nn, ww, bb, o in loads[a:a + 8]
                    if ww == "128" and bb == base and nn - n < 24}
            if {0, 16, 32, 48} <= offs:
                groups += 1
                first = n if first is None else first
        rep["ldg128_groups_of_4"] = groups
        at = first
    else:
        rep["imma"] = sum("IMMA" in i for i in instr)
        rep["ldg64"] = sum(w == "64" for _, w, _, _ in loads)
        rep["ldg_u8"] = sum(w == "U8" for _, w, _, _ in loads)
        at = next((n for n, w, _, _ in loads if w == "64"), None)
    rep["snippet"] = instr[max(0, at - 4): at + 44] if at is not None else []
    return rep


def sass_by_function(lib_path, mangled_names):
    """The SASS of each of ``mangled_names`` in the built library, by one
    ``cuobjdump -sass -fun a,b,...`` (the whole library's dump, split by
    function, where that shows one of them not)."""
    def dump(*fun):
        out = subprocess.run([find_cuobjdump(), "-sass", *fun, str(lib_path)],
                             capture_output=True, text=True).stdout
        parts = re.split(r"\n\s*Function : (\S+)", out)
        return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}

    found = dump("-fun", ",".join(mangled_names))
    if not set(mangled_names) <= set(found):
        found = dump()
    missing = set(mangled_names) - set(found)
    if missing:
        raise RuntimeError(f"cuobjdump shows no function {sorted(missing)[:3]}")
    return {m: found[m] for m in mangled_names}


def probe_sass_report(cuda_probes, _build, chain_elems_used):
    """Phase ``probe_sass``: what one step of each P1 / P2 / P4 chain compiles
    to in the built library, held against ``cuda_probes.STEP_SASS`` /
    ``FOLDED_SASS``: the chain kernel at every E (``chain_kernel<OP, E>``;
    the E the probes' shapes run marked), the lagged chains and P1's Barrett
    step."""
    lib = _build.build()
    report = lib.with_suffix(".ptxas.log").read_text()
    mangled = {_build._kernel_name(e[0]): e[0] for e in _build._PTXAS_ENTRY.findall(report)}
    cases = []  # (record key, kernel name, chain, steps a block, elements, checked)
    for op, i in cuda_probes.OPS.items():
        for e in cuda_probes.CHAIN_ELEMS:
            cases.append((f"{op} x{e}", f"chain_kernel<{i},{e}>", op,
                          cuda_probes.chain_block_steps(e), e, True))
    for op, i in cuda_probes.LAG_OPS.items():
        cases.append((op, f"lag_chain_kernel<{i}>", op, 12, 1, True))
    for byrow in (0, 1):
        cases.append((f"barrett byrow={byrow}", f"barrett_chain_kernel<{byrow}>", "barrett",
                      4, 1, True))
    sass = sass_by_function(lib, [mangled[c[1]] for c in cases])
    out, bad = {}, []
    for key, kname, op, steps, e, checked in cases:
        counts = cuda_probes.sass_loop_counts(sass[mangled[kname]])
        rep = cuda_probes.check_step_sass(op, counts, steps, e)
        rep.update(kernel=kname, checked=checked,
                   library_form="," in kname and (op, e) in chain_elems_used)
        out[key] = rep
        if checked and not rep["matches_table"]:
            bad.append(key)
    return {"phase": "probe_sass", "kernels": out, "mismatches": bad}


def probes_phase(check, checks, psrc, reps, dev, sm_count, max_clock_mhz, p5_runs,
                 reset_counts, read_counts):
    """Phase ``probes``: P1-P4 against their plain versions, their times, the
    P2 / P4 chains at every E, and the SASS of every chain against the
    step table (line ``probe_sass``, emitted first); P5's runs (``p5_runs``,
    phase ``product_probe``) counted with them.  Raises on any failure, the
    SASS's after the times are out.  Returns the counts of the probes'
    counted run and the launches of each record's own call."""
    from pailliercryptolib_tpu_torch.ops import _build, cuda_probes

    csrc = "pailliercryptolib_tpu_torch/csrc/probe_chain.cu"
    clock_hz = max_clock_mhz * 1e6
    # Each chain and product body against its plain version, then one counted
    # run of every probe; rates from the kernels' median times.  Operations a
    # step (for the published-peak bound `bound_ms`): one for a single
    # instruction, two where a step is two instructions or one fused
    # multiply-add; the Barrett step of P1 is counted as ten.  Single
    # instructions are held against half the 32-bit multiply-add rate, fused
    # ones against all of it.  `pipe_bound_ms` holds the step's compiled
    # instructions (cuda_probes.STEP_SASS) against the lanes of their busiest
    # pipe, times SMs and maximum clock (or the bytes, if longer).
    OP_COST = {"where_sub": 2, "cvt_roundtrip": 2, "mul_mask12": 2, "shift_add": 2,
               "mul_add": 2, "fmul_add": 2}
    n_before = len(checks)
    probe_runs = list(p5_runs)  # (record, the probe's own call)
    chain_elems_used = set()
    for probe, chains in (("p2", cuda_probes.P2_CHAINS), ("p4", cuda_probes.P4_CHAINS)):
        for _, op in chains:
            x, c = cuda_probes.make_inputs(probe, op)
            chain_elems_used.add((op, cuda_probes.chain_elems(x.size, c.size)))
    sass_rec = probe_sass_report(cuda_probes, _build, chain_elems_used)
    emit(sass_rec)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    LONG = 64
    # what the card can start: four warp instructions a clock and SM at the
    # maximum SM clock.  A chain above it was folded by ptxas (two adds in one
    # IADD3, x ^ c ^ c = x, merged shifts, powers of a constant multiplier).
    instruction_limit = sm_count * 128 * clock_hz

    def long_rate(rec, run_long, element_ops):
        """A probe at its own step count lasts microseconds, of the order of
        the host's time to launch it; the rate is taken from a run of LONG
        times the steps, where the launch no longer shows."""
        run_long()
        rec["long_ms"] = cuda_ms(run_long, reps)
        rec["long_element_ops"] = element_ops
        rec["G_element_ops_per_s"] = element_ops / rec["long_ms"] / 1e6
        rec["above_instruction_limit"] = rec["G_element_ops_per_s"] * 1e9 > instruction_limit

    def pipe_bound(rec, op, elements, iters, bytes_moved, elems=1):
        """`pipe_bound_ms`: the step's instructions on their busiest pipe, or
        the bytes at the published rate where that is longer."""
        t_ops, pipe = cuda_probes.pipe_ms(op, elements, iters, sm_count, clock_hz, elems)
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        rec["pipe_bound_ms"] = max(t_ops, t_bytes)
        rec["pipe_bound_by"] = pipe if t_ops >= t_bytes else "bytes"
        rec["pipe_step"] = cuda_probes.step_instructions(op, elems)

    def chain_check(name, replaces, x, c, op, iters):
        """P2 / P4: the chain kernel (E from chain_elems) against the plain
        version at the probe's step count and at LONG times it;
        single-launch, body-to-body and LONG times; every E body to body and
        at LONG times."""
        cost = OP_COST.get(op, 1)
        peak = PEAK_32BIT_OPS if op == "mul_add" else PEAK_32BIT_OPS / 2
        elems = cuda_probes.chain_elems(x.numel(), c.numel())
        run = lambda: cuda_probes.op_chain(x, c, op, iters)
        rec_i = len(checks)
        bytes_moved = nbytes(x, c) + nbytes(x)
        check(name, csrc, replaces,
              f"x{list(x.shape)} c{list(c.shape)} {iters} steps of {op}",
              lambda: bits(run()), lambda: bits(cuda_probes.op_chain_plain(x, c, op, iters)),
              bytes_moved, 1.0 * x.numel() * iters * cost, peak,
              ("probes", "probe_runs", name), timed=run,
              extra={"form": f"chain_kernel<{cuda_probes.OPS[op]},{elems}>: {elems} "
                             f"elements a thread, {cuda_probes.chain_block_steps(elems)}"
                             f"-step blocks",
                     "elems": elems,
                     "grid": cuda_probes.chain_grid(x.numel(), op, elems)})
        rec = checks[rec_i]
        # LONG times the steps: bit-equal to the plain version
        want_long = bits(cuda_probes.op_chain_plain(x, c, op, iters * LONG))
        run_long = lambda: cuda_probes.op_chain(x, c, op, iters * LONG)
        rec["long_equal"] = torch.equal(bits(run_long()), want_long)
        rec["equal"] = rec["equal"] and rec["long_equal"]
        del want_long
        long_rate(rec, run_long, x.numel() * iters * LONG)
        # body to body: a chain at its own step count is of the order of its launch
        rec["graph_ms"] = graph_ms(run, GRAPH_CALLS, reps)
        rec["graph_calls"] = GRAPH_CALLS
        want = bits(cuda_probes.op_chain_plain(x, c, op, iters))
        sweep = {}
        for e in cuda_probes.CHAIN_ELEMS:
            run_e = lambda e=e: cuda_probes.op_chain(x, c, op, iters, elems=e)
            long_e = lambda e=e: cuda_probes.op_chain(x, c, op, iters * LONG, elems=e)
            long_e()
            sweep[e] = {"equal": torch.equal(bits(run_e()), want),
                        "graph_ms": graph_ms(run_e, GRAPH_CALLS, reps),
                        "long_ms": cuda_ms(long_e, reps)}
        rec["elems_sweep"] = sweep
        rec["equal"] = rec["equal"] and all(v["equal"] for v in sweep.values())
        pipe_bound(rec, op, x.numel(), iters, bytes_moved, elems)
        probe_runs.append((rec, run))

    def lag_check(name, x, c, op, iters):
        rec_i = len(checks)
        run = lambda: cuda_probes.lag_chain(x, c, op, iters)
        bytes_moved = nbytes(x, c) + nbytes(x)
        check(name, psrc, "benchmarks/probe_ops.py:39",
              f"x{list(x.shape)} c{list(c.shape)} {iters} steps of {op}", run,
              lambda: cuda_probes.lag_chain_plain(x, c, op, iters),
              bytes_moved, 1.0 * x.numel() * iters, PEAK_32BIT_OPS / 2,
              ("probes", "probe_runs", name))
        rec = checks[rec_i]
        long_rate(rec, lambda: cuda_probes.lag_chain(x, c, op, iters * LONG),
                  x.numel() * iters * LONG)
        rec["graph_ms"] = graph_ms(run, GRAPH_CALLS, reps)
        rec["graph_calls"] = GRAPH_CALLS
        pipe_bound(rec, op, x.numel(), iters, bytes_moved)
        probe_runs.append((rec, run))

    for tag, (R, C), byrow in cuda_probes.P1_CASES:
        x = cuda_probes.to_words(cuda_probes.make_inputs("p1", (R, C)), dev)
        nconst = R if byrow else C
        m = torch.full((nconst,), cuda_probes.P1_MODULUS, dtype=torch.int32, device=dev)
        mu = torch.full((nconst,), (1 << 28) // cuda_probes.P1_MODULUS,
                        dtype=torch.int32, device=dev)
        run = (lambda x=x, m=m, mu=mu, byrow=byrow:
               cuda_probes.barrett_chain(x, m, mu, byrow))
        rec_i = len(checks)
        name = f"probe_p1[{tag}]"
        bytes_moved = 2 * nbytes(x) + nbytes(m, mu)
        check(name, psrc, "benchmarks/probe_layout.py:41",
              f"x{list(x.shape)} m,mu[{nconst}] {cuda_probes.P1_ITERS} Barrett steps, "
              f"constants by {'row' if byrow else 'column'}",
              run,
              lambda x=x, m=m, mu=mu, byrow=byrow:
              cuda_probes.barrett_chain_plain(x, m, mu, byrow),
              bytes_moved, 10.0 * x.numel() * cuda_probes.P1_ITERS, PEAK_32BIT_OPS / 2,
              ("probes", "probe_runs", name))
        rec = checks[rec_i]
        long_rate(rec,
                  lambda x=x, m=m, mu=mu, byrow=byrow: cuda_probes.barrett_chain(
                      x, m, mu, byrow, iters=16 * cuda_probes.P1_ITERS),
                  x.numel() * 16 * cuda_probes.P1_ITERS)
        rec["graph_ms"] = graph_ms(run, GRAPH_CALLS, reps)
        rec["graph_calls"] = GRAPH_CALLS
        pipe_bound(rec, "barrett", x.numel(), cuda_probes.P1_ITERS, bytes_moved)
        probe_runs.append((rec, run))
    for tag, op in cuda_probes.P2_CHAINS:
        x, c = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p2", op))
        chain_check(f"probe_p2[{tag}]", "benchmarks/probe_ops.py:39", x, c, op,
                    cuda_probes.P2_ITERS)
    # the lagged chains: one IADD3 / LOP3 / SHF a step that cannot be folded,
    # on P2's inputs; they complete P2 where ptxas folds its constant-operand
    # add, xor and shift chains
    x, c = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p2", "add"))
    for tag, op in cuda_probes.LAG_CHAINS:
        lag_check(f"probe_p2[lagged {tag}]", x, c, op, cuda_probes.P2_ITERS)
    for tag, op in cuda_probes.P4_CHAINS:
        x, y = (cuda_probes.to_words(a, dev) for a in cuda_probes.make_inputs("p4", op))
        chain_check(f"probe_p4[{tag}]", "benchmarks/probe_vpu_ops.py:77", x, y, op,
                    cuda_probes.P4_ITERS)
    # P3.  The record of each body is one product: kernel against plain
    # version and numpy, `ms`, `bound_ms` and `library_ms` all for the same
    # work.  It lasts a few microseconds, less than the host's path to its
    # launch, so `ms` and `library_ms` are body to body: P3_GRAPH calls in one
    # CUDA graph, divided by P3_GRAPH; one call between a pair of events is
    # kept as `ms_one_call` / `library_ms_one_call`.  The rate of the body
    # comes from P3_REPS accumulated products in one launch (`ms_reps`,
    # `TOPs`).
    P3_REPS, P3_GRAPH = 512, 200
    xn, tn = cuda_probes.make_inputs("p3")
    want3 = torch.from_numpy(xn.astype(np.int64) @ tn.astype(np.int64)).to(dev)
    x8 = torch.from_numpy(xn.astype(np.int8)).to(dev)
    t8 = torch.from_numpy(tn.astype(np.int8)).to(dev)
    xp8, tTp8 = cuda_probes.pack_i8(x8, t8)
    xf, tf = x8.to(torch.float32), t8.to(torch.float32)
    M3, K3, N3 = cuda_probes.P3_SHAPE
    p3_ops = 2.0 * M3 * K3 * N3
    p3_exact = True

    def p3_check(name, shape, run, run_reps, plain, operands, peak, library, libname,
                 before=None):
        """``before``: the body's earlier form, held against ``plain`` and
        timed body to body in turns with it (before, body, body, before)."""
        rec_i = len(checks)
        got = check(name, psrc, "benchmarks/probe_i8mm.py:41", shape, run, plain,
                    nbytes(*operands) + M3 * N3 * 4, p3_ops, peak,
                    ("probes", "probe_runs", name), library=library,
                    extra={"library": libname, "reps": P3_REPS})
        run_reps()  # warm
        rec = checks[rec_i]
        rec["ms_one_call"], rec["library_ms_one_call"] = rec["ms"], rec["library_ms"]
        if before is None:
            rec["ms"] = graph_ms(run, P3_GRAPH, reps)
        else:
            err_b = int((before().to(torch.int64) - plain().to(torch.int64)).abs().max())
            t = [graph_ms(f, P3_GRAPH, reps) for f in (before, run, run, before)]
            rec.update(ms=(t[1] + t[2]) / 2, ms_before=(t[0] + t[3]) / 2, turns_ms=t,
                       max_abs_err_before=err_b)
            rec["equal"] = rec["equal"] and err_b == 0
        rec["kernel_ms"] = rec["ms"]
        rec["library_ms"] = graph_ms(library, P3_GRAPH, reps)
        rec["graph_calls"] = P3_GRAPH
        rec["ms_reps"] = cuda_ms(run_reps, reps)
        rec["TOPs"] = p3_ops * P3_REPS / rec["ms_reps"] / 1e9
        probe_runs.append((rec, run))
        return got

    for body in ("dp4a", "mma"):
        run_reps = lambda body=body: cuda_probes.i8mm(xp8, tTp8, body=body, reps=P3_REPS)
        got = p3_check(
            f"probe_p3[int8 {body}]", f"x[{M3},{K3}] t[{K3},{N3}] int8 -> int32",
            lambda body=body: cuda_probes.i8mm(xp8, tTp8, body=body), run_reps,
            lambda: cuda_probes.i8mm_plain(xp8, tTp8), (x8, t8), PEAK_INT8_OPS,
            lambda: torch._int_mm(x8, t8), "torch._int_mm")
        p3_exact &= torch.equal(got.to(torch.int64), want3)
        p3_exact &= torch.equal(run_reps(), cuda_probes.i8mm_plain(xp8, tTp8, reps=P3_REPS))
    # float32: more than six accumulated products leave the exact range, so
    # the P3_REPS run is timed and not compared
    got = p3_check(
        "probe_p3[f32 fma]", f"x[{M3},{K3}] t[{K3},{N3}] float32",
        lambda: bits(cuda_probes.f32mm(xf, tf)),
        lambda: cuda_probes.f32mm(xf, tf, reps=P3_REPS),
        lambda: bits(cuda_probes.f32mm_plain(xf, tf)), (xf, tf), PEAK_32BIT_OPS,
        lambda: torch.matmul(xf, tf), "torch.matmul",
        before=lambda: bits(cuda_probes.f32mm(xf, tf, body="thread")))
    checks[-1].update(form="16 x 16 tiles through shared memory, split K",
                      form_before="one output a thread")
    p3_exact &= torch.equal(got.view(torch.float32).to(torch.int64), want3)
    probe_checks = checks[n_before:]
    if not (p3_exact and all(c["equal"] for c in probe_checks)):
        raise AssertionError("a probe differs from its plain version or from numpy: "
                             + str([c["name"] for c in probe_checks if not c["equal"]]))
    # the probes' own run: every one launched once, counted; every P2 / P4
    # chain at the E of its shapes
    reset_counts()
    probe_launches = {}
    for rec, run in probe_runs:
        before = sum(cuda_probes.LAUNCHES.values())
        forms = dict(cuda_probes.CHAIN_FORMS)
        run()
        probe_launches[rec["name"]] = sum(cuda_probes.LAUNCHES.values()) - before
        made = {k: cuda_probes.CHAIN_FORMS[k] - forms[k] for k in forms
                if cuda_probes.CHAIN_FORMS[k] != forms[k]}
        want = {f"op_chain_x{rec['elems']}": 1} if "elems" in rec else {}
        if made != want:
            raise AssertionError(f"{rec['name']}: chain forms {made}, expected {want}")
    torch.cuda.synchronize()
    probe_counts = read_counts()
    if sum(probe_counts["probes"].values()) != len(probe_runs):
        raise AssertionError(f"probes launched {probe_counts['probes']}")
    rates = {}
    for rec in probe_checks:
        keys = (("ms", "graph_ms", "long_ms", "G_element_ops_per_s", "above_instruction_limit",
                 "bound_ms", "pipe_bound_ms", "pipe_bound_by", "elems", "grid",
                 "elems_sweep")
                if "long_ms" in rec
                else ("ms", "library_ms", "ms_one_call", "library_ms_one_call",
                      "ms_reps", "reps", "TOPs", "ms_before"))
        rates[rec["name"]] = {kk: rec.get(kk) for kk in keys if kk in rec}
    emit({"phase": "probes", "equal_plain": True, "p3_exact_against_numpy": True,
          "launches": probe_counts["probes"], "chain_forms": probe_counts["chain_forms"],
          "long_factor": LONG,
          "instruction_limit_G_per_s": instruction_limit / 1e9,
          "max_sm_clock_mhz": max_clock_mhz, "sm_count": sm_count, "rates": rates})
    if sass_rec["mismatches"]:
        raise AssertionError("the SASS of these chains differs from "
                             f"cuda_probes.STEP_SASS / FOLDED_SASS: {sass_rec['mismatches']}")
    return probe_counts, probe_launches



def mesh_phase(card: str, seed: int, counted) -> dict:
    """Phase ``mesh_path``: the batch split over a mesh of two entries on one
    card (``[cuda:0, cuda:0]``), the host-RNG switch and the native host
    codec; see the module docstring.  Raises on any failure."""
    import os

    import pailliercryptolib_tpu_torch as ptorch
    from pailliercryptolib_tpu_torch.convert import keys_from_ints
    from pailliercryptolib_tpu_torch.models.engine import ShardedLimbs
    from pailliercryptolib_tpu_torch.ops import limbs as lb
    from pailliercryptolib_tpu_torch.ops import paillier_ops as pops
    from pailliercryptolib_tpu_torch.parallel import context as pctx
    from pailliercryptolib_tpu_torch.parallel.mesh import batch_bounds
    from pailliercryptolib_tpu_torch.utils import native, trace
    from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

    t_phase = time.perf_counter()
    rng = random.Random(seed + 11)
    dev = torch.device("cuda", 0)
    B, B2, wreps = 2048, 2100, 5
    key = ptorch.generate_keypair(2048, enable_DJN=True)
    upk, usk = key.pub_key, key.priv_key  # no context: unsharded engines
    upk._engine, usk._engine
    n, n2, hs = upk.n, upk.nsquare, upk.hs
    ctx = pctx.initialize_context(devices=["cuda:0", "cuda:0"])
    try:
        if list(ctx.mesh) != [dev, dev] or ctx.backend != "rns":
            raise AssertionError(f"mesh_path: context {ctx}")
        skey = keys_from_ints(n, usk.p, usk.q, hs, upk.randbits)
        spk, ssk = skey.pub_key, skey.priv_key
        if spk._engine.mesh is not ctx.mesh or ssk._engine.mesh is not ctx.mesh:
            raise AssertionError("mesh_path: the engines did not take the context's mesh")
        rows_seen = []
        seed_rows = spk._engine._seed_rows

        def recorded(r):
            rows = seed_rows(r)
            rows_seen.append(rows)
            return rows

        spk._engine._seed_rows = recorded
        vals = [rng.getrandbits(64) for _ in range(B2)]
        # per call: K1 once a key (one device: one table), K2 once an entry,
        # K3 once an entry, K4 twice an entry (the CRT tail)
        ct = counted("mesh encrypt (first)", lambda: spk.encrypt(ptorch.PlainText(vals[:B])),
                     fb_table2=1, fb_modexp2=2)
        dec = counted("mesh decrypt", lambda: ssk.decrypt(ct),
                      rns_modexp2f=2, rns_modexp2f_tc_split=2, mod_mul=4)
        ct2 = counted("mesh encrypt (B = 2100)", lambda: spk.encrypt(ptorch.PlainText(vals)),
                      fb_modexp2=2)
        dec2 = counted("mesh decrypt (B = 2100)", lambda: ssk.decrypt(ct2),
                       rns_modexp2f=2, rns_modexp2f_tc_split=2, mod_mul=4)
        bounds = {}
        for name, c, d, size in (("2048", ct, dec, B), ("2100", ct2, dec2, B2)):
            pay = c.device_payload()
            if not isinstance(pay, ShardedLimbs) or not isinstance(d.device_payload(), ShardedLimbs):
                raise AssertionError(f"mesh_path B={size}: a payload is not split")
            if any(p.arr.device != dev for p in pay.parts):
                raise AssertionError(f"mesh_path B={size}: a part is not on {dev}")
            if pay.bounds != batch_bounds(size, 2, "rns"):
                raise AssertionError(f"mesh_path B={size}: bounds {pay.bounds}")
            bounds[name] = pay.bounds
            if d.texts != vals[:size]:
                raise AssertionError(f"mesh_path B={size}: decrypt(encrypt(m)) != m")
        if [hi for _, hi in bounds["2048"]][0] != 1024 or bounds["2100"][0][1] != 1152:
            raise AssertionError(f"mesh_path: boundaries {bounds}")
        # each entry's rows equal the unsharded engine's on them, seed row i
        for rows, c, size in ((rows_seen[0], ct, B), (rows_seen[1], ct2, B2)):
            texts = c.texts
            for i, (lo, hi) in enumerate(c.device_payload().bounds):
                solo = upk._engine.encrypt_djn_dev(vals[lo:hi], DeviceSeed(rows[i])).fetch()
                if solo != texts[lo:hi]:
                    raise AssertionError(f"mesh_path B={size}: entry {i} differs from "
                                         "the unsharded engine on its rows")
        # the injected-r oracle on a sample of rows of both entries
        rs = [rng.getrandbits(spk.randbits) for _ in range(B)]
        spk.set_random(rs)
        cti = counted("mesh encrypt (injected r)",
                      lambda: spk.encrypt(ptorch.PlainText(vals[:B])),
                      fb_modexp2=2)
        sample = sorted(rng.sample(range(B), 32) + [0, 1023, 1024, B - 1])
        texts = cti.texts
        if any(texts[j] != (n * vals[j] + 1) * pow(hs, rs[j], n2) % n2 for j in sample):
            raise AssertionError("mesh_path: injected-r ciphertexts differ from pow()")
        # CT + CT and CT * PT on the split payload, on "rns" then "cios"
        ws = [rng.getrandbits(16) for _ in range(B)]
        want = [(2 * v * w) % n for v, w in zip(vals[:B], ws)]
        rns_ops = {}
        s = counted("mesh rns ct + ct", lambda: ct + ct)
        m = counted("mesh rns ct * pt", lambda: s * ptorch.PlainText(ws),
                    rns_modexp2=2, rns_modexp2_tc_split=2, var=2)
        rns_ops["values_ok"] = ssk.decrypt(m).texts == want
        for eng in (spk._engine, ssk._engine):
            eng.backend = "cios"
        s = counted("mesh cios ct + ct", lambda: ct + ct, mod_mul=2)
        m = counted("mesh cios ct * pt", lambda: s * ptorch.PlainText(ws),
                    modexp=2)
        dm = counted("mesh cios CRT decrypt", lambda: ssk.decrypt(m),
                     mont_raw=2, modexp=2, mod_mul=4)
        cios_ok = dm.texts == want and m.device_payload().bounds == bounds["2048"]
        for eng in (spk._engine, ssk._engine):
            eng.backend = "rns"
        if not (rns_ops["values_ok"] and cios_ok):
            raise AssertionError("mesh_path: CT + CT / CT * PT on the split payload wrong")
        spk._engine._seed_rows = seed_rows
        pt = ptorch.PlainText(vals[:B])
        uct = upk.encrypt(pt)
        times = {  # sharding one card is overhead: recorded, not a target
            "encrypt_ms": host_ms(lambda: spk.encrypt(pt), wreps),
            "encrypt_ms_unsharded": host_ms(lambda: upk.encrypt(pt), wreps),
            "decrypt_ms": host_ms(lambda: ssk.decrypt(ct), wreps),
            "decrypt_ms_unsharded": host_ms(lambda: usk.decrypt(uct), wreps),
        }
    finally:
        pctx.terminate_context()
    # the host-RNG switch (unsharded key): no ChaCha20 on the device
    chacha = []
    orig_blocks = pops._chacha20_blocks

    def counting_blocks(*a):
        chacha.append(1)
        return orig_blocks(*a)

    pops._chacha20_blocks = counting_blocks
    rng_ab = {}
    try:
        for label, env in (("device", None), ("host", "1")):
            if env is None:
                os.environ.pop("PAILLIER_TORCH_HOST_RNG", None)
            else:
                os.environ["PAILLIER_TORCH_HOST_RNG"] = env
            del chacha[:]
            trace.drain()
            with trace.recording():
                c = counted(f"{label}-rng encrypt", lambda: upk.encrypt(pt),
                            fb_modexp2=1)
            if usk.decrypt(c).texts != vals[:B]:
                raise AssertionError(f"mesh_path: {label}-rng round trip")
            # K2 launches, and calls of the torch ChaCha20 (~1000 launches
            # each), eager or in a replayed graph of the DeviceSeed path
            rng_ab[label] = {"encrypt_ms": host_ms(lambda: upk.encrypt(pt), wreps),
                             "launches": {"fb_modexp2": 1},
                             "chacha20_calls": len(chacha),
                             "graph_replays": trace.drain()["counters"].get(
                                 "pipelines.graph_replays", 0)}
    finally:
        os.environ.pop("PAILLIER_TORCH_HOST_RNG", None)
        pops._chacha20_blocks = orig_blocks
    host, device = rng_ab["host"], rng_ab["device"]
    if (host["chacha20_calls"] or host["graph_replays"]
            or device["chacha20_calls"] + device["graph_replays"] < 1):
        raise AssertionError(f"mesh_path: ChaCha20 launches {rng_ab}")
    # the native host codec against the numpy one
    if not native.available():
        raise AssertionError("mesh_path: the native host codec did not build")
    L547 = lb.limbs_for_bits(8192)  # n^2 of a 4096-bit key
    xs = [rng.getrandbits(15 * L547) for _ in range(B)]
    es = [rng.getrandbits(128) for _ in range(B)]
    limbs_nat = native.ints_to_limbs(xs, L547)
    codec_ok = (np.array_equal(limbs_nat, lb.ints_to_limbs_np(xs, L547))
                and native.limbs_to_ints(limbs_nat) == lb.limbs_to_ints_np(limbs_nat) == xs
                and np.array_equal(native.ints_to_windows(es, 32),
                                   lb.ints_to_windows_np(es, 128)))
    if not codec_ok:
        raise AssertionError("mesh_path: the native codec differs from the numpy codec")
    codec = {
        "ints_to_limbs_ms": [host_ms(lambda: native.ints_to_limbs(xs, L547), 3),
                             host_ms(lambda: lb.ints_to_limbs_np(xs, L547), 3)],
        "limbs_to_ints_ms": [host_ms(lambda: native.limbs_to_ints(limbs_nat), 3),
                             host_ms(lambda: lb.limbs_to_ints_np(limbs_nat), 3)],
        "ints_to_windows_ms": [host_ms(lambda: native.ints_to_windows(es, 32), 3),
                               host_ms(lambda: lb.ints_to_windows_np(es, 128), 3)],
    }
    m_big = rng.getrandbits(4096) | (1 << 4095) | 1
    bs = [rng.randrange(m_big) for _ in range(B)]
    if ptorch.modexp(bs, es, m_big) != [pow(b, e, m_big) for b, e in zip(bs, es)]:
        raise AssertionError("mesh_path: modexp API differs from pow()")
    api_native = host_ms(lambda: ptorch.modexp(bs, es, m_big), 3)
    load = native._load
    native._load = lambda: None
    try:
        api_numpy = host_ms(lambda: ptorch.modexp(bs, es, m_big), 3)
    finally:
        native._load = load
    codec["modexp_api_host_ms"] = [api_native, api_numpy]
    # the four example scripts
    examples = {}
    import importlib.util
    import pathlib

    here = pathlib.Path(__file__).resolve().parent / "examples_torch"
    for f in sorted(here.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f.stem, f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main(device="cuda")
        examples[f.stem] = round(time.perf_counter() - t0, 3)
    return {"phase": "mesh_path", "nvidia_smi": card, "key_bits": 2048,
            "mesh": [str(d) for d in ctx.mesh], "batches": [B, B2], "bounds": bounds,
            "roundtrip_ok": True, "oracle_ok": True, "entries_equal_unsharded": True,
            "ctct_ctpt_ok": {"rns": True, "cios": True}, **times,
            "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
            "host_rng": rng_ab, "codec": codec,
            "codec_order": "[native, numpy] ms, 2048 rows; limbs at 547 (n^2 of a "
                           "4096-bit key), windows of 128-bit exponents",
            "examples_seconds": examples,
            "seconds": round(time.perf_counter() - t_phase, 3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm encrypt, decrypt, normal-mode "
                         "encrypt and ct * pt with torch.profiler (device "
                         "busy share, time by kernel)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase ct_select (the 2048-bit shapes) "
                         "with one line of the kernels' times and no result "
                         "line: for comparing two builds of the kernels")
    ap.add_argument("--probes-only", action="store_true",
                    help="build, phase product_probe, then phase probes (P1-P4, "
                         "the chains' SASS), and stop with no result line")
    ap.add_argument("--seed", type=int, default=20240917)
    ap.add_argument("--sass-dir", default=None,
                    help="write the SASS of the kernels phase ct_select inspects "
                         "into this directory")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2

    import pailliercryptolib_tpu_torch as ptorch
    from pailliercryptolib_tpu_torch.convert import keys_from_ints
    from pailliercryptolib_tpu_torch.models.engine import sync_device
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp, cuda_probes, cuda_rns2
    from pailliercryptolib_tpu_torch.ops import limbs as lb
    from pailliercryptolib_tpu_torch.ops import paillier_ops as pops
    from pailliercryptolib_tpu_torch.ops.montgomery import (
        MontConstants,
        canonicalize,
        cond_sub_n,
        to_i32,
    )
    from pailliercryptolib_tpu_torch.utils.config import Config, set_config
    from pailliercryptolib_tpu_torch.utils import serialize as ser
    from pailliercryptolib_tpu_torch.utils.iso_vectors import check_iso_vectors

    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda", 0)
    card = smi_line()
    max_clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    peak_int32_mul = sm_count * INT32_MUL_LANES * max_clock_mhz * 1e6
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    library = _build.build()
    _build.load()
    lib = _build.load()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(_build.last_build_seconds, 3),
          "library": str(library), "ptxas": _build.kernel_stats(),
          # ptxas reports static shared memory; the tensor-core kernels take
          # theirs dynamically, a CTA's the same for every set of a layout
          "tc_dynamic_smem_bytes": {"narrow": lib.rns_tc_smem_bytes(0),
                                    "wide": lib.rns_tc_smem_bytes(1),
                                    "small": lib.rns_tc_smem_bytes(2),
                                    "narrow1": lib.rns_tc_smem_bytes(3)}})

    # every instance of the tensor-core K1 and K2, of K3 and of K5 in the
    # narrow layout's two halves (<0,...>) keeps its values in registers (P5's
    # probe of the split product, mont_chain_tc_kernel<2,...>, spills: PERF.md
    # section 6)
    def kept_in_registers(name):
        return name.startswith(("fb_table2_tc_kernel", "fb_modexp2_tc_kernel",
                                "rns_modexp2_tc_kernel<0,", "rns_modexp2f_tc_kernel"))

    spilled = [st["kernel"] for st in _build.kernel_stats()
               if kept_in_registers(st["kernel"])
               and (st["spill_store_bytes"] or st["spill_load_bytes"])]
    if spilled:
        raise AssertionError(f"tensor-core instances spill registers: {spilled}")

    key_bits = 2048
    B = 2048
    reps = 3
    rng = random.Random(args.seed)
    nprng = np.random.default_rng(args.seed)

    # -- kernels against their plain versions ----------------------------------
    # constants of a real key of the main path's size (its own key: the main
    # path below generates another, so that its table build is counted there)
    t0 = time.perf_counter()
    ckey = ptorch.generate_keypair(key_bits, enable_DJN=True)
    check_keygen_s = time.perf_counter() - t0
    pub, prv = ckey.pub_key._engine, ckey.priv_key._engine
    _, kc, conv = pub.rns
    kc2, _ = prv.rns_crt
    k = kc["sig0"].shape[-1]
    ka, kb = kc2["sig0"].shape[-1], kc2["modsBx"].shape[-1]
    nbytes_r = -(-pub.randbits // 8)
    NP = max(8, -(-nbytes_r // 8) * 8)
    NW = prv.exp_wins.shape[-1]
    L2in = kc2["CinA"].shape[-2]
    Lp = prv.Lp

    def residues(mods, rows):
        m = mods.cpu().numpy().astype(np.int64)
        return to_i32((nprng.integers(0, 1 << 30, (rows, m.shape[0])) % m), dev)

    checks = []
    counters = {"rns": cuda_rns2.LAUNCHES, "cios": cuda_modexp.LAUNCHES,
                "k5": cuda_rns2.MODEXP2_FORMS, "forms": cuda_rns2.KERNEL_FORMS,
                "probes": cuda_probes.LAUNCHES, "chain_forms": cuda_probes.CHAIN_FORMS}

    def reset_counts():
        for d in counters.values():
            for name in d:
                d[name] = 0

    def read_counts():
        return {grp: dict(d) for grp, d in counters.items()}

    def check(name, source, replaces, shape, kernel, plain, bytes_moved, ops,
              peak, launches_key, timed=None, extra=None, library=None, before=None,
              before_cmp=None):
        """``kernel`` against ``plain`` on the same inputs; ``timed`` (default:
        ``kernel``) is the call whose time is ``ms`` and whose work
        ``bytes_moved`` / ``ops`` count; ``library`` is one PyTorch call that
        computes the same function on the same inputs as ``timed``, timed
        beside it and used nowhere else; ``before`` is the earlier form of the
        kernel on the same inputs as ``timed``: held against ``plain`` too
        (``before_cmp``: the earlier form on the inputs of ``kernel``, where
        ``timed`` differs) and timed in turns with the kernel (before,
        kernel, kernel, before), its time ``ms_before``."""
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        gs = got if isinstance(got, tuple) else (got,)
        ws = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(gs, ws):
            assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, name
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        timed = timed or kernel
        timed()  # warm
        turns = {}
        if before is None:
            ms = cuda_ms(timed, reps)
        else:
            got_b = (before_cmp or before)()
            torch.cuda.synchronize()
            gb = got_b if isinstance(got_b, tuple) else (got_b,)
            turns["max_abs_err_before"] = max(
                int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(gb, ws)) if before_cmp or timed is kernel else None
            t = [cuda_ms(before, reps), cuda_ms(timed, reps), cuda_ms(timed, reps),
                 cuda_ms(before, reps)]
            ms = (t[1] + t[2]) / 2
            turns.update(ms_before=(t[0] + t[3]) / 2, turns_ms=t)
        plain_ms = cuda_ms(plain, 1)
        library_ms = None
        if library is not None:
            library()  # warm
            library_ms = cuda_ms(library, reps)
        bms, by = bound(bytes_moved, ops, peak)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "equal": err == 0 and not turns.get("max_abs_err_before")
               and (extra or {}).get("full_nw_equal", True),
               "ms": ms, "kernel_ms": ms,
               "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "library_ms": library_ms, "shape": shape, "_count": launches_key,
               **turns, **(extra or {})}
        checks.append(rec)
        if err != 0:  # reported after all kernels have been looked at
            for g, w in zip(gs, ws):
                bad = (g != w).nonzero()
                print(f"{name}: {bad.shape[0]} of {g.numel()} values differ, "
                      f"first at {bad[:1].tolist()}", file=sys.stderr)
        return got

    # one Montgomery product: two base extensions of four int8 plane products
    def mm_ops(kk, cols1, cols2):
        return 2.0 * 4 * kk * (cols1 + cols2)

    src = "pailliercryptolib_tpu_torch/csrc/"
    psrc = src + "probes.cu"

    # P5: one RNS Montgomery product at K3's shape (the folded set of this key,
    # batch B), with and without its base extensions: without them what is
    # left is the part linear in k (three fused reductions, the digit
    # scatter, the barriers).  K3's layout, the narrow one's two halves out of
    # step, timed in turns with the same product in one half (``ms_before``;
    # its us a product under "probe_p5[unsplit..]").
    # Compared with the plain version on P5_PLAIN_ITERS products, timed on
    # P5_ITERS.  The linear part is counted
    # as P5_LINEAR_OPS 32-bit operations a (row, lane) and product (the
    # integer and float instructions of the three reductions, the two folds
    # and the two digit splits in csrc/rns_mont_mul_tc.cuh).
    P5_ITERS, P5_PLAIN_ITERS, P5_LINEAR_OPS = 64, 2, 60
    tcp3 = cuda_rns2._tc_pack(kc2, "rns_modexp2f")
    if (tcp3["W"], tcp3["KC"]) != (320, 10) or cuda_rns2._tc_pack(kc, "fb_modexp2")["W"] != 320:
        raise AssertionError("the 2048-bit sets are not the 320-lane tensor-core shape")
    x5 = torch.cat([residues(kc2["modsA"][0], B), residues(kc2["modsBx"][0], B)], dim=1)
    p5_runs, p5_split = [], {}
    for ext in (True, False):
        name = f"probe_p5[tc{'' if ext else ', no extensions'}]"
        ops5 = (P5_ITERS * B * mm_ops(ka, kb + 2, ka + 2) if ext
                else P5_ITERS * B * (ka + kb) * P5_LINEAR_OPS)
        check(name, psrc, "pailliercryptolib_tpu/ops/pallas_rns2.py:552",
              f"x[{B},{ka + kb}] {P5_ITERS} products x <- x * x (folded, G 2)",
              lambda ext=ext: cuda_probes.mont_chain(x5, kc2, P5_PLAIN_ITERS, "tc", ext),
              lambda ext=ext: cuda_probes.mont_chain_plain(x5, kc2, P5_PLAIN_ITERS, ext),
              2 * nbytes(x5), ops5, PEAK_INT8_OPS if ext else PEAK_32BIT_OPS,
              ("probes", "probe_runs", name),
              timed=lambda ext=ext: cuda_probes.mont_chain(x5, kc2, P5_ITERS, "tc", ext),
              before=lambda ext=ext: cuda_probes.mont_chain(x5, kc2, P5_ITERS, "unsplit", ext),
              before_cmp=lambda ext=ext: cuda_probes.mont_chain(
                  x5, kc2, P5_PLAIN_ITERS, "unsplit", ext),
              extra={"form": "tc", "extensions": ext, "iters": P5_ITERS,
                     "plain_iters": P5_PLAIN_ITERS,
                     "form_before": "the same product in the narrow layout's one half",
                     "note": "a product of the K0 device function; "
                             "no TPU kernel of its own"})
        rec = checks[-1]
        rec["us_per_product"] = rec["ms"] / P5_ITERS * 1e3
        p5_split[name] = rec["us_per_product"]
        p5_split[name.replace("[tc", "[unsplit")] = rec["ms_before"] / P5_ITERS * 1e3
        # the probes phase runs it again, after kc2 is deleted here
        p5_runs.append((rec, lambda ext=ext, x5=x5, kc2=kc2:
                        cuda_probes.mont_chain(x5, kc2, P5_ITERS, "tc", ext)))
    emit({"phase": "product_probe", "rows": B, "k": ka, "kb": kb, "W": tcp3["W"],
          "iters": P5_ITERS, "us_per_product": p5_split,
          "equal_plain": all(c["equal"] for c in checks),
          "max_active_clusters_k3_tc": lib.rns_modexp2f_tc_max_clusters(ka, kb, tcp3["W"]),
          "linear_share": {
              f: p5_split[f"probe_p5[{f}, no extensions]"] / p5_split[f"probe_p5[{f}]"]
              for f in ("tc", "unsplit")}})
    if not all(c["equal"] for c in checks):
        raise AssertionError("a product probe differs from its plain version: "
                             + str([c["name"] for c in checks if not c["equal"]]))
    if args.probes_only:
        probes_phase(check, checks, psrc, reps, dev, sm_count, max_clock_mhz, p5_runs,
                     reset_counts, read_counts)
        print(card, flush=True)
        return 0
    # The tensor-core kernels' records: their layout, how many of its clusters
    # the card holds at once, and their table select
    SELECTS = {"fb_modexp2": "one-hot int8 product over the step's planes (no secret address)",
               "rns_modexp2f": "all 16 entries read, masked (no secret address)",
               "rns_modexp2": "all 16 entries read, masked (no secret address)"}

    def tc_extra(consts, kernel):
        tcp = cuda_rns2._tc_pack(consts, kernel)
        kk = tcp["k"]
        extra = {"form": f"tensor cores (mma.sync m16n8k32 s8), cluster of "
                         f"{tcp['cluster']}, {8 * tcp['mt']} rows in {tcp['halves']} "
                         f"half(s), {tcp['W']} lanes"}
        if kernel in SELECTS:
            extra["select"] = SELECTS[kernel]
        if kernel != "rns_modexp2f":
            extra["max_active_clusters"] = getattr(lib, f"{kernel}_tc_max_clusters")(
                kk, kk + 1, tcp["W"], int(tcp["f32"]), int(tcp["lean"]))
        return extra

    def k1_check(name, gA, gB, consts, launches_key):
        """K1: a chain of 255 dependent products a window position, so its
        time over 255 is the latency of one product at its layout."""
        kk, np_ = consts["sig0"].shape[-1], gA.shape[0]
        rec_tabs = check(
            name, src + "fb_table2.cu",
            "pailliercryptolib_tpu/ops/pallas_rns2.py:1066",
            f"gA[1,{np_},{kk}] gB[1,{np_},{kk + 1}] -> [1,256,{np_},{kk}],"
            f"[1,256,{np_},{kk + 1}]",
            lambda: cuda_rns2.fb_table2(gA[None], gB[None], consts),
            lambda: cuda_rns2.fb_table2_plain(gA[None], gB[None], consts),
            nbytes(gA, gB) + 256 * np_ * (2 * kk + 1) * 4,
            255.0 * np_ * mm_ops(kk, kk + 2, kk + 1), PEAK_INT8_OPS,
            launches_key,
            extra=tc_extra(consts, "fb_table2"),
        )
        checks[-1]["us_per_product"] = checks[-1]["ms"] / 255 * 1e3
        return rec_tabs

    gA = residues(kc["modsA"][0], NP)
    gB = residues(kc["modsBx"][0], NP)
    tabs = k1_check("fb_table2", gA, gB, kc, ("main", "rns", "fb_table2"))
    # K2 (both output forms checked; the main path's mont_out form is timed).
    # Its work: NP - 1 products a row and, a step, the one-hot product of the
    # rows' bytes with the step's planes (2 x 256 x 2 planes x 2k+1 lanes
    # int8 operations a row); its bytes: the planes, read whole.
    def fb_check(name, tabs, wins, consts, launches_key):
        kk, np_ = consts["sig0"].shape[-1], wins.shape[-1]
        tab = cuda_rns2.fb_gather_table(*tabs)
        rows = wins.shape[1]
        check(
            name, src + "fb_modexp2.cu", "pailliercryptolib_tpu/ops/pallas_rns2.py:1197",
            f"planes{list(tab.shape)} bytes[1,{rows},{np_}] -> [1,{rows},{2 * kk + 1}]",
            lambda: cuda_rns2.fb_modexp2(tab, wins, consts, mont_out=True),
            lambda: cuda_rns2.fb_modexp2_plain(tab, wins, consts, mont_out=True),
            nbytes(tab, wins) + rows * (2 * kk + 1) * 4,
            (np_ - 1.0) * rows * mm_ops(kk, kk + 2, kk + 1)
            + np_ * rows * 2.0 * FB_ENTRIES * 2 * (2 * kk + 1), PEAK_INT8_OPS,
            launches_key,
            extra={**tc_extra(consts, "fb_modexp2"), "planes_bytes": nbytes(tab)},
        )
        return tab

    FB_ENTRIES = 256
    wins = torch.from_numpy(
        nprng.integers(0, 256, (1, B, NP), dtype=np.uint8)).to(dev)
    tab = fb_check("fb_modexp2", tabs, wins, kc, ("main", "rns", "fb_modexp2"))
    got = cuda_rns2.fb_modexp2(tab, wins, kc, mont_out=False)
    want = cuda_rns2.fb_modexp2_plain(tab, wins, kc, mont_out=False)
    plain_out_equal = torch.equal(got, want)
    # K3
    ct_l = to_i32(nprng.integers(0, 1 << 15, (B, L2in)), dev)
    ewins = prv.exp_wins[:, 0].contiguous()
    check(
        "rns_modexp2f", src + "rns_modexp2f.cu",
        "pailliercryptolib_tpu/ops/pallas_rns2.py:959",
        f"ct[{B},{L2in}] wins[2,{NW}] -> [{B},{ka + kb}]",
        lambda: cuda_rns2.rns_modexp2f(ct_l, ewins, kc2),
        lambda: cuda_rns2.rns_modexp2f_plain(ct_l, ewins, kc2),
        nbytes(ct_l, ewins, kc2["CinA"], kc2["CinB"]) + B * (ka + kb) * 4,
        (15 + 5.0 * NW + 1) * B * mm_ops(ka, kb + 2, ka + 2)
        + 2.0 * 3 * B * L2in * (ka + kb),
        PEAK_INT8_OPS,
        ("main", "rns", "rns_modexp2f"),
        extra=tc_extra(kc2, "rns_modexp2f"),
    )
    # K4 and K7, at every shape a path gives them: against the plain version,
    # timed by CUDA events and body to body.  On 15-bit limbs a product is
    # L^2 limb steps of two multiply-adds, on 32-bit words L32^2 word steps
    # of four 32 x 32 products; the bound is the smaller of the two counts,
    # each at its rate.  A single product lasts microseconds, of the order of
    # its launch, so `graph_ms` times GRAPH_CALLS calls in one CUDA graph,
    # over GRAPH_CALLS (the P2 / P4 chains below too).

    def cios_product_bound(products, L_):
        """(ops, peak, bound_ms_w32, bound_ms_l15) of ``products`` Montgomery
        products at L_ 15-bit limbs: the smaller of the two counts decides."""
        L32 = cuda_modexp.words_for(L_)
        bound15 = products * 2.0 * 2 * L_ * L_ / PEAK_32BIT_OPS * 1e3
        bound32 = products * 4.0 * L32 * L32 / peak_int32_mul * 1e3
        if bound32 < bound15:
            return products * 4.0 * L32 * L32, peak_int32_mul, bound32, bound15
        return products * 2.0 * 2 * L_ * L_, PEAK_32BIT_OPS, bound32, bound15

    def k47_check(name, kernel, a, b, consts, path):
        """K4 (``kernel`` "mod_mul", consts n, n0inv, r2: two products a
        row) or K7 ("mont_raw", consts n, n0inv: one) on a [G, B, L] and b
        broadcastable to it.  K7's kernel returns the canonical value, so it
        is held against cond_sub_n(canonicalize(mont_raw_plain))."""
        G_, B_, L_ = a.shape
        L32 = cuda_modexp.words_for(L_)
        products = G_ * B_ * (2 if kernel == "mod_mul" else 1)
        run = lambda: getattr(cuda_modexp, kernel)(a, b, *consts)
        raw_plain = lambda: getattr(cuda_modexp, kernel + "_plain")(a, b, *consts)
        if kernel == "mod_mul":
            plain, compared = raw_plain, "bit for bit mod_mul_plain"
        else:
            plain = lambda: cond_sub_n(canonicalize(raw_plain()), consts[0][:, None, :])
            compared = ("bit for bit cond_sub_n(canonicalize(mont_raw_plain)), "
                        "the canonical value it returns")
        ops, peak, bound32, bound15 = cios_product_bound(products, L_)
        check(
            name, src + kernel + ".cu",
            "pailliercryptolib_tpu/ops/pallas_modexp.py:"
            + ("295" if kernel == "mod_mul" else "288"),
            f"a{list(a.shape)} b{list(b.shape)} -> {list(a.shape)}",
            run, plain, 2 * nbytes(a) + nbytes(b, *consts), ops, peak,
            (path, "cios", kernel),
            extra={"form": f"32-bit words (L32 = {L32}, "
                           f"{cuda_modexp.ROW_LANES} lanes a row)",
                   "bound_ms_w32": bound32, "bound_ms_l15": bound15,
                   "peak_int32_mul": peak_int32_mul, "compared": compared},
        )
        checks[-1].update(graph_ms=graph_ms(run, GRAPH_CALLS, reps), graph_calls=GRAPH_CALLS)

    # K4: grouped [2, B, Lp] with a shared multiplier, then single [1, B, Lp]
    def limbs_below(rows):
        x = nprng.integers(0, 1 << 15, (rows, Lp))
        x[:, -2:] = 0  # below p and q
        return to_i32(x, dev)

    a2 = torch.stack([limbs_below(B), limbs_below(B)])
    k47_check("mod_mul", "mod_mul", a2, prv.hfun[:, None, :],
              (prv.pq_n, prv.pq_n0inv, prv.pq_r2), "main")
    a1 = limbs_below(B)[None]
    got = cuda_modexp.mod_mul(a1, prv.pinv_q, prv.pq_n[1:2], prv.pq_n0inv[1:2],
                              prv.pq_r2[1:2])
    want = cuda_modexp.mod_mul_plain(a1, prv.pinv_q, prv.pq_n[1:2],
                                     prv.pq_n0inv[1:2], prv.pq_r2[1:2])
    single_equal = torch.equal(got, want)
    # K5 in its three forms, on tensor cores.  One modexp is 15 + 5*NW + 1
    # Montgomery products a row and group, plus the limbs -> residues
    # conversion.
    FULL_NW_ROWS = 8

    def k5_check(form, base, wins5, consts, shared, path="homo", plain_nw=None):
        """``plain_nw``: compare kernel and plain version on the first
        ``plain_nw`` windows of every row, and at all windows on the first
        FULL_NW_ROWS rows (rows are independent); the time is the kernel's at
        all windows."""
        G5 = consts["sig0"].shape[0]
        k5 = consts["sig0"].shape[-1]
        NW5, L5 = wins5.shape[-1], base.shape[-1]
        w_cmp = wins5 if plain_nw is None else wins5[..., :plain_nw].contiguous()
        extra = tc_extra(consts, "rns_modexp2")
        run = lambda w: lambda: cuda_rns2.rns_modexp2(base, w, consts, shared=shared)
        timed = run(wins5)
        if plain_nw is not None:
            extra.update(nw=NW5, plain_nw=plain_nw, ms_at_plain_nw=cuda_ms(run(w_cmp), 1))
            rows = FULL_NW_ROWS
            w_rows = wins5 if shared else wins5[:, :rows].contiguous()
            want = cuda_rns2.rns_modexp2_plain(base[:, :rows].contiguous(), w_rows, consts,
                                               shared=shared)
            extra.update(full_nw_rows=rows, full_nw_equal=torch.equal(timed()[:, :rows], want))
            del want
        return check(
            f"rns_modexp2[{form}]", src + "rns_modexp2.cu",
            "pailliercryptolib_tpu/ops/pallas_rns2.py:883",
            f"base{list(base.shape)} wins{list(wins5.shape)} -> [{G5},{B},{2 * k5 + 1}]",
            timed if plain_nw is None else run(w_cmp),
            lambda: cuda_rns2.rns_modexp2_plain(base, w_cmp, consts, shared=shared),
            nbytes(base, wins5, consts["CinA"], consts["CinB"])
            + G5 * B * (2 * k5 + 1) * 4,
            G5 * ((15 + 5.0 * NW5 + 1) * B * mm_ops(k5, k5 + 2, k5 + 1)
                  + 2.0 * 3 * B * L5 * (2 * k5 + 1)),
            PEAK_INT8_OPS,
            (path, "k5", form.split("@")[0]),
            timed=timed if plain_nw is not None else None,
            extra=extra,
        )

    base5 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    k5_check("shared", base5, pub.n_wins, kc, True)  # normal encrypt's shape
    pt_wins = to_i32(nprng.integers(0, 16, (1, B, 16)), dev)  # 64-bit scalars
    k5_check("var", base5, pt_wins, kc, False)
    kc_st, _ = prv.rns_crt_stacked
    k5_check("grouped", ct_l[None], ewins, kc_st, True)

    # K6, K7 and K4 at the CIOS backend's shapes.  A modexp is 15 + 5*NW + 1
    # Montgomery products a row.  On 15-bit limbs a product is L^2 limb steps
    # of two multiply-adds, on 32-bit words L32^2 word steps of four 32 x 32
    # products (K6); K6's bound is the smaller of the two counts, each at its
    # rate.  The plain modexp is thousands of small launches a product, so
    # kernel and plain version are compared bit for bit at the same L and B
    # with PLAIN_NW windows; the time is the kernel's at the path's NW.
    PLAIN_NW = 32
    cios_src = src + "modexp.cu"

    def k6_check(form, base, wins6, consts, plain_nw, path="cios"):
        n6, n06, r26, one6 = consts
        G6, L6 = n6.shape
        B6 = max(base.shape[1], wins6.shape[1])
        NW6 = wins6.shape[-1]
        L32 = cuda_modexp.words_for(L6)
        w_cmp = wins6[..., :plain_nw].contiguous()
        t_cmp = cuda_ms(lambda: cuda_modexp.modexp(base, w_cmp, *consts), 1)
        products = G6 * B6 * (15 + 5.0 * NW6 + 1)
        bound15 = products * 2.0 * 2 * L6 * L6 / PEAK_32BIT_OPS * 1e3
        bound32 = products * 4.0 * L32 * L32 / peak_int32_mul * 1e3
        ops, peak = ((products * 4.0 * L32 * L32, peak_int32_mul) if bound32 < bound15
                     else (products * 2.0 * 2 * L6 * L6, PEAK_32BIT_OPS))
        return check(
            f"modexp[{form}]", cios_src,
            "pailliercryptolib_tpu/ops/pallas_modexp.py:175",
            f"base{list(base.shape)} wins{list(wins6.shape)} -> [{G6},{B6},{L6}]",
            lambda: cuda_modexp.modexp(base, w_cmp, *consts),
            lambda: cuda_modexp.modexp_plain(base, w_cmp, *consts),
            nbytes(base, wins6, n6, n06, r26, one6) + G6 * B6 * L6 * 4,
            ops, peak, (path, "cios", "modexp"),
            timed=lambda: cuda_modexp.modexp(base, wins6, *consts),
            extra={"nw": NW6, "plain_nw": plain_nw, "ms_at_plain_nw": t_cmp,
                   "form": f"32-bit words (L32 = {L32}, {cuda_modexp.ROW_LANES} lanes a row)",
                   "bound_ms_w32": bound32, "bound_ms_l15": bound15,
                   "peak_int32_mul": peak_int32_mul,
                   "select": "reads all 16 table entries"},
        )

    def stack_consts(cs):
        return (to_i32(np.stack([c.n_limbs for c in cs]), dev),
                to_i32(np.array([c.n0inv for c in cs], np.uint32), dev),
                to_i32(np.stack([c.r2_limbs for c in cs]), dev),
                to_i32(np.stack([c.one_limbs for c in cs]), dev))

    n2c = stack_consts([pub.mont_n2])
    sqc = stack_consts([prv.mont_p2, prv.mont_q2])
    r_wins = to_i32(nprng.integers(0, 16, (1, B, NP * 2)), dev)  # randbits / 4
    k6_check("var", pub.hs_limbs[None, None], r_wins, n2c, PLAIN_NW)  # DJN encrypt
    base_g = to_i32(nprng.integers(0, 1 << 15, (2, B, prv.Lp2)), dev)
    base_g[..., -1] = 0  # below R
    k6_check("grouped", base_g, prv.exp_wins, sqc, PLAIN_NW)  # CRT decrypt
    wide_n = rng.getrandbits(8192) | (1 << 8191) | 1
    widec = stack_consts([MontConstants.create(wide_n, 8192)])
    B_wide, L_wide = 37, widec[0].shape[-1]
    assert L_wide == cuda_modexp.KERNEL_MAX_L
    base_w = to_i32(nprng.integers(0, 1 << 15, (1, B_wide, L_wide)), dev)
    base_w[..., -1] = 0
    wins_w = to_i32(nprng.integers(0, 16, (1, B_wide, 256)), dev)
    k6_check("L547", base_w, wins_w, widec, 8)
    # K7: the fold of the CRT decrypt (x_hi * R^2 * R^-1 in both systems)
    k47_check("mont_raw", "mont_raw", base_g, prv.sq_r2[:, None, :], sqc[:2], "cios")
    # K4 at the width of n^2 (every encrypt, CT+CT and obfuscation of "cios")
    a_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    a_n2[..., -1] = 0
    b_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, pub.L2)), dev)
    b_n2[..., -1] = 0
    k47_check("mod_mul[n2]", "mod_mul", a_n2, b_n2, n2c[:3], "cios")
    del base_g, base_w, wins_w, a_n2, b_n2, r_wins, n2c, sqc, widec
    emit({"phase": "kernel_checks", "key_bits": key_bits, "rows": B,
          "keygen_seconds": round(check_keygen_s, 3),
          "fb_modexp2_plain_out_equal": plain_out_equal,
          "mod_mul_single_group_equal": single_equal,
          "checks": [{kk: v for kk, v in c.items()
                      if kk in ("name", "equal", "kernel_ms", "plain_ms", "shape",
                                "nw", "plain_nw", "ms_before", "max_active_clusters",
                                "graph_ms")}
                     for c in checks]})
    if not (plain_out_equal and single_equal and all(c["equal"] for c in checks)):
        raise AssertionError("a kernel differs from its plain version: "
                             + str([c["name"] for c in checks if not c["equal"]]))

    # -- ct_select: the selects under adversarial windows and bytes, timed; the
    # SASS of the selects
    CT_REPS, CT_PLAIN_NW = 5, 16
    ct_rng = np.random.default_rng(args.seed + 12)

    def first_windows(w):  # the windows a long modexp meets its plain version on
        return w[..., :CT_PLAIN_NW].contiguous() if w.shape[-1] > CT_PLAIN_NW else w

    def win_maker(shape, top=15, dtype=None):
        def make(pat):
            w = window_pattern(pat, shape, top, ct_rng)
            return (torch.from_numpy(w.astype(np.uint8)).to(dev) if dtype == "u8"
                    else to_i32(w, dev))
        return make

    NWs = pub.n_wins.shape[-1]
    R = FULL_NW_ROWS  # the rows the long modexps meet their plain version on at all windows
    ct_line = ct_select_cases(card, [
        ("fb_modexp2", CT_BYTE_PATTERNS, win_maker((1, B, NP), 255, "u8"),
         lambda w: cuda_rns2.fb_modexp2(tab, w, kc, mont_out=True),
         lambda w: cuda_rns2.fb_modexp2_plain(tab, w, kc, mont_out=True), lambda w: w, None),
        ("rns_modexp2f", CT_PATTERNS, win_maker((2, NW)),
         lambda w: cuda_rns2.rns_modexp2f(ct_l, w, kc2),
         lambda w: cuda_rns2.rns_modexp2f_plain(ct_l, w, kc2), first_windows,
         lambda w, got: torch.equal(
             got[:R], cuda_rns2.rns_modexp2f_plain(ct_l[:R].contiguous(), w, kc2))),
        ("rns_modexp2[var]", CT_PATTERNS, win_maker((1, B, 16)),
         lambda w: cuda_rns2.rns_modexp2(base5, w, kc),
         lambda w: cuda_rns2.rns_modexp2_plain(base5, w, kc), lambda w: w, None),
        ("rns_modexp2[shared]", CT_PATTERNS, win_maker((1, NWs)),
         lambda w: cuda_rns2.rns_modexp2(base5, w, kc, shared=True),
         lambda w: cuda_rns2.rns_modexp2_plain(base5, w, kc, shared=True), first_windows,
         lambda w, got: torch.equal(got[:, :R], cuda_rns2.rns_modexp2_plain(
             base5[:, :R].contiguous(), w, kc, shared=True))),
    ], CT_REPS)
    ct_line.update(plain_windows=CT_PLAIN_NW, full_nw_rows=R, shapes={
        "fb_modexp2": f"planes{list(tab.shape)} bytes[1,{B},{NP}]",
        "rns_modexp2f": f"ct[{B},{L2in}] wins[2,{NW}]",
        "rns_modexp2[var]": f"base{list(base5.shape)} wins[1,{B},16]",
        "rns_modexp2[shared]": f"base{list(base5.shape)} wins[1,{NWs}]"})
    # the SASS of the kernels at the 2048-bit shapes
    report = library.with_suffix(".ptxas.log").read_text()
    mangled = {_build._kernel_name(e[0]): e[0] for e in _build._PTXAS_ENTRY.findall(report)}
    sass = {}
    for name, kind in (("fb_modexp2_tc_kernel<0,0,0>", "onehot"),
                       ("rns_modexp2f_tc_kernel", "masked"),
                       ("rns_modexp2_tc_kernel<0,0,0,0>", "masked"),
                       ("rns_modexp2_tc_kernel<0,0,0,1>", "masked")):
        text = sass_of(library, mangled[name])
        sass[name] = sass_select_report(text, kind)
        if args.sass_dir:
            from pathlib import Path

            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / (re.sub(r"[^0-9A-Za-z]+", "_", name) + ".sass")).write_text(text)
    ct_line["sass"] = sass
    emit(ct_line)
    bad = [kk for kk, v in ct_line["kernels"].items() if not v["equal"]]
    bad += [n for n, v in sass.items() if v["local_memory"]
            or (v.get("ldg128_groups_of_4", 1) < 1) or (v.get("imma", 1) < 1)]
    if bad:
        raise AssertionError(f"ct_select: {bad}")
    if args.kernels_only:
        emit({"kernels_only": [{kk: c.get(kk) for kk in ("name", "ms", "max_abs_err",
                                                          "ms_before", "turns_ms", "graph_ms")}
                               for c in checks],
              "ptxas": _build.kernel_stats()})
        print(card, flush=True)
        return 0
    del tab, tabs, ct_l, a2, a1, got, want, ckey, pub, prv, kc, kc2, conv
    del base5, pt_wins, kc_st
    torch.cuda.empty_cache()

    # -- main path -----------------------------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    key = ptorch.generate_keypair(key_bits, enable_DJN=True)
    keygen_s = time.perf_counter() - t0
    pk, sk = key.pub_key, key.priv_key
    vals = [rng.getrandbits(64) for _ in range(B)]
    t0 = time.perf_counter()
    ct = pk.encrypt(ptorch.PlainText(vals))  # fresh DeviceSeed
    ct.block_until_ready()
    first_encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = sk.decrypt(ct)
    dec.block_until_ready()
    first_decrypt_s = time.perf_counter() - t0
    assert ct.device_payload().arr.is_cuda and dec.device_payload().arr.is_cuda
    if dec.texts != vals:
        raise AssertionError("main path: decrypt(encrypt(m)) != m")
    # injected-r oracle against Python ints
    rs = [rng.getrandbits(pk.randbits) for _ in range(4)]
    pk.set_random(rs)
    ct4 = pk.encrypt(ptorch.PlainText(vals[:4]))
    n, n2 = pk.n, pk.nsquare
    want4 = [(n * m + 1) * pow(pk.hs, r, n2) % n2 for m, r in zip(vals[:4], rs)]
    if ct4.texts != want4:
        raise AssertionError("main path: injected-r ciphertexts differ from pow()")
    torch.cuda.synchronize()
    main_counts = read_counts()
    launches = {**main_counts["rns"], **main_counts["cios"]}
    expected = {"fb_table2": 1, "fb_modexp2": 2, "rns_modexp2f": 1, "mod_mul": 2,
                "rns_modexp2": 0, "modexp": 0, "mont_raw": 0}
    for name, want_n in expected.items():
        if launches[name] != want_n:
            raise AssertionError(
                f"main path launched {name} {launches[name]} times, expected {want_n}")
    # K3 in the narrow layout's two halves
    want_forms = {**{name: 0 for name in cuda_rns2.KERNEL_FORMS}, "rns_modexp2f_tc_split": 1}
    if main_counts["forms"] != want_forms:
        raise AssertionError(f"main path ran the forms {main_counts['forms']}, "
                             f"expected {want_forms}")
    # warm timings (outside the counted window)
    wreps = 5
    pt_vals = ptorch.PlainText(vals)
    encrypt_ms = host_ms(lambda: pk.encrypt(pt_vals), wreps)
    decrypt_ms = host_ms(lambda: sk.decrypt(ct), wreps)
    emit({"phase": "main_path", "key_bits": key_bits, "batch": B,
          "roundtrip_ok": True, "oracle_ok": True, "launches": launches,
          "kernel_forms": main_counts["forms"],
          "keygen_seconds": round(keygen_s, 3),
          "table_build_seconds": round(pk._engine.fb_build_seconds, 3),
          "first_encrypt_seconds": round(first_encrypt_s, 3),
          "first_decrypt_seconds": round(first_decrypt_s, 3),
          "encrypt_ms": encrypt_ms, "decrypt_ms": decrypt_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("encrypt", lambda: pk.encrypt(pt_vals)),
                       ("decrypt", lambda: sk.decrypt(ct))):
            emit(profile_call(op, fn))
    del dec, ct4
    torch.cuda.empty_cache()

    # -- homomorphic path ------------------------------------------------------------
    reset_counts()

    def counted(what, fn, **expect):
        """Run ``fn``; the launches it made must be exactly ``expect``
        (kernel or K5 form -> count; anything not named: none)."""
        before = read_counts()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        made = {}
        for grp in after:
            for name in after[grp]:
                dn = after[grp][name] - before[grp][name]
                if dn:
                    made[name] = dn
        if made != expect:
            raise AssertionError(f"{what}: launched {made}, expected {expect}")
        return out

    t0 = time.perf_counter()
    hkey = ptorch.generate_keypair(key_bits, enable_DJN=False)
    h_keygen_s = time.perf_counter() - t0
    hpk, hsk = hkey.pub_key, hkey.priv_key
    hn, hn2 = hpk.n, hpk.nsquare
    va = [rng.getrandbits(64) for _ in range(B)]
    vb = [rng.getrandbits(64) for _ in range(B)]
    vc = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]  # per-row scalars
    vs = rng.getrandbits(64)  # one shared scalar
    pt_a, pt_b, pt_c = (ptorch.PlainText(v) for v in (va, vb, vc))
    pt_e, pt_s = ptorch.PlainText(ve), ptorch.PlainText([vs])
    t0 = time.perf_counter()
    ca = counted("normal encrypt", lambda: hpk.encrypt(pt_a),
                 rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    first_normal_encrypt_s = time.perf_counter() - t0
    cb = counted("normal encrypt", lambda: hpk.encrypt(pt_b),
                 rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    s1 = counted("ct + ct", lambda: ca + cb)
    s2 = counted("ct + pt", lambda: s1 + pt_c)
    m1 = counted("ct * pt (per-row)", lambda: s2 * pt_e,
                 rns_modexp2=1, rns_modexp2_tc_split=1, var=1)
    m2 = counted("ct * pt (scalar)", lambda: m1 * pt_s,
                 rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    ob = counted("apply_obfuscator (normal)", lambda: hpk.apply_obfuscator(m2),
                 rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    for t in (ca, s1, s2, m1, m2, ob):
        assert t.device_payload().arr.is_cuda and t._texts is None
    want_h = [((x + y + z) * e * vs) % hn for x, y, z, e in zip(va, vb, vc, ve)]
    dec_crt = counted("CRT decrypt", lambda: hsk.decrypt(ob),
                      rns_modexp2f=1, rns_modexp2f_tc_split=1,
                      mod_mul=2)
    hsk.enable_crt = False
    dec_raw = counted("RAW decrypt", lambda: hsk.decrypt(ob),
                      rns_modexp2=1, rns_modexp2_tc_split=1, shared=1,
                      mod_mul=1)
    hsk.enable_crt = True
    if dec_crt.texts != want_h or dec_raw.texts != want_h:
        raise AssertionError("homomorphic path: decrypted values differ from "
                             "((a + b + c) * e * s) mod n")
    if ob.texts == m2.texts:
        raise AssertionError("apply_obfuscator left the ciphertexts unchanged")
    # grouped CRT decrypt (stacked constants through the generic kernel)
    grouped = counted(
        "grouped CRT decrypt",
        lambda: hsk._engine._decrypt_crt_impl(ob.device_payload(), grouped=True),
        rns_modexp2=1, grouped=1, mod_mul=2)
    if not torch.equal(grouped.arr, dec_crt.device_payload().arr):
        raise AssertionError("grouped CRT decrypt differs from folded")
    # normal-mode injected-r oracle against Python ints
    rs8 = [rng.randrange(1, hn) for _ in range(8)]
    hpk.set_random(rs8)
    ct8 = counted("normal encrypt (injected r)",
                  lambda: hpk.encrypt(ptorch.PlainText(va[:8])),
                  rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    if ct8.texts != [(hn * m + 1) * pow(r, hn, hn2) % hn2 for m, r in zip(va, rs8)]:
        raise AssertionError("normal-mode injected-r ciphertexts differ from pow()")
    # the DJN-only pieces, on the DJN key of the main path
    od = counted("apply_obfuscator (DJN)", lambda: pk.apply_obfuscator(ct),
                 fb_modexp2=1)
    if od.texts == ct.texts:
        raise AssertionError("DJN apply_obfuscator left the ciphertexts unchanged")
    dd = counted("CRT decrypt (DJN)", lambda: sk.decrypt(od),
                 rns_modexp2f=1, rns_modexp2f_tc_split=1,
                 mod_mul=2)
    if dd.texts != vals:
        raise AssertionError("DJN apply_obfuscator changed the plaintexts")
    r_big = [rng.getrandbits(pk.randbits + 64) | (1 << (pk.randbits + 63))
             for _ in range(8)]
    pk.set_random(r_big)
    cbig = counted("DJN encrypt (oversized r)",
                   lambda: pk.encrypt(ptorch.PlainText(vals[:8])),
                   rns_modexp2=1, rns_modexp2_tc_split=1, var=1)
    if cbig.texts != [(n * m + 1) * pow(pk.hs, r, n2) % n2
                      for m, r in zip(vals, r_big)]:
        raise AssertionError("oversized injected-r ciphertexts differ from pow()")
    # ISO/IEC 18033-6 known-answer vectors (c1, c2, c1*c2, decrypted sum)
    counted("ISO/IEC 18033-6 vectors", lambda: check_iso_vectors(dev),
            rns_modexp2=1, rns_modexp2_tc_split=1,
            shared=1, rns_modexp2f=2, rns_modexp2f_tc_split=2,
            mod_mul=4)
    homo_counts = read_counts()
    h_launches = {**homo_counts["rns"], **homo_counts["cios"]}
    for form, cnt in homo_counts["k5"].items():
        if cnt < 1:
            raise AssertionError(f"homomorphic path never ran rns_modexp2[{form}]")
    # warm timings (outside the counted window)
    h_ms = {
        "encrypt_normal": host_ms(lambda: hpk.encrypt(pt_a), wreps),
        "add_ctct": host_ms(lambda: ca + cb, wreps),
        "add_ctpt": host_ms(lambda: s1 + pt_c, wreps),
        "mul_ctpt_per_row": host_ms(lambda: s2 * pt_e, wreps),
        "mul_ctpt_scalar": host_ms(lambda: m1 * pt_s, wreps),
        "apply_obfuscator_normal": host_ms(lambda: hpk.apply_obfuscator(m2), wreps),
        "apply_obfuscator_djn": host_ms(lambda: pk.apply_obfuscator(ct), wreps),
        "decrypt_crt": host_ms(lambda: hsk.decrypt(ob), wreps),
    }
    hsk.enable_crt = False
    h_ms["decrypt_raw"] = host_ms(lambda: hsk.decrypt(ob), wreps)
    hsk.enable_crt = True
    emit({"phase": "homomorphic_path", "key_bits": key_bits, "batch": B,
          "values_ok": True, "normal_oracle_ok": True, "grouped_equals_folded": True,
          "djn_obfuscator_ok": True, "oversized_r_ok": True, "iso_18033_6_ok": True,
          "launches": h_launches, "rns_modexp2_forms": homo_counts["k5"],
          "keygen_seconds": round(h_keygen_s, 3),
          "first_normal_encrypt_seconds": round(first_normal_encrypt_s, 3),
          "host_ms": h_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("encrypt_normal", lambda: hpk.encrypt(pt_a)),
                       ("mul_ctpt_per_row", lambda: s2 * pt_e)):
            emit(profile_call(op, fn))

    # -- legacy wrappers: the list-returning engine wrappers, sync_device and
    # mod_mul_stage on the main path's DJN key ("rns"), batch B --------------------------
    t_lw = time.perf_counter()
    pe, se = pk._engine, sk._engine
    if (pe.backend, se.backend) != ("rns", "rns"):
        raise AssertionError("legacy_wrappers: the main path's engines are not on rns")
    lw_rng = random.Random(args.seed + 14)
    L2 = pe.L2
    n2_n, n2_n0inv, n2_r2, _ = pe.n2_args
    # mod_mul_stage: one K4 product a row under n^2, counted alone
    a_st, b_st = (to_i32(lb.ints_to_limbs([lw_rng.randrange(n2) for _ in range(B)], L2), dev)
                  for _ in range(2))
    reset_counts()
    stage_out = counted("mod_mul_stage", lambda: pops.mod_mul_stage(
        a_st, b_st, n2_n, n2_n0inv, n2_r2), mod_mul=1)
    stage_counts = read_counts()
    ops, peak, bound32, bound15 = cios_product_bound(2 * B, L2)  # two products a row
    check("mod_mul[stage]", src + "mod_mul.cu", "pailliercryptolib_tpu/ops/pallas_modexp.py:295",
          f"a[{B},{L2}] b[{B},{L2}] -> [{B},{L2}] (ops/paillier_ops.mod_mul_stage)",
          lambda: pops.mod_mul_stage(a_st, b_st, n2_n, n2_n0inv, n2_r2),
          lambda: pops.mod_mul_stage(a_st, b_st, n2_n, n2_n0inv, n2_r2, backend="plain"),
          2 * nbytes(a_st) + nbytes(b_st, n2_n, n2_r2), ops, peak,
          ("legacy_stage", "cios", "mod_mul"),
          extra={"form": f"32-bit words (L32 = {cuda_modexp.words_for(L2)}, "
                         f"{cuda_modexp.ROW_LANES} lanes a row)",
                 "bound_ms_w32": bound32, "bound_ms_l15": bound15,
                 "compared": "bit for bit mod_mul_stage(backend='plain')"})
    stage_rec = checks[-1]
    # the same call with n0inv already a [1] tensor on the card: the int form
    # (the engines' and the JAX signature's) is uploaded on every call
    n0_dev = to_i32([n2_n0inv], dev)
    stage_dev = lambda: pops.mod_mul_stage(a_st, b_st, n2_n, n0_dev, n2_r2)
    stage_dev()
    stage_rec["ms_n0inv_tensor"] = cuda_ms(stage_dev, reps)
    a_ints = lb.limbs_to_ints(a_st[:8].cpu().numpy().astype(np.uint32))
    b_ints = lb.limbs_to_ints(b_st[:8].cpu().numpy().astype(np.uint32))
    stage_ints = lb.limbs_to_ints(stage_out[:8].cpu().numpy().astype(np.uint32))
    if not stage_rec["equal"] or stage_ints != [x * y % n2 for x, y in zip(a_ints, b_ints)]:
        raise AssertionError("mod_mul_stage differs from its plain version or from Python ints")
    # the wrappers, each against its *_dev form on the same inputs and, on OR
    # rows, against pow()
    OR = 8
    r_djn = [lw_rng.getrandbits(pk.randbits) for _ in range(B)]
    r_norm = [lw_rng.randrange(1, n) for _ in range(B)]
    pt_lw = [lw_rng.getrandbits(64) for _ in range(B)]
    lw = {}

    def wrapper(name, eng, args, **expect):
        got = counted(name, lambda: getattr(eng, name)(*args), **expect)
        if not isinstance(got, list) or getattr(eng, name + "_dev")(*args).fetch() != got:
            raise AssertionError(f"legacy_wrappers: {name} differs from {name}_dev().fetch()")
        lw[name] = {"rows": len(got), "equal_dev": True}
        return got

    c_djn = wrapper("encrypt_djn", pe, (vals, r_djn), fb_modexp2=1)
    c_norm = wrapper("encrypt_normal", pe, (vals, r_norm),
                     rns_modexp2=1, rns_modexp2_tc_split=1, shared=1)
    c_plain = wrapper("encrypt_noobf", pe, (vals,))
    c_add = wrapper("add_ctct", pe, (c_djn, c_norm))
    c_mul = wrapper("mul_ctpt", pe, (c_djn, pt_lw),
                    rns_modexp2=1, rns_modexp2_tc_split=1, var=1)
    d_crt = wrapper("decrypt_crt", se, (c_add,),
                    rns_modexp2f=1, rns_modexp2f_tc_split=1,
                    mod_mul=2)
    d_raw = wrapper("decrypt_raw", se, (c_mul,),
                    rns_modexp2=1, rns_modexp2_tc_split=1, shared=1,
                    mod_mul=1)
    oracle = {
        "encrypt_djn": (c_djn, [(n * m + 1) * pow(pk.hs, r, n2) % n2
                                for m, r in zip(vals, r_djn[:OR])]),
        "encrypt_normal": (c_norm, [(1 + n * m) * pow(r, n, n2) % n2
                                    for m, r in zip(vals, r_norm[:OR])]),
        "encrypt_noobf": (c_plain, [(1 + n * m) % n2 for m in vals[:OR]]),
        "add_ctct": (c_add, [x * y % n2 for x, y in zip(c_djn[:OR], c_norm)]),
        "mul_ctpt": (c_mul, [pow(x, e, n2) for x, e in zip(c_djn[:OR], pt_lw)]),
        "decrypt_crt": (d_crt, [2 * m % n for m in vals[:OR]]),
        "decrypt_raw": (d_raw, [m * e % n for m, e in zip(vals[:OR], pt_lw)]),
    }
    for name, (got, want) in oracle.items():
        if got[:OR] != want:
            raise AssertionError(f"legacy_wrappers: {name} differs from pow() on {OR} rows")
        lw[name]["equal_oracle_rows"] = OR
    if d_crt != [2 * m % n for m in vals] or d_raw != [m * e % n for m, e in zip(vals, pt_lw)]:
        raise AssertionError("legacy_wrappers: decrypted values differ from Python ints")
    dv = pe.encrypt_noobf_dev(vals)
    if sync_device(dv) is not None or not dv.arr.is_cuda or dv.fetch() != c_plain:
        raise AssertionError("legacy_wrappers: sync_device on a DevLimbs")
    emit({"phase": "legacy_wrappers", "nvidia_smi": card, "key_bits": key_bits, "batch": B,
          "backend": "rns", "wrappers": lw, "sync_device_ok": True,
          "mod_mul_stage": {kk: stage_rec[kk] for kk in (
              "shape", "equal", "max_abs_err", "ms", "ms_n0inv_tensor", "plain_ms",
              "bound_ms", "bound_by", "bound_ms_w32", "bound_ms_l15", "form")}
          | {"launches": stage_counts["cios"]["mod_mul"]},
          "seconds": round(time.perf_counter() - t_lw, 3)})
    del c_djn, c_norm, c_plain, c_add, c_mul, d_crt, d_raw, dv, a_st, b_st, stage_out
    del ca, cb, s1, s2, m1, m2, ob, dec_crt, dec_raw, grouped, ct8, od, dd, cbig
    for eng in (pk._engine, sk._engine, hpk._engine, hsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
    del ct, key, pk, sk, hkey, hpk, hsk
    torch.cuda.empty_cache()

    # -- second size -----------------------------------------------------------------
    bits2, B2 = 1024, 300
    key2 = ptorch.generate_keypair(bits2, enable_DJN=True)
    vals2 = [rng.getrandbits(64) for _ in range(B2)]
    ct2 = key2.pub_key.encrypt(ptorch.PlainText(vals2))
    if key2.priv_key.decrypt(ct2).texts != vals2:
        raise AssertionError("second size: decrypt(encrypt(m)) != m")
    emit({"phase": "second_size", "key_bits": bits2, "batch": B2,
          "roundtrip_ok": True})

    # -- the CIOS backend ---------------------------------------------------------------
    # the engines take their backend from the runtime config when they are made
    reset_counts()
    t0 = time.perf_counter()
    rkey = ptorch.generate_keypair(key_bits, enable_DJN=True)  # "rns"
    c_keygen_s = time.perf_counter() - t0
    rpk, rsk = rkey.pub_key, rkey.priv_key
    rpk._engine, rsk._engine  # made now, under the default config
    set_config(Config(backend="cios"))
    try:
        ckey = keys_from_ints(rpk.n, rsk.p, rsk.q, rpk.hs, rpk.randbits)
        cpk, csk = ckey.pub_key, ckey.priv_key
        backends = (cpk._engine.backend, csk._engine.backend, rpk._engine.backend)
    finally:
        set_config(Config())
    if backends != ("cios", "cios", "rns"):
        raise AssertionError(f"cios path: engines on {backends}")
    cn, cn2 = cpk.n, cpk.nsquare
    vm = [rng.getrandbits(64) for _ in range(B)]
    vm2 = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]
    vs = rng.getrandbits(64)
    rs_c = [rng.getrandbits(cpk.randbits) for _ in range(2 * B)]
    cpk.set_random(rs_c)
    rpk.set_random(rs_c)
    t0 = time.perf_counter()
    c1 = counted("cios DJN encrypt", lambda: cpk.encrypt(ptorch.PlainText(vm)),
                 modexp=1, mod_mul=1)
    first_cios_encrypt_s = time.perf_counter() - t0
    c2 = counted("cios DJN encrypt", lambda: cpk.encrypt(ptorch.PlainText(vm2)),
                 modexp=1, mod_mul=1)
    n_oracle = 256
    if c1.texts[:n_oracle] != [(cn * m + 1) * pow(cpk.hs, r, cn2) % cn2
                               for m, r in zip(vm[:n_oracle], rs_c)]:
        raise AssertionError("cios path: ciphertexts differ from pow()")
    c_sum = counted("cios ct + ct", lambda: c1 + c2, mod_mul=1)
    c_mul = counted("cios ct * pt (per-row)", lambda: c_sum * ptorch.PlainText(ve),
                    modexp=1)
    c_mul2 = counted("cios ct * pt (scalar)", lambda: c_mul * ptorch.PlainText([vs]),
                     modexp=1)
    c_obf = counted("cios apply_obfuscator", lambda: cpk.apply_obfuscator(c_mul2),
                    modexp=1, mod_mul=1)
    for t in (c1, c_sum, c_mul, c_mul2, c_obf):
        assert t.device_payload().arr.is_cuda
    want_c = [((x + y) * e * vs) % cn for x, y, e in zip(vm, vm2, ve)]
    d_crt = counted("cios CRT decrypt", lambda: csk.decrypt(c_obf),
                    mont_raw=1, modexp=1, mod_mul=2)
    csk.enable_crt = False
    d_raw = counted("cios RAW decrypt", lambda: csk.decrypt(c_obf),
                    modexp=1, mod_mul=1)
    csk.enable_crt = True
    if d_crt.texts != want_c or d_raw.texts != want_c:
        raise AssertionError("cios path: decrypted values differ from "
                             "((a + b) * e * s) mod n")
    if c_obf.texts == c_mul2.texts:
        raise AssertionError("cios path: apply_obfuscator left the ciphertexts unchanged")
    for eng in (cpk._engine, csk._engine, rpk._engine, rsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
    torch.cuda.synchronize()
    cios_counts = read_counts()
    # the same key on the "rns" backend (outside the counted window): equal
    # ciphertexts for the same m and r, and it decrypts what "cios" made
    r1 = rpk.encrypt(ptorch.PlainText(vm))
    r2 = rpk.encrypt(ptorch.PlainText(vm2))
    if c1.texts != r1.texts or c2.texts != r2.texts:
        raise AssertionError("cios path: ciphertexts differ from the rns backend's")
    if rsk.decrypt(c_obf).texts != want_c:
        raise AssertionError("cios path: the rns backend decrypts cios ciphertexts wrong")
    if any(cios_counts[grp][name] for grp in ("rns", "k5") for name in cios_counts[grp]):
        raise AssertionError(f"cios path launched an RNS kernel: {cios_counts}")
    pt_vm, pt_ve, pt_vs = (ptorch.PlainText(v) for v in (vm, ve, [vs]))
    c_ms = {
        "encrypt_djn": host_ms(lambda: cpk.encrypt(pt_vm), wreps),
        "add_ctct": host_ms(lambda: c1 + c2, wreps),
        "mul_ctpt_per_row": host_ms(lambda: c_sum * pt_ve, wreps),
        "mul_ctpt_scalar": host_ms(lambda: c_mul * pt_vs, wreps),
        "apply_obfuscator_djn": host_ms(lambda: cpk.apply_obfuscator(c_mul2), wreps),
        "decrypt_crt": host_ms(lambda: csk.decrypt(c_obf), wreps),
    }
    csk.enable_crt = False
    c_ms["decrypt_raw"] = host_ms(lambda: csk.decrypt(c_obf), wreps)
    csk.enable_crt = True
    emit({"phase": "cios_path", "key_bits": key_bits, "batch": B,
          "oracle_rows": n_oracle, "oracle_ok": True, "equals_rns_backend": True,
          "values_ok": True, "launches": cios_counts["cios"],
          "keygen_seconds": round(c_keygen_s, 3),
          "first_encrypt_seconds": round(first_cios_encrypt_s, 3),
          "host_ms": c_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wreps} warm calls",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    if args.profile:
        for op, fn in (("cios encrypt_djn", lambda: cpk.encrypt(pt_vm)),
                       ("cios decrypt_crt", lambda: csk.decrypt(c_obf))):
            emit(profile_call(op, fn))
    del c1, c2, r1, r2, c_sum, c_mul, c_mul2, c_obf, d_crt, d_raw
    rx_mod = rpk.nsquare  # the 4096-bit modulus of phase rns_mont_exp
    del rkey, rpk, rsk, ckey, cpk, csk
    torch.cuda.empty_cache()

    # -- the modexp API ---------------------------------------------------------------------
    reset_counts()
    m_big = rng.getrandbits(4096) | (1 << 4095) | 1
    bs = [rng.randrange(m_big) for _ in range(B)]
    es = [rng.getrandbits(128) for _ in range(B - 2)] + [0, 1]
    got = counted("modexp, one modulus", lambda: ptorch.modexp(bs, es, m_big),
                  modexp=1)
    if got != [pow(b, e, m_big) for b, e in zip(bs, es)]:
        raise AssertionError("modexp API: 4096-bit modulus differs from pow()")
    mods3 = [rng.getrandbits(w) | (1 << (w - 1)) | 1 for w in (512, 1000, 3072)]
    ms3 = [mods3[i % 3] for i in range(30)]
    bs3 = [rng.getrandbits(3000) for _ in range(30)]
    es3 = [rng.getrandbits(200) for _ in range(30)]
    got3 = counted("modexp, three moduli", lambda: ptorch.modexp(bs3, es3, ms3),
                   modexp=3)
    if got3 != [pow(b, e, m) for b, e, m in zip(bs3, es3, ms3)]:
        raise AssertionError("modexp API: vector of moduli differs from pow()")
    got1 = counted("modexp, scalars", lambda: ptorch.modexp(bs[0], es[0], mods3[1]),
                   modexp=1)
    if got1 != pow(bs[0], es[0], mods3[1]):
        raise AssertionError("modexp API: scalar call differs from pow()")
    torch.cuda.synchronize()
    api_counts = read_counts()
    # K6 at the shape of the one-modulus call: its limbs and windows as
    # ops/api.py makes them, compared on API_PLAIN_NW windows, timed on all
    API_PLAIN_NW = 8
    mc = MontConstants.create(m_big)
    base_api = to_i32(lb.ints_to_limbs(bs, mc.num_limbs), dev)[None]
    wins_api = to_i32(lb.ints_to_windows(es, 128), dev)[None]
    n_api = len(checks)
    k6_check("api", base_api, wins_api, stack_consts([mc]), API_PLAIN_NW, "api")
    if not checks[n_api]["equal"]:
        raise AssertionError("modexp API: K6 differs from its plain version")
    del base_api, wins_api
    emit({"phase": "modexp_api", "rows": B, "modulus_bits": 4096,
          "exponent_bits": 128, "one_modulus_ok": True, "three_moduli_ok": True,
          "scalar_ok": True, "modexp_launches": api_counts["cios"]["modexp"],
          "kernel_ms": checks[n_api]["ms"],
          "host_ms": host_ms(lambda: ptorch.modexp(bs, es, m_big), 3)})

    # -- rns_mont_exp: the reference's windowed exponentiation in RNS --------------------
    # plain torch on the card (the reference's is XLA, no kernel): the n^2 of
    # the 2048-bit key of phase cios_path, 4 rows, 128-bit exponents, against
    # pow(); the canonical value below 2 n^2
    from pailliercryptolib_tpu_torch.ops import rns as trns

    t0 = time.perf_counter()
    rx_ctx = trns.RNSContext.create(rx_mod)
    rx_ctx_s = time.perf_counter() - t0
    rx_conv = rx_ctx.device_consts(dev)
    bs_rx = [rng.randrange(rx_mod) for _ in range(4)]
    es_rx = [rng.getrandbits(128) for _ in range(4)]
    x_rx = to_i32(np.stack([rx_ctx.to_residues(v) for v in bs_rx]), dev)
    w_rx = to_i32(lb.ints_to_windows(es_rx, 128), dev)
    out_rx = counted("rns_mont_exp", lambda: trns.rns_mont_exp(x_rx, w_rx, rx_conv))
    if not out_rx.is_cuda or out_rx.shape != x_rx.shape:
        raise AssertionError("rns_mont_exp: the result is not a [4, K] tensor on the card")
    vals_rx = lb.limbs_to_ints(
        trns.rns_to_limbs(out_rx, rx_conv).cpu().numpy().astype(np.uint32))
    if any(int(v) % rx_mod != pow(b, e, rx_mod) or int(v) > 2 * rx_mod
           for b, e, v in zip(bs_rx, es_rx, vals_rx)):
        raise AssertionError("rns_mont_exp: differs from pow() or not below 2N")
    emit({"phase": "rns_mont_exp", "modulus_bits": rx_mod.bit_length(), "rows": 4,
          "exponent_bits": 128, "k": int(rx_ctx.k), "pow_ok": True,
          "context_seconds": round(rx_ctx_s, 3),
          "host_ms": host_ms(lambda: trns.rns_mont_exp(x_rx, w_rx, rx_conv), 3)})
    del rx_ctx, rx_conv, x_rx, w_rx, out_rx

    # -- the hybrid batch split -----------------------------------------------------------
    # The plain tail on the card is L steps of a dozen small launches a
    # product, so this phase runs at a key width that keeps it short.
    hy_bits, hy_B = 256, 10
    t0 = time.perf_counter()
    ykey = ptorch.generate_keypair(hy_bits, enable_DJN=True)
    ypk, ysk = ykey.pub_key, ykey.priv_key
    yv = [rng.getrandbits(64) for _ in range(hy_B)]

    def spy(engine, method):
        calls = []
        orig = getattr(engine, method)

        def wrapper(*a):
            calls.append(a)
            return orig(*a)

        setattr(engine, method, wrapper)
        return calls

    try:
        ptorch.set_hybrid_mode(ptorch.HybridMode.HALF)
        enc_tail = spy(ypk._engine.secondary, "_encrypt_djn_impl")
        yct = counted("hybrid HALF encrypt", lambda: ypk.encrypt(ptorch.PlainText(yv)),
                      # the head rows; the tail is plain
                      fb_table2=1, fb_modexp2=1)
        if ypk._engine.secondary.backend != "plain" or not yct.device_payload().arr.is_cuda:
            raise AssertionError("hybrid: the twin engine is not the plain backend")
        if [len(c[0]) for c in enc_tail] != [hy_B - hy_B // 2]:
            raise AssertionError(f"hybrid HALF: tail calls {[len(c[0]) for c in enc_tail]}")
        # a device-resident ciphertext skips the split
        dec_tail = spy(ysk._engine.secondary, "_decrypt_crt_impl")
        if ysk.decrypt(yct).texts != yv or dec_tail:
            raise AssertionError("hybrid: device-resident decrypt was split or wrong")
        # host ints split at int(ratio * size)
        ptorch.set_hybrid_ratio(0.4)
        if ptorch.get_hybrid_mode() != ptorch.HybridMode.UNDEFINED:
            raise AssertionError("hybrid: set_hybrid_ratio kept the mode")
        yhost = ptorch.CipherText(ypk, yct.texts)
        ydec = counted("hybrid 0.4 decrypt", lambda: ysk.decrypt(yhost),
                       rns_modexp2f=1, rns_modexp2f_tc_split=1,
                       mod_mul=2)
        if ydec.texts != yv or [len(c[0]) for c in dec_tail] != [hy_B - int(0.4 * hy_B)]:
            raise AssertionError("hybrid ratio 0.4: wrong split or values")
        # a "cios" primary splits the same way
        ypk._engine.backend = "cios"
        yct2 = counted("hybrid 0.4 cios encrypt",
                       lambda: ypk.encrypt(ptorch.PlainText(yv)), modexp=1,
                       mod_mul=1)
        ypk._engine.backend = "rns"
        if ysk.decrypt(ptorch.CipherText(ypk, yct2.texts)).texts != yv:
            raise AssertionError("hybrid: cios head + plain tail decrypts wrong")
        if [len(c[0]) for c in enc_tail][1:] != [hy_B - int(0.4 * hy_B)]:
            raise AssertionError("hybrid ratio 0.4 (cios): wrong split")
    finally:
        ptorch.set_hybrid_off()
    n_tail = (len(enc_tail), len(dec_tail))
    yct3 = counted("encrypt after set_hybrid_off",
                   lambda: ypk.encrypt(ptorch.PlainText(yv)), fb_modexp2=1)
    ydec3 = counted("decrypt after set_hybrid_off",
                    lambda: ysk.decrypt(ptorch.CipherText(ypk, yct3.texts)),
                    rns_modexp2f=1, rns_modexp2f_tc_split=1,
                    mod_mul=2)
    if ydec3.texts != yv or (len(enc_tail), len(dec_tail)) != n_tail:
        raise AssertionError("set_hybrid_off: the batch was still split")
    if not ptorch.get_hybrid_mode() == ptorch.HybridMode.OPTIMAL:
        raise AssertionError("set_hybrid_off: mode not OPTIMAL")
    emit({"phase": "hybrid", "key_bits": hy_bits, "batch": hy_B,
          "half_tail_rows": hy_B - hy_B // 2, "ratio_0.4_tail_rows": hy_B - int(0.4 * hy_B),
          "device_resident_skips_split": True, "off_restores_single_backend": True,
          "values_ok": True, "seconds": round(time.perf_counter() - t0, 3)})


    # -- wide keys: the kernels at their shapes --------------------------------------------
    # One 4096-bit DJN key serves the kernel checks (its engines' constant
    # sets) and the wide path below (its fixed-base table is built there, by the
    # first encrypt); a 3072-bit key serves the 480-lane check and its own phase.
    WIDE_PLAIN_NW = 64  # windows on which the long modexps are compared
    t0 = time.perf_counter()
    wkey = ptorch.generate_keypair(4096, enable_DJN=True)
    w_keygen_s = time.perf_counter() - t0
    wpk, wsk = wkey.pub_key, wkey.priv_key
    t0 = time.perf_counter()
    _, wkc, _ = wpk._engine.rns
    w_ctx_s = time.perf_counter() - t0
    wpack = cuda_rns2._kernel_pack(wkc)
    wform = (wpack["f32"], wpack["lean"], wpack["W"])
    if wform != (True, False, 640):
        raise AssertionError(f"4096-bit n^2 constant set has form {wform}")
    wk = wpack["k"]
    NPw = max(8, -(-(-(-wpk.randbits // 8)) // 8) * 8)
    n_before = len(checks)
    gA = residues(wkc["modsA"][0], NPw)
    gB = residues(wkc["modsBx"][0], NPw)
    tabs = k1_check("fb_table2[w640]", gA, gB, wkc, ("wide", "rns", "fb_table2"))
    wins = torch.from_numpy(
        nprng.integers(0, 256, (1, B, NPw), dtype=np.uint8)).to(dev)
    tab = fb_check("fb_modexp2[w640]", tabs, wins, wkc, ("wide", "rns", "fb_modexp2"))
    fb_table_bytes = {"planes": nbytes(tab)}
    del tabs, tab, wins
    torch.cuda.empty_cache()
    base5 = to_i32(nprng.integers(0, 1 << 15, (1, B, wpk._engine.L2)), dev)
    k5_check("shared@w640", base5, wpk._engine.n_wins, wkc, True, "wide", WIDE_PLAIN_NW)
    pt_wins = to_i32(nprng.integers(0, 16, (1, B, 16)), dev)
    k5_check("var@w640", base5, pt_wins, wkc, False, "wide")
    wkc2, _ = wsk._engine.rns_crt
    if wsk._engine.crt_folded or "maskB" in wkc2:
        raise AssertionError("a 4096-bit key's CRT decrypt must take the grouped layout")
    ct_l = to_i32(nprng.integers(0, 1 << 15, (1, B, wkc2["CinA"].shape[-2])), dev)
    k5_check("grouped@L548", ct_l, wsk._engine.exp_wins[:, 0].contiguous(), wkc2, True,
             "wide", WIDE_PLAIN_NW)
    # K6, K7 and K4 at the shapes the "cios" calls of the wide path give them:
    # the DJN encrypt's shared base hs under n^2 with randbits / 4 windows a
    # row, the CRT decrypt's grouped modexp, fold and tail at p^2 / q^2 and
    # p / q width, and the product at n^2 width.  The long modexps are
    # compared on WIDE_CIOS_NW windows (the plain version is thousands of
    # small launches a product), timed on all.
    WIDE_CIOS_NW = 8
    wpub, wprv = wpk._engine, wsk._engine
    wn2c = stack_consts([wpub.mont_n2])
    wsqc = stack_consts([wprv.mont_p2, wprv.mont_q2])
    wL2, wLp, wLp2 = wpub.L2, wprv.Lp, wprv.Lp2
    r_wins = to_i32(nprng.integers(0, 16, (1, B, -(-wpk.randbits // 4))), dev)
    k6_check("var@L%d" % wL2, wpub.hs_limbs[None, None], r_wins, wn2c, WIDE_CIOS_NW,
             "wide")
    base_g = to_i32(nprng.integers(0, 1 << 15, (2, B, wLp2)), dev)
    base_g[..., -1] = 0  # below R
    k6_check("grouped@L%d" % wLp2, base_g, wprv.exp_wins, wsqc, WIDE_CIOS_NW, "wide")
    k47_check("mont_raw[L%d]" % wLp2, "mont_raw", base_g, wprv.sq_r2[:, None, :],
              wsqc[:2], "wide")
    a_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, wL2)), dev)
    a_n2[..., -1] = 0
    b_n2 = to_i32(nprng.integers(0, 1 << 15, (1, B, wL2)), dev)
    b_n2[..., -1] = 0
    k47_check("mod_mul[n2@L%d]" % wL2, "mod_mul", a_n2, b_n2, wn2c[:3], "wide")
    a_pq = to_i32(nprng.integers(0, 1 << 15, (2, B, wLp)), dev)
    a_pq[..., -2:] = 0  # below p and q
    k47_check("mod_mul[crt@L%d]" % wLp, "mod_mul", a_pq, wprv.hfun[:, None, :],
              (wprv.pq_n, wprv.pq_n0inv, wprv.pq_r2), "wide")
    del base5, pt_wins, ct_l, r_wins, base_g, a_n2, b_n2, a_pq, wn2c, wsqc, wpub, wprv
    t0 = time.perf_counter()
    key3 = ptorch.generate_keypair(3072, enable_DJN=True)
    keygen3_s = time.perf_counter() - t0
    _, kc3, _ = key3.pub_key._engine.rns
    if cuda_rns2._kernel_pack(kc3)["W"] != 480:
        raise AssertionError("3072-bit n^2 constant set is not 480 lanes wide")
    base3 = to_i32(nprng.integers(0, 1 << 15, (1, B, key3.pub_key._engine.L2)), dev)
    k5_check("shared@w480", base3, key3.pub_key._engine.n_wins, kc3, True, "wide3072",
             WIDE_PLAIN_NW)
    # K2 at 480 lanes (padded to 512): the 3072-bit key's own table shape
    NP3 = max(8, -(-(-(-key3.pub_key.randbits // 8)) // 8) * 8)
    tabs3 = cuda_rns2.fb_table2(residues(kc3["modsA"][0], NP3)[None],
                                residues(kc3["modsBx"][0], NP3)[None], kc3)
    wins3 = torch.from_numpy(nprng.integers(0, 256, (1, B, NP3), dtype=np.uint8)).to(dev)
    fb_check("fb_modexp2[w480]", tabs3, wins3, kc3, ("wide3072", "rns", "fb_modexp2"))
    del base3, tabs3, wins3
    wide_checks = checks[n_before:]
    emit({"phase": "wide_kernel_checks", "key_bits": [4096, 3072], "rows": B,
          "keygen_seconds": round(w_keygen_s, 3),
          "keygen_3072_seconds": round(keygen3_s, 3),
          "n2_context_seconds": round(w_ctx_s, 3),
          "form_4096": {"f32": wform[0], "lean": wform[1], "W": wform[2], "k": wk},
          "fb_gather_table_bytes": fb_table_bytes,
          "checks": [{kk: v for kk, v in c.items()
                      if kk in ("name", "equal", "kernel_ms", "plain_ms", "shape",
                                "nw", "plain_nw", "full_nw_rows", "max_active_clusters",
                                "graph_ms")}
                     for c in wide_checks]})
    if not all(c["equal"] for c in wide_checks):
        raise AssertionError("a kernel differs from its plain version: "
                             + str([c["name"] for c in wide_checks if not c["equal"]]))
    torch.cuda.empty_cache()

    # -- the wide path: 4096-bit keys through the public API ----------------------------------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    wn, wn2 = wpk.n, wpk.nsquare
    va = [rng.getrandbits(64) for _ in range(B)]
    vb = [rng.getrandbits(64) for _ in range(B)]
    ve = [rng.getrandbits(64) for _ in range(B)]
    vs = rng.getrandbits(64)
    pt_a, pt_b, pt_e, pt_s = (ptorch.PlainText(v) for v in (va, vb, ve, [vs]))
    t0 = time.perf_counter()
    wa = counted("wide DJN encrypt", lambda: wpk.encrypt(pt_a),
                 # fresh DeviceSeed; builds the table
                 fb_table2=1, fb_modexp2=1)
    w_first_encrypt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wd = counted("wide CRT decrypt", lambda: wsk.decrypt(wa),  # grouped K5, no folded kernel
                 rns_modexp2=1, rns_modexp2_tc_split=1, grouped=1,
                 mod_mul=2)
    w_first_decrypt_s = time.perf_counter() - t0
    if wd.texts != va:
        raise AssertionError("wide path: decrypt(encrypt(m)) != m")
    n_oracle = 64
    rs_w = [rng.getrandbits(wpk.randbits) for _ in range(n_oracle)]
    wpk.set_random(rs_w)
    w64 = counted("wide DJN encrypt (injected r)",
                  lambda: wpk.encrypt(ptorch.PlainText(va[:n_oracle])),
                  fb_modexp2=1)
    if w64.texts != [(wn * m + 1) * pow(wpk.hs, r, wn2) % wn2
                     for m, r in zip(va, rs_w)]:
        raise AssertionError("wide path: injected-r ciphertexts differ from pow()")
    wb = counted("wide DJN encrypt", lambda: wpk.encrypt(pt_b),
                 fb_modexp2=1)
    w_sum = counted("wide ct + ct", lambda: wa + wb)
    w_m1 = counted("wide ct * pt (per-row)", lambda: w_sum * pt_e,
                   rns_modexp2=1, var=1)
    w_m2 = counted("wide ct * pt (scalar)", lambda: w_m1 * pt_s,
                   rns_modexp2=1, shared=1)
    w_ob = counted("wide apply_obfuscator", lambda: wpk.apply_obfuscator(w_m2),
                   fb_modexp2=1)
    for t in (wa, w_sum, w_m1, w_m2, w_ob):
        assert t.device_payload().arr.is_cuda and t._texts is None
    want_w = [((x + y) * e * vs) % wn for x, y, e in zip(va, vb, ve)]
    wd_crt = counted("wide CRT decrypt", lambda: wsk.decrypt(w_ob),
                     rns_modexp2=1, rns_modexp2_tc_split=1, grouped=1,
                     mod_mul=2)
    wsk.enable_crt = False
    wd_raw = counted("wide RAW decrypt", lambda: wsk.decrypt(w_ob),
                     rns_modexp2=1, shared=1, mod_mul=1)
    wsk.enable_crt = True
    if wd_crt.texts != want_w or wd_raw.texts != want_w:
        raise AssertionError("wide path: decrypted values differ from "
                             "((a + b) * e * s) mod n")
    if w_ob.texts == w_m2.texts:
        raise AssertionError("wide path: apply_obfuscator left the ciphertexts unchanged")
    # normal mode on the same modulus: a non-DJN public key of the same n
    npk = ptorch.PublicKey(wn, 4096)
    wc = counted("wide normal encrypt", lambda: npk.encrypt(pt_a),
                 rns_modexp2=1, shared=1)
    rs8 = [rng.randrange(1, wn) for _ in range(8)]
    npk.set_random(rs8)
    wc8 = counted("wide normal encrypt (injected r)",
                  lambda: npk.encrypt(ptorch.PlainText(va[:8])),
                  rns_modexp2=1, shared=1)
    if wc8.texts != [(wn * m + 1) * pow(r, wn, wn2) % wn2 for m, r in zip(va, rs8)]:
        raise AssertionError("wide path: normal-mode ciphertexts differ from pow()")
    if counted("wide CRT decrypt", lambda: wsk.decrypt(wc),
               rns_modexp2=1, rns_modexp2_tc_split=1, grouped=1,
               mod_mul=2).texts != va:
        raise AssertionError("wide path: normal-mode round trip failed")
    # the same key on the "cios" backend
    set_config(Config(backend="cios"))
    try:
        wckey = keys_from_ints(wn, wsk.p, wsk.q, wpk.hs, wpk.randbits)
        wcpk, wcsk = wckey.pub_key, wckey.priv_key
        backends = (wcpk._engine.backend, wcsk._engine.backend, wpk._engine.backend)
    finally:
        set_config(Config())
    if backends != ("cios", "cios", "rns"):
        raise AssertionError(f"wide path: engines on {backends}")
    wcpk.set_random(rs_w)
    wc64 = counted("wide cios DJN encrypt",
                   lambda: wcpk.encrypt(ptorch.PlainText(va[:n_oracle])),
                   modexp=1, mod_mul=1)
    if wc64.texts != w64.texts:
        raise AssertionError("wide path: cios ciphertexts differ from the rns backend's")
    wcd = counted("wide cios CRT decrypt", lambda: wcsk.decrypt(w_ob),
                  mont_raw=1, modexp=1, mod_mul=2)
    if wcd.texts != want_w:
        raise AssertionError("wide path: the cios backend decrypts rns ciphertexts wrong")
    # the whole batch with fresh obfuscators (the shape the K6 check above holds)
    wcb = counted("wide cios DJN encrypt (batch)", lambda: wcpk.encrypt(pt_b),
                  modexp=1, mod_mul=1)
    if counted("wide cios CRT decrypt", lambda: wcsk.decrypt(wcb),
               mont_raw=1, modexp=1, mod_mul=2).texts != vb:
        raise AssertionError("wide path: cios round trip failed")
    for eng in (wpk._engine, wsk._engine, npk._engine, wcpk._engine, wcsk._engine):
        if eng._secondary is not None:
            raise AssertionError("an engine built its plain twin under the defaults")
    torch.cuda.synchronize()
    wide_counts = read_counts()
    w_launches = {**wide_counts["rns"], **wide_counts["cios"]}
    if wide_counts["rns"]["rns_modexp2f"] != 0:
        raise AssertionError("wide path launched the folded CRT kernel")
    w_peak = torch.cuda.max_memory_allocated()
    wr = 3
    w_ms = {
        "encrypt_djn": host_ms(lambda: wpk.encrypt(pt_a), wr),
        "decrypt_crt": host_ms(lambda: wsk.decrypt(w_ob), wr),
        "add_ctct": host_ms(lambda: wa + wb, wr),
        "mul_ctpt_per_row": host_ms(lambda: w_sum * pt_e, wr),
        "mul_ctpt_scalar": host_ms(lambda: w_m1 * pt_s, wr),
        "apply_obfuscator_djn": host_ms(lambda: wpk.apply_obfuscator(w_m2), wr),
        "encrypt_normal": host_ms(lambda: npk.encrypt(pt_a), wr),
        "cios_encrypt_djn": host_ms(lambda: wcpk.encrypt(pt_a), wr),
        "cios_decrypt_crt": host_ms(lambda: wcsk.decrypt(w_ob), wr),
    }
    wsk.enable_crt = False
    w_ms["decrypt_raw"] = host_ms(lambda: wsk.decrypt(w_ob), wr)
    wsk.enable_crt = True
    emit({"phase": "wide_path", "key_bits": 4096, "batch": B,
          "roundtrip_ok": True, "oracle_rows": n_oracle, "oracle_ok": True,
          "values_ok": True, "normal_oracle_ok": True, "equals_cios_backend": True,
          "cios_decrypts_rns": True, "launches": w_launches,
          "rns_modexp2_forms": wide_counts["k5"],
          "keygen_seconds": round(w_keygen_s, 3),
          "table_build_seconds": round(wpk._engine.fb_build_seconds, 3),
          "first_encrypt_seconds": round(w_first_encrypt_s, 3),
          "first_decrypt_seconds": round(w_first_decrypt_s, 3),
          "host_ms": w_ms,
          "timing": f"host wall to torch.cuda.synchronize(), median of {wr} warm calls",
          "peak_device_bytes": w_peak})
    if args.profile:
        for op, fn in (("wide encrypt", lambda: wpk.encrypt(pt_a)),
                       ("wide decrypt", lambda: wsk.decrypt(w_ob)),
                       ("wide encrypt_normal", lambda: npk.encrypt(pt_a))):
            emit(profile_call(op, fn))
    del wa, wb, wd, w64, w_sum, w_m1, w_m2, w_ob, wd_crt, wd_raw, wc, wc8, wc64, wcd, wcb
    del wkey, wpk, wsk, npk, wckey, wcpk, wcsk, wkc, wkc2
    torch.cuda.empty_cache()

    # -- 3072-bit keys, a ragged batch ---------------------------------------------------------
    reset_counts()
    B3 = 300
    pk3, sk3 = key3.pub_key, key3.priv_key
    vals3 = [rng.getrandbits(64) for _ in range(B3)]
    ct3 = counted("3072-bit DJN encrypt", lambda: pk3.encrypt(ptorch.PlainText(vals3)),
                  fb_table2=1, fb_modexp2=1)
    d3 = counted("3072-bit CRT decrypt", lambda: sk3.decrypt(ct3),
                 rns_modexp2=1, rns_modexp2_tc_split=1, grouped=1,
                 mod_mul=2)
    sk3.enable_crt = False
    d3r = counted("3072-bit RAW decrypt", lambda: sk3.decrypt(ct3),
                  rns_modexp2=1, shared=1, mod_mul=1)
    sk3.enable_crt = True
    if d3.texts != vals3 or d3r.texts != vals3:
        raise AssertionError("3072-bit keys: decrypt(encrypt(m)) != m")
    wide3_counts = read_counts()
    emit({"phase": "wide_3072", "key_bits": 3072, "batch": B3, "roundtrip_ok": True,
          "raw_roundtrip_ok": True, "crt_layout": "grouped",
          "launches": {**wide3_counts["rns"], **wide3_counts["cios"]},
          "keygen_seconds": round(keygen3_s, 3)})
    del ct3, d3, d3r, key3, pk3, sk3, kc3
    torch.cuda.empty_cache()

    # -- the probes ------------------------------------------------------------------------------
    probe_counts, probe_launches = probes_phase(
        check, checks, psrc, reps, dev, sm_count, max_clock_mhz, p5_runs,
        reset_counts, read_counts)

    # -- serialization ---------------------------------------------------------------------------
    t0 = time.perf_counter()
    skey = ptorch.generate_keypair(key_bits, enable_DJN=True)
    spk, ssk = skey.pub_key, skey.priv_key
    Bs = 256
    vals_s = [rng.getrandbits(64) for _ in range(Bs)]
    cts = spk.encrypt(ptorch.PlainText(vals_s))
    if cts._texts is not None or not cts.device_payload().arr.is_cuda:
        raise AssertionError("serialize: the ciphertext batch is not device-resident")
    blob_pk, blob_sk, blob_ct = ser.dumps(spk), ser.dumps(ssk), ser.dumps(cts)
    pk2 = ser.loads(blob_pk, ptorch.PublicKey)
    sk2 = ser.loads(blob_sk, ptorch.PrivateKey)
    ct2 = ser.loads(blob_ct, ptorch.CipherText)
    if (pk2.n, pk2.hs, pk2.randbits, pk2.bits) != (spk.n, spk.hs, spk.randbits, spk.bits):
        raise AssertionError("serialize: the public key changed")
    if (sk2.p, sk2.q) != (ssk.p, ssk.q) or ct2.public_key.n != spk.n:
        raise AssertionError("serialize: the private key or the ciphertext's key changed")
    if ser.dumps(pk2) != blob_pk or ser.dumps(ct2) != blob_ct:
        raise AssertionError("serialize: bytes differ after a round trip")
    if sk2.decrypt(ct2).texts != vals_s or ssk.decrypt(pk2.encrypt(
            ptorch.PlainText(vals_s))).texts != vals_s:
        raise AssertionError("serialize: loaded keys or ciphertexts decrypt wrong")
    if sk2._engine.device.type != "cuda" or pk2._engine.device.type != "cuda":
        raise AssertionError("serialize: loaded keys do not run on the card")
    emit({"phase": "serialize", "key_bits": key_bits, "batch": Bs,
          "bytes": {"public_key": len(blob_pk), "private_key": len(blob_sk),
                    "ciphertext": len(blob_ct)},
          "roundtrip_ok": True, "seconds": round(time.perf_counter() - t0, 3)})

    # -- the mesh split, the host-RNG switch, the native codec, the examples ---------
    emit(mesh_phase(card, args.seed, counted))

    probe_counts["probe_runs"] = probe_launches
    path_counts = {"main": main_counts, "homo": homo_counts, "legacy_stage": stage_counts,
                   "cios": cios_counts,
                   "api": api_counts, "wide": wide_counts, "wide3072": wide3_counts,
                   "probes": probe_counts}
    for c in checks:
        path, grp, name = c.pop("_count")
        c["launches"] = path_counts[path][grp][name]
        if c["launches"] < 1:
            raise AssertionError(f"{c['name']} was launched no time on its path")
    emit({"kernels": checks})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
