#!/usr/bin/env python3
"""Measure the choices behind the 32-bit K4 and K7 on one NVIDIA GPU.

    python3 tools/k47_forms.py

Builds tools/k47_forms.cu twice (the K4 part with the library's
csrc/mod_mul.cu in it, the K7 part with csrc/mont_raw.cu; both nvcc runs
started together) into one library under build/, then prints the card's
name and power limit and one JSON line a shape, at the shapes the paths give
the two kernels (2048 rows): K4 at [2, 69] and [2, 137] (the CRT tails of
2048- and 4096-bit keys, one shared multiplier a group), [1, 274] and
[1, 547] (the ``"cios"`` products under n^2 of those keys, per-row
multipliers); K7 at [2, 137] and [2, 274] (the CRT fold of those keys, one
shared r2 a group).  Each candidate runs at 8, 16 and 32 lanes a row:

* K4 ``shift`` (the library's: a 2^d and b 2^d into words, two products
  through the 15-bit r2), ``rows`` (R32^2 mod n derived per row by 2d
  doublings, then two products), ``block`` (that constant derived once a
  block), ``prologue`` (the doublings of ``rows`` alone, writing R32^2 mod n);
* K7 ``shift`` (the library's: one product mont32(a 2^d, b)) and
  ``doublings`` (mont32(a, b), then d doublings mod n).

Every candidate's output is held equal to ``cuda_modexp.mod_mul`` /
``mont_raw`` on the same inputs (``prologue`` to R32^2 mod n from Python
ints).  Times: ``graph_ms``, body to body (GRAPH launches captured in one
CUDA graph, the replay timed by CUDA events, median of 3, over GRAPH), and
``ms``, one launch between CUDA events (median of 3); the candidates run in
turns, in order and then in reverse, each time the mean of the two.  Exits
non-zero without a GPU.  Numbers: PERF.md (K4 / K7 findings).
"""

from __future__ import annotations

import ctypes
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, GRAPH, REPS = 2048, 100, 3
LANES = (8, 16, 32)
K4_FORMS = ("shift", "rows", "block", "prologue")
K7_FORMS = ("shift", "doublings")
# (kernel, modulus bits, groups, shared multiplier)
SHAPES = (("k4", 1024, 2, True), ("k4", 2048, 2, True), ("k4", 4096, 1, False),
          ("k4", 8190, 1, False), ("k7", 2048, 2, True), ("k7", 4096, 2, True))


def ms(fn, reps=REPS):
    t = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        t.append(a.elapsed_time(b))
    return statistics.median(t)


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return ms(graph.replay) / GRAPH


def build(_build):
    """The two parts compiled together, then linked; returns (library,
    ptxas report)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "k47_forms.so"
    objs = [_build.BUILD_DIR / f"k47_forms_{p}.o" for p in (0, 1)]
    outs = _build._run_all([
        [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, f"-DK47_PART={p}",
         "-c", str(ROOT / "tools" / "k47_forms.cu"), "-o", str(obj)]
        for p, obj in enumerate(objs)])
    _build._run_all([[_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(so),
                      *map(str, objs)]])
    return ctypes.CDLL(str(so)), "\n".join(outs)


def main() -> int:
    if not torch.cuda.is_available():
        print("k47_forms: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp as cm
    from pailliercryptolib_tpu_torch.ops import limbs as lb
    from pailliercryptolib_tpu_torch.ops.montgomery import MontConstants, to_i32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib, report = build(_build)
    print(json.dumps({"ptxas": [s for s in _build.parse_ptxas(report)
                                if s["kernel"].startswith(("k4_const", "k7_dbl", "mod_mul32",
                                                           "mont_raw32"))]}), flush=True)
    Pp, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k4_forms_launch.argtypes = [I, I, Pp, Pp, LL, LL, Pp, Pp, Pp, I, I, I, Pp]
    lib.k7_forms_launch.argtypes = [I, I, Pp, Pp, LL, LL, Pp, Pp, I, I, I, Pp]
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rng = random.Random(47)

    for kernel, bits, G, shared in SHAPES:
        ns = [rng.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(G)]
        cs = [MontConstants.create(n) for n in ns]
        L = cs[0].num_limbs
        n = to_i32(np.stack([c.n_limbs for c in cs]), dev)
        r2 = to_i32(np.stack([c.r2_limbs for c in cs]), dev)
        n0 = to_i32(np.array([c.n0inv for c in cs], np.uint32), dev)
        a = to_i32(np.stack([lb.ints_to_limbs([rng.randrange(m) for _ in range(B)], L)
                             for m in ns]), dev)
        b = to_i32(np.stack([lb.ints_to_limbs([rng.randrange(m) for _ in range(
            1 if shared else B)], L) for m in ns]), dev)
        if kernel == "k7":  # the fold: the high half of a ciphertext times r2
            b = r2[:, None, :]
            a[..., -1] = rng.getrandbits(15)
        be = b.expand(G, B, L)
        want = (cm.mod_mul(a, b, n, n0, r2) if kernel == "k4"
                else cm.mont_raw(a, b, n, n0))
        R32 = 1 << (32 * cm.words_for(L))
        want_c = to_i32(np.stack([lb.ints_to_limbs([R32 * R32 % m], L)[0] for m in ns]),
                        dev)[:, None, :].expand(G, B, L)
        runs, rec = {}, {"kernel": kernel, "groups": G, "rows": B, "limbs": L,
                         "words": cm.words_for(L), "shared_multiplier": shared}
        forms = K4_FORMS if kernel == "k4" else K7_FORMS
        for f, form in enumerate(forms):
            for tpi in LANES:
                out = torch.empty((G, B, L), dtype=torch.int32, device=dev)
                if kernel == "k4":
                    run = (lambda f=f, tpi=tpi, out=out: lib.k4_forms_launch(
                        f, tpi, a.data_ptr(), be.data_ptr(), be.stride(0), be.stride(1),
                        n.data_ptr(), r2.data_ptr(), out.data_ptr(), G, B, L, stream()))
                else:
                    run = (lambda f=f, tpi=tpi, out=out: lib.k7_forms_launch(
                        f, tpi, a.data_ptr(), be.data_ptr(), be.stride(0), be.stride(1),
                        n.data_ptr(), out.data_ptr(), G, B, L, stream()))
                if run() != 0:
                    raise RuntimeError(f"{kernel} {form} at {tpi} lanes: launch failed")
                torch.cuda.synchronize()
                key = f"{form}@{tpi}"
                rec[f"equal_{key}"] = bool(torch.equal(out, want_c if form == "prologue"
                                                       else want))
                runs[key] = run
        t = {key: [] for key in runs}
        g = {key: [] for key in runs}
        for key in list(runs) + list(runs)[::-1]:
            t[key].append(ms(runs[key]))
            g[key].append(graph_ms(runs[key]))
        rec["ms"] = {key: sum(v) / 2 for key, v in t.items()}
        rec["graph_ms"] = {key: sum(v) / 2 for key, v in g.items()}
        rec["equal"] = all(v for k, v in rec.items() if k.startswith("equal_"))
        print(json.dumps(rec), flush=True)
        if not rec["equal"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
