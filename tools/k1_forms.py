#!/usr/bin/env python3
"""Measure the layouts behind K1's tensor-core form on one NVIDIA GPU.

    python3 tools/k1_forms.py [--only INDEX ...]

Builds tools/k1_forms.cu (with the library's csrc/fb_table2.cu in it) into
build/ while the library builds, then prints the card's name and power limit
and one JSON line a width: the fixed-base table of an odd 4096-bit modulus
(n^2 of a 2048-bit key: 320 lanes, integer Barrett, 128 window positions)
and of an odd 8192-bit modulus (n^2 of a 4096-bit key: 640 lanes, the f32
reduction with the full fold, 256 positions), each built by

* every candidate layout of tools/k1_forms.cu at that width, held equal to
  ``cuda_rns2.fb_table2_plain`` (the kernel is a chain of 255 dependent
  products, so ``ms / 255`` is the latency of one product there), with the
  clusters the card holds at once (``cudaOccupancyMaxActiveClusters``), the
  clusters a launch needs and the dynamic shared memory of a CTA;
* the library's ``fb_table2``.

CUDA events, median of 3; the forms in turns (each twice, in one order and
then the reverse).  ``--only`` runs the named candidates (and the widths
they belong to) alone; the tool library is rebuilt only when a source is
newer.  Exits non-zero without a GPU.  Numbers: PERF.md (K1).
"""

from __future__ import annotations

import argparse
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

# index in tools/k1_forms.cu -> (CTAs a cluster, m-tiles, widest set)
LAYOUTS = {0: (4, 1, 320), 2: (4, 9, 320), 3: (4, 3, 320), 4: (8, 1, 320),
           1: (8, 3, 640), 5: (8, 9, 640), 6: (8, 1, 640)}
SHAPES = ((4096, 128, (0, 2, 3, 4)), (8192, 256, (1, 5, 6)))  # modulus bits, NP, layouts
NTAB = 256


def ms(fn, reps=3):
    t = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        t.append(a.elapsed_time(b))
    return statistics.median(t)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, nargs="+", default=sorted(LAYOUTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_forms: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from pailliercryptolib_tpu_torch.ops import _build, cuda_rns2 as cr
    from pailliercryptolib_tpu_torch.ops.montgomery import to_i32
    from pailliercryptolib_tpu_torch.ops.rns import RNSContext

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "k1_forms.so"
    sources = [ROOT / "tools" / "k1_forms.cu", *_build.CSRC.glob("*.cu*")]
    if not so.exists() or so.stat().st_mtime < max(p.stat().st_mtime for p in sources):
        tool = subprocess.Popen([_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                                 "-shared", "-o", str(so), str(sources[0])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _build.load()  # the library, built meanwhile
        out, _ = tool.communicate()
        if tool.returncode:
            print(out[-4000:], file=sys.stderr)
            return 1
        print(json.dumps({"ptxas": [s for s in _build.parse_ptxas(out)
                                    if s["kernel"].startswith("fb_table2_tc_kernel")]}),
              flush=True)
    _build.load()
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k1_forms_launch.argtypes = [I] + [P] * 8 + [I] * 5 + [P]
    lib.k1_forms_max_clusters.argtypes = [I] * 4
    lib.k1_forms_smem_bytes.argtypes = [I]
    dev = torch.device("cuda")
    rng, nprng = random.Random(1), np.random.default_rng(1)

    for bits, NP, cands in SHAPES:
        cands = [ly for ly in cands if ly in args.only]
        if not cands:
            continue
        N = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        kc = cr.stack_group_consts2([RNSContext.create(N)], device=dev)
        p = cr._kernel_pack(kc)
        k = p["k"]

        def residues(mods):
            m = mods.cpu().numpy().astype(np.int64)
            return to_i32(nprng.integers(0, 1 << 30, (NP, m.shape[0])) % m, dev)[None]

        gA, gB = residues(kc["modsA"][0]), residues(kc["modsBx"][0])
        want = cr.fb_table2_plain(gA, gB, kc)
        rec = {"modulus_bits": bits, "k": k, "W": p["W"], "f32": p["f32"], "lean": p["lean"],
               "positions": NP, "library_layout": cr.tc_layout(p["W"], "fb_table2")}
        runs = {"library": lambda: cr.fb_table2(gA, gB, kc)}
        for ly in cands:
            cluster, mt, max_w = LAYOUTS[ly]
            tcp = cr._tc_pack_layout(kc, (cluster, mt, p["W"]))
            tabA = torch.empty_like(want[0])
            tabB = torch.empty_like(want[1])
            runs[ly] = (lambda tcp=tcp, tabA=tabA, tabB=tabB, ly=ly: (lib.k1_forms_launch(
                ly, gA.data_ptr(), gB.data_ptr(), tcp["rowc"].data_ptr(), tcp["T1"].data_ptr(),
                tcp["T2"].data_ptr(), tcp["T1a"].data_ptr(), tabA.data_ptr(), tabB.data_ptr(),
                NP, NTAB, k, k + 1, tcp["W"], torch.cuda.current_stream().cuda_stream),
                tabA, tabB))
            err = runs[ly]()[0]
            torch.cuda.synchronize()
            rows = 8 * mt
            rec[f"layout_{ly}"] = {
                "cluster": cluster, "mt": mt, "max_w": max_w, "launch_error": err,
                "equal": err == 0 and torch.equal(tabA, want[0]) and torch.equal(tabB, want[1]),
                "clusters": -(-NP // rows),
                "max_active_clusters": lib.k1_forms_max_clusters(ly, k, k + 1, tcp["W"]),
                "smem_bytes": lib.k1_forms_smem_bytes(ly)}
        got = runs["library"]()
        torch.cuda.synchronize()
        rec["equal_library"] = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        order = list(runs)
        t = {name: [] for name in order}
        for name in order + order[::-1]:
            t[name].append(ms(runs[name]))
        for name, v in t.items():
            if isinstance(name, int):
                rec[f"layout_{name}"].update(ms=sum(v) / 2, turns_ms=v,
                                             us_per_product=sum(v) / 2 / (NTAB - 1) * 1e3)
            else:
                rec[f"ms_{name}"] = sum(v) / 2
                rec[f"turns_ms_{name}"] = v
        print(json.dumps(rec), flush=True)
        del kc, gA, gB, want, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
