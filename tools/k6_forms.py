#!/usr/bin/env python3
"""Measure the choices behind K6's 32-bit form on one NVIDIA GPU.

    python3 tools/k6_forms.py

Builds tools/k6_forms.cu (with the library's csrc/modexp.cu in it) into
build/, then prints the card's name and power limit and one JSON line a
measurement:

* ``lanes``: the library's modexp32_kernel at 8, 16 and 32 lanes a row at
  the DJN encrypt shapes of 2048- and 4096-bit keys (one base shared by 2048
  rows, n^2 of 274 / 547 limbs, 256 / 512 windows), each held equal to
  ``cuda_modexp.modexp``; CUDA events, median of 3, the lane counts in turns.
* ``product``: one chain of 100 Montgomery squarings a row, 2048 rows, at
  129 and 257 words, in three forms of the 32-bit product (the library's
  columns, a carry chain along the lane, PTX mad.cc chains) and at each lane
  count; the forms' outputs equal, row 0 against Python ints.

Exits non-zero without a GPU.  Numbers: PERF.md (K6 findings).
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

SHAPES = ((4096, 256), (8190, 512))  # modulus bits of n^2 (274 / 547 limbs), windows
PAIRS = ((32, 5), (16, 9), (8, 17), (32, 9), (16, 17), (8, 33))  # as K6FORMS_EACH
FORMS = ("columns", "carry_chain", "ptx_madc")
B, P = 2048, 100


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
    if not torch.cuda.is_available():
        print("k6_forms: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from pailliercryptolib_tpu_torch.ops import _build, cuda_modexp as cm
    from pailliercryptolib_tpu_torch.ops import limbs as lb
    from pailliercryptolib_tpu_torch.ops.montgomery import MontConstants, to_i32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "k6_forms.so"
    r = subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
                        "-o", str(so), str(ROOT / "tools" / "k6_forms.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
        return 1
    print(json.dumps({"ptxas": [s for s in _build.parse_ptxas(r.stdout + r.stderr)
                                if s["kernel"].startswith(("chain_kernel", "modexp32_kernel<8",
                                                           "modexp32_kernel<32"))]}))
    lib = ctypes.CDLL(str(so))
    Pp, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.forms_modexp_launch.argtypes = [I, Pp, LL, LL, Pp, LL, LL, Pp, Pp, Pp, Pp, Pp, I, I, I, I, Pp]
    lib.forms_table_words.argtypes = [I, I, I, I]
    lib.forms_table_words.restype = LL
    lib.forms_chain_launch.argtypes = [I, I, I, Pp, Pp, ctypes.c_uint, Pp, I, I, I, Pp]
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rng, nprng = random.Random(8), np.random.default_rng(8)

    for bits, NW in SHAPES:
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        c = MontConstants.create(n)
        L = c.num_limbs
        nt, r2, one = (to_i32(a[None], dev) for a in (c.n_limbs, c.r2_limbs, c.one_limbs))
        n0 = to_i32(np.array([c.n0inv], np.uint32), dev)
        base = to_i32(lb.ints_to_limbs([rng.randrange(n)], L)[None], dev)
        wins = to_i32(nprng.integers(0, 16, (1, B, NW)), dev)
        want = cm.modexp(base, wins, nt, n0, r2, one)
        runs, rec = {}, {"measure": "lanes", "limbs": L, "words": cm.words_for(L), "windows": NW,
                         "rows": B}
        for tpi in (32, 16, 8):
            out = torch.empty((1, B, L), dtype=torch.int32, device=dev)
            table = torch.empty((lib.forms_table_words(tpi, 1, B, L),), dtype=torch.int32,
                                device=dev)
            runs[tpi] = (lambda tpi=tpi, out=out, table=table: lib.forms_modexp_launch(
                tpi, base.data_ptr(), 0, 0, wins.data_ptr(), wins.stride(0), wins.stride(1),
                nt.data_ptr(), r2.data_ptr(), one.data_ptr(), out.data_ptr(), table.data_ptr(),
                1, B, L, NW, stream()))
            if runs[tpi]() != 0:
                raise RuntimeError(f"lanes {tpi}: launch failed")
            torch.cuda.synchronize()
            rec[f"equal_{tpi}"] = bool(torch.equal(out, want))
        t = {tpi: [] for tpi in runs}
        for tpi in (32, 16, 8, 8, 16, 32):
            t[tpi].append(ms(runs[tpi]))
        rec.update({f"ms_{tpi}": sum(v) / 2 for tpi, v in t.items()})
        print(json.dumps(rec), flush=True)

    for tpi, w in PAIRS:
        L32 = 129 if tpi * w < 257 else 257
        n = rng.getrandbits(32 * L32 - 3) | (1 << (32 * L32 - 4)) | 1
        n0inv = (-pow(n, -1, 1 << 32)) % (1 << 32)
        words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(tpi * w)]  # noqa: E731,B023
        xs = np.array([words(rng.randrange(n)) for _ in range(B)], dtype=np.uint32)
        x = torch.from_numpy(xs.view(np.int32)).to(dev)
        nw = torch.from_numpy(np.array(words(n), dtype=np.uint32).view(np.int32)).to(dev)
        rec, outs = {"measure": "product", "lanes": tpi, "words_a_lane": w, "words": L32,
                     "rows": B, "products": P}, []
        for form, name in enumerate(FORMS):
            out = torch.empty_like(x)
            run = (lambda form=form, out=out: lib.forms_chain_launch(
                tpi, w, form, x.data_ptr(), nw.data_ptr(), n0inv, out.data_ptr(), B, L32, P,
                stream()))
            if run() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            rec[f"us_per_product_{name}"] = ms(run) / P * 1e3
            outs.append(out.clone())
        rec["forms_equal"] = all(torch.equal(outs[0], o) for o in outs[1:])
        r_inv = pow(1 << (32 * L32), -1, n)
        v = sum(int(xs[0][i]) << (32 * i) for i in range(tpi * w))
        for _ in range(P):
            v = v * v * r_inv % n
        got = sum((int(u) & 0xFFFFFFFF) << (32 * i) for i, u in enumerate(outs[0][0].tolist()))
        rec["row0_ok"] = got % n == v and got < 2 * n
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
