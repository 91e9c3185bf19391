"""Helpers of the benchmark's own tests: a copy of the benchmark with small
cells added from new files alone, run on the CPU."""

from __future__ import annotations

import io
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: Two 128-bit primes, both 3 mod 4, gcd(p - 1, q - 1) = 2: a 256-bit key
#: the program's plain versions run in a fraction of a second on the CPU
SMALL_P = "0xc334629e968c80b9534aad5888183613"
SMALL_Q = "0xfc75deae1c1d86c891fc7f590e851ffb"


def small_config(name: str, djn: bool, backend: str = "rns") -> dict:
    return {"name": name, "key_bits": 256, "p": SMALL_P, "q": SMALL_Q, "backend": backend,
            "djn": djn, "randbits": 128 if djn else 0}


def small_traffic(op: str, batch: int = 16, check_rows: int = 24) -> dict:
    t = {"op": op, "batch": batch, "inflight": 2, "pool_batches": 3, "kept_per_batch": 2,
         "check_rows": check_rows}
    if op == "encrypt":
        t["plain_bits"] = 64
    return t


def copy_with_cells(tmp: Path, cells) -> Path:
    """A copy of BENCHMARK.json and benchport/ under ``tmp`` with ``cells``
    added: (config dict, traffic name, traffic dict) each, written as new
    files beside the benchmark's own.  Returns the copy's benchport/."""
    root = tmp / "benchport"
    shutil.copytree(REPO / "benchport", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for config, tname, traffic in cells:
        cfile = root / "configs" / f"{config['name']}.json"
        if not cfile.exists():
            cfile.write_text(json.dumps(config))
            bench["configs"].append({"name": config["name"], "source": "https://example.org/test",
                                     "file": f"benchport/configs/{config['name']}.json",
                                     "reduced": [], "why": "test"})
        (root / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": f"{config['name']}.{tname}", "config": config["name"],
                                   "traffic": tname, "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 2.0,
            traced: bool = False, control: bool = False):
    """One run on the CPU; returns (result dict, standard output, standard
    error).  A run here answers far fewer batches than on the card, so it
    needs to compare fewer answers to count."""
    import torch

    from benchport import harness

    torch.set_num_threads(1)  # the test workers share the cores
    harness.MIN_COMPARED = 4

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, seconds, traced, time.perf_counter(), control=control,
                     device="cpu", workers=1, root=root, out=out, err=err)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), out.getvalue(), err.getvalue()
