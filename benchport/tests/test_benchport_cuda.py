"""A short run of every cell on the card, through the benchmark's command.

    python -m pytest benchport/tests/test_benchport_cuda.py -q -o addopts="" -m cuda

Skips without a CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from kit import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cmd = [sys.executable, *BENCH["command"][1:], "--workload", cell, "--seed", "4000000017",
           "--seconds", "3", "--trace", str(trace)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0
        assert all(m["value"] <= 105 for k, m in res["metrics"].items() if k.endswith("_roofline"))
