"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

from __future__ import annotations

import json
import re

import pytest

from kit import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "benchport/run.py"]
    assert BENCH["paths"] == ["benchport"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells (2 + 14 runs a cell) at this length fits in 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25


def test_every_cell_reports_its_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", cells)]
        assert reported
        assert len([m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]) >= 2


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    from benchport import harness

    root = REPO / "benchport"
    w = harness.find_cell(BENCH, cell)
    config, traffic = harness.cell_files(root, BENCH, w)
    cfg = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert cfg["file"].startswith("benchport/configs/") and config["name"] == w["config"]
    assert harness.op_module(traffic["op"]).Op
    for traced in (False, True):
        for m in harness.cell_metrics(BENCH, w, traced):
            assert callable(harness.reader(root, m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_key_is_admitted(name):
    """A configuration without ``key_seed`` holds the ISO/IEC 18033-6 primes
    exactly; one with it holds what benchport/fixed_keys.py makes from it;
    each keeps IPCL's rules of key generation or lists the departure under
    ``assumed`` (fixed_keys.faults)."""
    from benchport import fixed_keys

    c = [c for c in BENCH["configs"] if c["name"] == name][0]
    config = json.loads((REPO / c["file"]).read_text())
    assert fixed_keys.faults(config) == []
