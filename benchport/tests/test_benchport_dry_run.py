"""Tiny runs of the whole harness on the CPU (the program's plain versions,
a 256-bit key): cells added from new files alone, the result line, the
traced run, the control and the faults the cells can have, each of which
must come out not correct."""

from __future__ import annotations

import pytest

from kit import copy_with_cells, run_cpu, small_config, small_traffic

pytest.importorskip("torch")

DJN = small_config("tdjn256", djn=True)
NORMAL = small_config("tnormal256", djn=False)
PLAIN = small_config("tplain256", djn=False, backend="plain")
CELLS = [
    (DJN, "tenc16", small_traffic("encrypt")),
    (NORMAL, "tenc16", small_traffic("encrypt")),
    (DJN, "tdec16", small_traffic("decrypt")),
    (PLAIN, "tdec16", small_traffic("decrypt")),
]
TRACE_KEYS = ("api.submit_ms", "api.fetch_ms", "engine.key_setup_s")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_cells(tmp_path_factory.mktemp("bench"), CELLS)


def _cell(config, traffic):
    return f"{config['name']}.{traffic}"


@pytest.mark.parametrize("cell", [_cell(c, t) for c, t, _ in CELLS])
def test_new_cell_runs_and_is_correct(root, cell):
    res, out, err = run_cpu(root, cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"values_per_s", "batch_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert "setup import_torch=" in out and " import_program=" in out
    assert err.strip().splitlines()[-1].startswith("check compared_short")


def test_traced_run(root):
    res, _, _ = run_cpu(root, _cell(DJN, "tenc16"), traced=True, seconds=0.5)
    assert res["correct"] is True
    # the device metrics find nothing to read on the CPU and are left out
    assert set(res["metrics"]) == set(TRACE_KEYS)
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("cell", [_cell(DJN, "tenc16"), _cell(NORMAL, "tenc16"),
                                  _cell(DJN, "tdec16")])
def test_control_is_not_correct(root, cell):
    res, _, _ = run_cpu(root, cell, control=True)
    assert res["correct"] is False
    assert res["checks"]["mismatched_answers"]["value"] >= 4


class _Broken:
    def __init__(self, answers):
        self.answers = answers

    def fetch(self):
        return self.answers


def _faults(opcls, fault):
    inputs = {"encrypt": "plaintexts", "decrypt": "ciphertexts"}[opcls.__module__.split(".")[-1]]
    submit = opcls.submit

    def broken_submit(self, i):
        if fault == "unchanged":  # the step returns its input as it came
            return _Broken(list(getattr(self, inputs)(i)))
        good = submit(self, i).fetch()
        if fault == "half":  # half the batch left out
            return _Broken(good[: len(good) // 2])
        if fault == "half_filled":  # half computed, the rest copied over
            h = len(good) // 2
            return _Broken(good[:h] + good[:h] + good[2 * h:])
        if fault == "altered":  # every answer altered where it is produced
            return _Broken([a ^ 1 for a in good])
        raise ValueError(fault)

    return broken_submit


@pytest.mark.parametrize("fault", ["unchanged", "half", "half_filled", "altered"])
@pytest.mark.parametrize("cell", [_cell(DJN, "tenc16"), _cell(DJN, "tdec16")])
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from benchport.ops import decrypt, encrypt

    opcls = (encrypt if "enc" in cell else decrypt).Op
    monkeypatch.setattr(opcls, "submit", _faults(opcls, fault))
    monkeypatch.setattr(opcls, "fetch", staticmethod(lambda h: h.fetch()))
    res, _, _ = run_cpu(root, cell, seconds=1.0)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["mismatched_answers"]["value"] + checks["missing_answers"]["value"] > 0
