"""The program's spans in a traced window (benchport/spans.py): the readers
on a small synthetic chrome trace, a traced window on the CPU with the
recorder on, whose idle gaps are named by program spans, and an untraced run
of the harness, which never turns the recorder on."""

from __future__ import annotations

import re
from collections import namedtuple

import pytest

from kit import REPO, copy_with_cells, run_cpu, small_config, small_traffic

pytest.importorskip("torch")

NORMAL = small_config("snormal256", djn=False)
DJN = small_config("sdjn256", djn=True)
CELLS = [(NORMAL, "senc16", small_traffic("encrypt")), (DJN, "sdec16", small_traffic("decrypt"))]
#: a span as the recorder keeps it (utils/trace.Span)
Span = namedtuple("Span", "id parent call name start_ns end_ns attrs")


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "ph": "X"}


def _synthetic():
    """One batch in a window of 1000 us: submit [0, 600), fetch [600, 1000);
    the device busy on [140, 400) and [600, 640)."""
    return [
        _x("benchport.window", 0, 1000),
        _x("benchport.submit", 0, 600), _x("benchport.fetch", 600, 400),
        _x("api.submit", 10, 580), _x("api.codec_in", 20, 100), _x("kernels.k5", 130, 10),
        _x("pipelines.post", 150, 430),
        _x("api.fetch", 610, 300), _x("api.wait", 620, 10), _x("api.download", 630, 20),
        _x("api.codec_out", 650, 250),
        _x("aten::__and__", 60, 20, "cpu_op"),
        _x("cudaLaunchKernel", 135, 3, "cuda_runtime"),
        _x("cudaLaunchKernelExC", 200, 50, "cuda_runtime"),
        _x("cudaLaunchKernel", 615, 4, "cuda_runtime"),  # in fetch: not counted
        _x("cudaStreamSynchronize", 620, 10, "cuda_runtime"),
        _x("k5_kernel", 140, 260, "kernel", tid=7),
        _x("Memcpy DtoH", 600, 40, "gpu_memcpy", tid=8),
    ]


def test_readers_on_a_synthetic_trace():
    from benchport import spans

    r = spans.read_events(_synthetic(), batches=1)
    assert r["window_s"] == pytest.approx(1e-3)
    # idle: [0, 140), [400, 600), [640, 1000)
    assert r["idle_share"] == pytest.approx(0.7)
    assert r["launch_call_ms"] == pytest.approx(0.053)
    # codec_in covers 100 us of the first idle stretch, codec_out 250 of the last
    assert r["idle_codec_share"] == pytest.approx(0.35)
    gaps = dict(r["idle_gaps"])
    assert gaps["submit/api.codec_in:aten::__and__"] == pytest.approx(140e-6)
    assert gaps["submit/pipelines.post"] == pytest.approx(200e-6)
    assert gaps["fetch/api.codec_out"] == pytest.approx(360e-6)
    assert r["idle_without_span_share"] == 0.0
    assert r["runtime_ms"]["cudaLaunchKernel"] == [pytest.approx(0.007), 2.0]


def test_graph_launch_counts_as_a_launch():
    from benchport import spans

    events = _synthetic() + [_x("cudaGraphLaunch", 300, 100, "cuda_runtime")]
    r = spans.read_events(events, batches=1)
    assert r["launch_call_ms"] == pytest.approx(0.153)
    assert not any(k.startswith("cudaGraphLaunch@") for k in r["waits_ms"])


def test_trace_read_ignores_program_annotations(tmp_path):
    """The device trace's reading (busy time, kernels, device ops, idle gaps)
    is the same with the recorder's annotations in the trace and without."""
    import json

    from benchport import spans, trace

    def read(events, name):
        path = tmp_path / name
        path.write_text(json.dumps({"traceEvents": events}))
        return trace.read(str(path), 1, 16)

    with_program = _synthetic()
    without = [e for e in with_program if not e["name"].startswith(spans.PROGRAM)]
    assert len(without) < len(with_program)
    assert read(with_program, "a.json") == read(without, "b.json")
    assert read(without, "b.json").idle_gaps


def _drain():
    """A recorder's drain of a window of 2 batches: each call's api.submit
    (codec 3 ms in, a graph replay) and api.fetch (codec 5 ms out)."""
    rec, k = [], 0
    for call in (1, 2):
        t = call * 100_000_000
        rec += [
            Span(k + 1, 0, call, "api.submit", t, t + 10_000_000, None),
            Span(k + 2, k + 1, call, "api.codec_in", t, t + 3_000_000, None),
            Span(k + 3, k + 1, call, "pipelines.graph_replay", t + 4_000_000, t + 5_000_000, None),
            Span(k + 4, 0, call, "api.fetch", t + 20_000_000, t + 40_000_000, None),
            Span(k + 5, k + 4, call, "api.codec_out", t + 30_000_000, t + 35_000_000, None),
        ]
        k += 5
    return {"spans": rec, "counters": {"pipelines.graph_replays": 2}, "dropped": 0}


def _readings(program):
    from benchport import harness, spans

    if program is not None:
        program = dict(program, split_ms=spans.split_ms(program["spans"], 2))
    return harness.Readings({}, {}, "cpu", program=program)


def _read(name, readings):
    from benchport import harness

    return harness.reader(REPO / "benchport", name)(readings)


def test_program_readers_on_a_synthetic_drain():
    drain = _drain()
    assert _read("api.codec_ms", _readings(drain)) == pytest.approx(8.0)
    assert _read("pipelines.graph_replay_share", _readings(drain)) == pytest.approx(1.0)
    # one call run eagerly: one replay in two calls
    eager = dict(drain, counters={"pipelines.graph_replays": 1, "pipelines.graph_eager": 1})
    assert _read("pipelines.graph_replay_share", _readings(eager)) == pytest.approx(0.5)
    # a nested api.submit shares its call id: still two calls
    nested = dict(drain, spans=drain["spans"] + [
        Span(99, 2, 1, "api.submit", 100_000_000, 101_000_000, None)])
    assert _read("pipelines.graph_replay_share", _readings(nested)) == pytest.approx(1.0)
    no_codec = dict(drain, spans=[s for s in drain["spans"] if "codec" not in s.name])
    assert _read("api.codec_ms", _readings(no_codec)) == 0.0


@pytest.mark.parametrize("name", ["api.codec_ms", "pipelines.graph_replay_share"])
def test_program_readers_find_nothing_to_read(name):
    assert _read(name, _readings(None)) is None
    empty = {"spans": [], "counters": {}, "dropped": 0}
    assert _read(name, _readings(empty)) is None


def test_idle_without_a_program_span():
    from benchport import spans

    events = [e for e in _synthetic() if e["name"] not in ("api.fetch", "api.codec_out")]
    r = spans.read_events(events, batches=2)
    assert dict(r["idle_gaps"])["fetch"] == pytest.approx(360e-6)
    assert r["idle_without_span_share"] == pytest.approx(360 / 700)
    assert r["launch_call_ms"] == pytest.approx(0.053 / 2)
    assert r["idle_codec_share"] == pytest.approx(0.1)


def test_split_and_host_constants():
    from benchport import spans

    rec = [
        Span(1, 0, 1, "api.submit", 0, 100_000_000, None),
        Span(2, 1, 1, "api.codec_in", 0, 30_000_000, None),
        Span(3, 1, 1, "pipelines.post", 40_000_000, 90_000_000, None),
        Span(4, 0, 0, "engine.crt_consts", 0, 500_000_000, None),
        Span(5, 4, 0, "engine.crt_consts", 0, 200_000_000, None),  # nested: counted once
        Span(6, 5, 0, "engine.rns_context", 0, 100_000_000, None),
        Span(7, 0, 0, "keys.private_key", 0, 50_000_000, None),
    ]
    ms = spans.split_ms(rec, batches=2)
    assert ms["api.submit"] == pytest.approx(50.0)
    assert ms["api.submit.self"] == pytest.approx(10.0)
    assert ms["engine.crt_consts"] == pytest.approx(250.0)
    assert spans.host_constants_s(rec) == pytest.approx(0.55)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return copy_with_cells(tmp_path_factory.mktemp("bench"), CELLS)


@pytest.mark.parametrize("cell", ["snormal256.senc16", "sdjn256.sdec16"])
def test_traced_window_names_idle_gaps_by_span(root, cell):
    import torch

    from benchport import harness, keys, spans

    torch.set_num_threads(1)
    bench = harness.load_benchmark(root)
    config, traffic = harness.cell_files(root, bench, harness.find_cell(bench, cell))
    seed, dev = 2**31 + 5, torch.device("cpu")
    op = harness.op_module(traffic["op"]).Op(keys.key_of(config, seed), config, traffic, seed, dev)
    op.make_inputs()
    op.key_setup()
    streams = [None] * int(traffic["inflight"])
    tr, sp, program = spans.traced_window(torch, op, streams, dev, int(traffic["batch"]))
    assert tr.batches == harness.TRACE_ROUNDS * len(streams)
    # the harness's own labels are as they were; the program's name a span
    assert all("/" not in label for label, _ in tr.idle_gaps)
    assert any(re.match(r"^(submit|fetch)/(api|pipelines|kernels)\.", label)
               for label, _ in sp["idle_gaps"])
    assert sp["idle_share"] == pytest.approx(1 - tr.busy_s / tr.window_s)
    ms = spans.split_ms(program["spans"], tr.batches)
    assert {"api.submit", "api.fetch", "api.codec_in", "api.codec_out"} <= set(ms)
    calls = {s.call for s in program["spans"]}
    assert len(calls) == tr.batches and 0 not in calls


def test_untraced_run_never_turns_the_recorder_on(root, monkeypatch):
    from pailliercryptolib_tpu_torch.utils import trace as recorder

    opened = []
    real = recorder.recording

    def spy():
        opened.append(1)
        return real()

    monkeypatch.setattr(recorder, "recording", spy)
    recorder.drain()
    res, _, _ = run_cpu(root, "snormal256.senc16")
    assert res["correct"] is True, res["checks"]
    assert opened == []
    rec = recorder.drain()
    assert rec["spans"] == [] and rec["dropped"] == 0

