"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, call or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the key (fixed primes), mode and backend;
* ``traffic/<traffic>.json``: op, batch, batches in flight, plaintext bits,
  pool of distinct batches, answers kept a batch and answers compared;
* ``ops/<op>.py``: how the op drives the program and its reference;
* ``metrics/<metric>.py``: a reader ``read(readings)`` that returns the
  metric's value, or None where it finds nothing to read.

With ``--trace 1`` two windows of whole batches follow the measured one:
one under torch.profiler (:func:`traced_window`), read into
``Readings.trace``, and then a longer one with the program's recorder on and
no profiler (``spans.recorded_window``), read into ``Readings.program``.
Set-up, the measured window and the traced one never turn the recorder on.

The loop is closed: ``inflight`` batches are outstanding, each on a CUDA
stream of its own.  Batch i + 1 is submitted on its stream before batch i
is fetched under batch i's stream, so the host enqueues and decodes one
batch while the device computes the other.  The window opens with the
device idle and every shape warmed on every stream, and closes at the first
batch whose answers arrive ``seconds`` or more after it opened; the batch
still in flight then is drained and not counted.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context
from pathlib import Path

from . import generator, keys
from . import trace as trace_mod

ROOT = Path(__file__).resolve().parent
#: Top-level modules that must not be loaded: JAX and the JAX package
#: (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pailliercryptolib_tpu")
#: Whole batches in the traced window, as a multiple of the batches in flight
TRACE_ROUNDS = 4
#: Whole batches in the recorded window (the program's spans and counters),
#: as a multiple of the batches in flight: 64, some 7 s on the card, since
#: 8 batches read a batch's codec time only to about 25%
RECORD_ROUNDS = 32
#: Fewest answers a run compares: a window that answers fewer is not correct
MIN_COMPARED = 16


class RunError(Exception):
    """A run that cannot give a result (exit code 2, nothing printed on
    standard output)."""


@dataclass
class Readings:
    """What the metric readers read."""

    config: dict
    traffic: dict
    device_kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    values: int = 0
    latencies_s: list = field(default_factory=list)
    #: seconds of the harness's spans around the program's calls, by name
    spans: dict = field(default_factory=dict)
    #: the traced window's device trace (``trace.Trace``)
    trace: object = None
    #: the recorded window's program (``spans.recorded_window``): the
    #: recorder's ``spans``, ``counters`` and ``dropped``, and ``split_ms``
    program: dict = None


def load_benchmark(root: Path) -> dict:
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"no BENCHMARK.json beside {root.name}/")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str):
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise RunError(f"no workload named {name!r} in BENCHMARK.json")
    return cells[0]


def cell_files(root: Path, bench: dict, cell: dict):
    """The cell's configuration and traffic, each found by its name."""
    cfg = [c for c in bench["configs"] if c["name"] == cell["config"]][0]
    config = json.loads((root.parent / cfg["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    return config, traffic


def cell_metrics(bench: dict, cell: dict, traced: bool):
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}

    def applies(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if applies(m)]


def reader(root: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchport_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def op_module(op: str):
    if not op.isidentifier():
        raise RunError(f"op {op!r} is not a module name")
    return importlib.import_module(f"{__package__}.ops.{op}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _stream_ctx(torch, stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(torch, op, streams, first: int, count=None, seconds=None,
                spans=None, on_answers=None, annotate=False):
    """Batches first, first + 1, ... with ``len(streams)`` in flight.  Stops
    after ``count`` batches, or at the first answers that arrive
    ``seconds`` or more after the start.  Returns (batches answered, the
    seconds from start to the last of them, latencies); a batch still in
    flight after a stop by time is fetched and not counted."""
    inflight = len(streams)
    rf = torch.profiler.record_function if annotate else (lambda _: contextlib.nullcontext())
    pending = deque()
    lat = []
    i = first
    t0 = time.perf_counter()
    close = None if seconds is None else t0 + seconds
    while True:
        while len(pending) < inflight and (count is None or i < first + count):
            s = streams[i % inflight]
            ts = time.perf_counter()
            with _stream_ctx(torch, s), rf("benchport.submit"):
                h = op.submit(i)
            if spans is not None:
                spans["submit"].append(time.perf_counter() - ts)
            pending.append((i, ts, s, h))
            i += 1
        if not pending:
            break
        j, ts, s, h = pending.popleft()
        tf = time.perf_counter()
        with _stream_ctx(torch, s), rf("benchport.fetch"):
            answers = op.fetch(h)
        t = time.perf_counter()
        if spans is not None:
            spans["fetch"].append(t - tf)
        lat.append(t - ts)
        if on_answers is not None:
            on_answers(j, answers)
        if close is not None and t >= close:
            break
    for _, _, s, h in pending:  # drained, not counted
        with _stream_ctx(torch, s):
            op.fetch(h)
    return len(lat), t - t0, lat


def check(op, kept: dict, sample, control: bool, workers: int):
    """Compare the kept answers of ``sample`` with the reference's (with
    its control in the program's place when ``control``).  Returns
    (mismatched, compared)."""
    fn = op.reference(False)
    jobs = [op.job(i, row) for i, row in sample]
    got = [kept[(i, row)] for i, row in sample]
    if control:
        got = _map(op.reference(True), jobs, workers)
    want = _map(fn, jobs, workers)
    return sum(g != w for g, w in zip(got, want)), len(sample)


def _map(fn, jobs, workers):
    if workers <= 1 or len(jobs) < 2:
        return [fn(*a) for a in jobs]
    with ProcessPoolExecutor(max_workers=workers, mp_context=get_context("spawn")) as ex:
        return list(ex.map(fn, *zip(*jobs)))


def default_workers():
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return max(1, min(6, cores - 1))


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        control: bool = False, device: str = "cuda", workers=None, root: Path = ROOT,
        out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line on ``out`` and returns 0, or raises
    RunError.  ``device="cpu"`` (tests only) skips the look for a chip and
    runs the program's plain versions."""
    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    config, traffic = cell_files(root, bench, cell)
    metrics = cell_metrics(bench, cell, traced)
    readers = {m["name"]: reader(root, m["name"]) for m in metrics}
    opmod = op_module(traffic["op"])
    workers = default_workers() if workers is None else workers

    setup = {}
    import torch

    setup["import_torch"] = time.perf_counter() - t0
    t = time.perf_counter()
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                           f"{cell['chips']}")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    setup["device_init"] = time.perf_counter() - t
    t = time.perf_counter()
    import pailliercryptolib_tpu_torch
    from pailliercryptolib_tpu_torch.utils import native

    here = Path(pailliercryptolib_tpu_torch.__file__).resolve().parent.parent
    if here != ROOT.parent:
        raise RunError(f"the program was imported from {here}, not from this checkout")

    setup["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        from pailliercryptolib_tpu_torch.ops import _build

        _build.load()
    native.available()
    setup["library_load"] = time.perf_counter() - t

    t = time.perf_counter()
    key = keys.key_of(config, seed)
    op = opmod.Op(key, config, traffic, seed, dev)
    op.make_inputs()
    setup["inputs"] = time.perf_counter() - t

    spans = {"submit": [], "fetch": []}
    t = time.perf_counter()
    op.key_setup()
    # the first batch on the default stream builds what the engine makes
    # lazily at its first call, before two streams share it
    op.fetch(op.submit(generator.WARM_BASE))
    _sync(torch, dev)
    spans["key_setup"] = [time.perf_counter() - t]
    setup["engine_constants"] = spans["key_setup"][0]

    inflight = int(traffic["inflight"])
    streams = ([torch.cuda.Stream(device=dev) for _ in range(inflight)]
               if dev.type == "cuda" else [None] * inflight)
    for k, s in enumerate(streams):
        t = time.perf_counter()
        with _stream_ctx(torch, s):
            op.fetch(op.submit(generator.WARM_BASE + 1 + k))
        _sync(torch, dev)
        setup[f"warm_stream{k}"] = time.perf_counter() - t
    t = time.perf_counter()
    closed_loop(torch, op, streams, generator.WARM_BASE + 1 + inflight, count=2 * inflight)
    _sync(torch, dev)
    setup["warm_loop"] = time.perf_counter() - t

    B = int(traffic["batch"])
    per_batch = int(traffic.get("kept_per_batch", 1))
    kept = {}
    tally = {"answered": 0, "missing": 0}

    def keep(i, answers):
        tally["answered"] += min(len(answers), B)
        tally["missing"] += abs(B - len(answers))
        for row in generator.kept_rows(seed, i, B, per_batch):
            if row < len(answers):
                kept[(i, row)] = answers[row]

    readings = Readings(config, traffic, torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu", spans=spans)
    readings.setup_s = time.perf_counter() - t0
    print("setup " + " ".join(f"{k}={v:.6f}" for k, v in setup.items())
          + f" total={readings.setup_s:.6f}", file=out, flush=True)

    nb, readings.window_s, readings.latencies_s = closed_loop(
        torch, op, streams, 0, seconds=seconds, spans=spans, on_answers=keep)
    _sync(torch, dev)
    readings.values = tally["answered"]
    print(f"window batches={nb} seconds={readings.window_s:.6f} values={readings.values}",
          file=out, flush=True)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    if traced:
        from . import spans as spans_mod

        readings.trace = traced_window(torch, op, streams, dev, B)
        readings.program = spans_mod.recorded_window(torch, op, streams, dev)

    op.release()
    del streams
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sample = generator.check_sample(seed, kept, int(traffic["check_rows"]))
    t = time.perf_counter()
    mismatched, compared = check(op, kept, sample, control, workers)
    print(f"check compared={compared} seconds={time.perf_counter() - t:.3f}"
          + (" control" if control else ""), file=out, flush=True)
    checks = {"mismatched_answers": {"value": mismatched, "limit": 0},
              "missing_answers": {"value": tally["missing"], "limit": 0},
              "compared_short": {"value": max(0, MIN_COMPARED - compared), "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    units = {m["name"]: m["unit"] for m in metrics}
    values = {}
    for name, read in readers.items():
        v = read(readings)
        if v is not None:
            values[name] = {"value": v, "unit": units[name]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": readings.device_kind, "count": cell["chips"],
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": nb * B, "failed": tally["missing"],
              "metrics": values, "device": device_rec}
    if readings.trace is not None:
        device_rec["busy_s"] = readings.trace.busy_s
        device_rec["window_s"] = readings.trace.window_s
        result["breakdown"] = {"device_ops": readings.trace.device_ops,
                               "idle_gaps": readings.trace.idle_gaps}
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that the benchmark must not load: {found}")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


def traced_window(torch, op, streams, dev, B):
    """``TRACE_ROUNDS * inflight`` whole batches under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    count = TRACE_ROUNDS * len(streams)
    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            closed_loop(torch, op, streams, 1 << 41, count=count, annotate=True)
            _sync(torch, dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.read(path, count, count * B)
    finally:
        os.unlink(path)
