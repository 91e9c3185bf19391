"""The program's own spans in a traced window: the split of ``submit`` and
``fetch``, and what the device trace says of them.

The port records spans where its host time goes (its recorder,
``pailliercryptolib_tpu_torch/utils/trace.py``: ``api.*``, ``pipelines.*``,
``kernels.*``, ``engine.*``, ``keys.*``).  Two readings of them:

* the recorder's own spans (``trace.drain()["spans"]``: name, parent, start
  and end on the host clock): :func:`split_ms` gives each name's
  milliseconds a batch and the self time of ``api.submit`` / ``api.fetch``;
  :func:`host_constants_s` the seconds of set-up's outermost ``engine.*`` /
  ``keys.*`` spans;
* a torch.profiler chrome trace of a window run with the recorder on, where
  each span is a ``user_annotation`` event on the clock of the kernels,
  copies and CUDA runtime calls: :func:`read` gives the host time inside
  kernel launch calls a batch, the share of the window the device idles
  while the host is in the codec, the idle gaps named after the innermost
  program span at their middle, and the other runtime calls (waits, copies)
  by the span and operator they were made in.

The device's busy time is found as ``trace.read`` finds it.
:func:`traced_window` is the harness's traced window with the recorder on:
``tools/trace_split.py`` runs a cell with it.  The harness itself reads the
recorder in :func:`recorded_window`, a window after its traced one with the
recorder on and no profiler, so that the device trace it reads is the
program's as users run it (the recorder annotates only under a profiler).
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

from . import trace as trace_mod
from .harness import RECORD_ROUNDS, TRACE_ROUNDS, _sync, closed_loop
from .trace import _DEVICE_CATS, PHASES, WINDOW, _Spans, _union

#: Name prefixes of the program's spans (the layers of PERF.md)
PROGRAM = ("api.", "pipelines.", "kernels.", "engine.", "keys.")
#: CUDA runtime / driver calls that launch a kernel or a graph of kernels
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: The host codec, int <-> limbs
CODEC = ("api.codec_in", "api.codec_out")
#: Spans whose self time is reported: the time their children leave
PARENTS = ("api.submit", "api.fetch")


def _covered(a, b, intervals) -> float:
    """Length of [a, b] that the union of ``intervals`` covers."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y in _union(intervals))


def _ancestors(s, by):
    up = by.get(s.parent)
    while up is not None:
        yield up
        up = by.get(up.parent)


def split_ms(spans, batches: int) -> dict:
    """Milliseconds a batch of each span name (a span inside another of its
    name counted once, in the outer), and ``<name>.self`` for
    :data:`PARENTS`: the time no child span covers.  ``spans``: the
    recorder's (``.name``, ``.id``, ``.parent``, ``.start_ns``, ``.end_ns``)."""
    if not batches:
        return {}
    by = {s.id: s for s in spans}
    total = defaultdict(int)
    kids = defaultdict(list)
    for s in spans:
        if all(up.name != s.name for up in _ancestors(s, by)):
            total[s.name] += s.end_ns - s.start_ns
        if s.parent:
            kids[s.parent].append((s.start_ns, s.end_ns))
    for s in spans:
        if s.name in PARENTS:
            self_ns = s.end_ns - s.start_ns - _covered(s.start_ns, s.end_ns, kids[s.id])
            total[f"{s.name}.self"] += self_ns
    return {k: v * 1e-6 / batches for k, v in sorted(total.items())}


def host_constants_s(spans) -> float:
    """Seconds of the outermost ``engine.*`` and ``keys.*`` spans: the host
    work of the engines' constants and the private key's."""
    by = {s.id: s for s in spans}
    setup = ("engine.", "keys.")
    return sum((s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name.startswith(setup)
               and not any(up.name.startswith(setup) for up in _ancestors(s, by)))


def _innermost(spans, t):
    """The name of the latest-starting span of ``spans`` (start, end, name)
    that covers ``t``: on one thread spans nest, so that is the innermost."""
    best = None
    for a, b, name in spans:
        if a > t:
            break
        if b >= t and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else None


def read(path: str, batches: int) -> dict:
    """The readings of a chrome trace of a traced window (the harness's
    ``benchport.window`` annotation around ``batches`` whole batches), taken
    with the recorder on."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return read_events(events, batches)


def read_events(events, batches: int) -> dict:
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0].get("tid")
    inside = [e for e in events if "dur" in e and w0 <= e["ts"] <= w1]

    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in inside
                  if e.get("cat") in _DEVICE_CATS)
    idle, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)

    prog = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
                  if e.get("cat") == "user_annotation" and e.get("tid") == tid
                  and e["name"].startswith(PROGRAM))
    phases = _Spans((e["ts"], e["ts"] + e["dur"], e["name"].split(".")[-1]) for e in inside
                    if e.get("cat") == "user_annotation" and e["name"] in PHASES)
    ops = _Spans((e["ts"], e["ts"] + e["dur"], e["name"]) for e in inside
                 if e.get("cat") == "cpu_op" and e.get("tid") == tid)

    submits = [(a, b) for a, b, name in prog if name == "api.submit"]
    runtime = defaultdict(lambda: [0.0, 0])
    waits = defaultdict(lambda: [0.0, 0])
    launch_us = 0.0
    for e in inside:
        if e.get("cat") not in _RUNTIME_CATS:
            continue
        r = runtime[e["name"]]
        r[0] += e["dur"]
        r[1] += 1
        if e["name"].startswith(LAUNCH_CALLS):
            launch_us += _covered(e["ts"], e["ts"] + e["dur"], submits)
        else:  # a wait or a copy: where the host made it
            mid = e["ts"] + 0.5 * e["dur"]
            r = waits[f"{e['name']}@{_innermost(prog, mid)}:{ops.at(mid)}"]
            r[0] += e["dur"]
            r[1] += 1

    codec = [(a, b) for a, b, name in prog if name in CODEC]
    idle_codec_us = sum(_covered(a, b, codec) for a, b in idle)

    gaps = defaultdict(float)
    bare_us = 0.0
    for a, b in idle:
        mid = 0.5 * (a + b)
        phase = phases.at(mid) or "harness"
        span = _innermost(prog, mid)
        op = ops.at(mid)
        label = f"{phase}/{span}" if span else phase
        gaps[f"{label}:{op}" if op else label] += (b - a) * 1e-6
        if span is None and phase in ("submit", "fetch"):
            bare_us += b - a
    idle_us = sum(b - a for a, b in idle)
    window_us = w1 - w0
    return {
        "window_s": window_us * 1e-6,
        "idle_share": idle_us / window_us if window_us else None,
        "launch_call_ms": launch_us * 1e-3 / batches if batches else None,
        "idle_codec_share": idle_codec_us / window_us if window_us else None,
        "idle_without_span_share": bare_us / idle_us if idle_us else None,
        "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:16]],
        "runtime_ms": _per_batch(runtime, batches),
        "waits_ms": _per_batch(waits, batches),
    }


def _per_batch(calls, batches):
    """Runtime calls as {name: [ms a batch, calls a batch]}, the 12 longest."""
    top = sorted(calls.items(), key=lambda kv: -kv[1][0])[:12]
    return {k: [us * 1e-3 / batches, n / batches] for k, (us, n) in top}


def traced_window(torch, op, streams, dev, B):
    """The harness's traced window (``harness.traced_window``: ``TRACE_ROUNDS
    * inflight`` whole batches under torch.profiler) with the program's
    recorder on.  Returns the harness's reading of the trace
    (``trace.read``), this module's (:func:`read`) and the recorder's spans
    and counters of the window (``drain()``)."""
    from pailliercryptolib_tpu_torch.utils import trace as recorder
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    count = TRACE_ROUNDS * len(streams)
    recorder.drain()
    with recorder.recording(), profile(activities=acts) as prof:
        with record_function(WINDOW):
            closed_loop(torch, op, streams, 1 << 41, count=count, annotate=True)
            _sync(torch, dev)
    program = recorder.drain()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_mod.read(path, count, count * B), read(path, count), program
    finally:
        os.unlink(path)


def recorded_window(torch, op, streams, dev):
    """``RECORD_ROUNDS * inflight`` whole batches with the program's recorder
    on and no profiler.  Returns the recorder's ``drain()`` of them (its
    ``spans``, ``counters`` and ``dropped``) and ``split_ms``, their
    :func:`split_ms` a batch; the recorder is off again after it."""
    from pailliercryptolib_tpu_torch.utils import trace as recorder

    count = RECORD_ROUNDS * len(streams)
    recorder.drain()
    with recorder.recording():
        closed_loop(torch, op, streams, 1 << 42, count=count)
        _sync(torch, dev)
    program = recorder.drain()
    return dict(program, split_ms=split_ms(program["spans"], count))
