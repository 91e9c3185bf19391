"""Where the host time of a benchmark cell goes, by the port's own spans, and
what recording them costs.

    python3 tools/trace_split.py --workload normal2048.encrypt_b4096 \\
        --seed 4000000017 --seconds 51 --turns 1 --out chiprun_out/trace_split.jsonl

For one cell of BENCHMARK.json, on the card, in one process:

1. set-up as the benchmark's (benchport/harness.py), with the engines' first
   use and a first batch under ``utils.trace.recording()``: the seconds of
   set-up's outermost ``engine.*`` / ``keys.*`` spans (``host_constants_s``)
   and every set-up span;
2. closed-loop windows of ``--seconds`` with the recorder off and on in turns
   (off, on, on, off, ``--turns`` times): ``values_per_s`` of each, the
   ratio of the on windows' median to the off windows', the spans a batch and
   the host-clock split of the on windows;
3. the benchmark's traced window with the recorder on
   (``benchport/spans.traced_window``): the benchmark's per-layer readers on
   its trace, and the program's spans in it (``benchport/spans.read``:
   launch calls inside ``api.submit``, the device idle while the host is in
   the codec, idle gaps named by span) with the recorder's split of the
   window.

In the on windows and the traced window it also counts the calls on the
engines' graph paths (ops/graphs.py) by the way they went (eager, captured,
replayed) with the share replayed, and reads ``pipelines.graph_replay``: the
host time a batch of copying a call's inputs in, replaying its graph and
cloning the output.

Prints one JSON line and appends it to ``--out``.  ``--device cpu`` runs on
the CPU with the kernels' plain versions, for a rehearsal on a small cell
(``--root``: a benchport/ directory with a BENCHMARK.json beside it).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {"kind": "cpu"}
    import torch

    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        limit = f"nvidia-smi: {e}"
    return {"kind": torch.cuda.get_device_name(dev), "nvidia_smi": limit}


#: The recorder's counters of the calls on the graph paths, by way
GRAPH_WAYS = ("pipelines.graph_replays", "pipelines.graph_captures", "pipelines.graph_eager")


def graph_calls(counters: dict) -> dict:
    """The calls on the graph paths by way, and the share of them replayed
    (None where there were none)."""
    ways = {k: counters.get(k, 0) for k in GRAPH_WAYS}
    total = sum(ways.values())
    ways["pipelines.graph_replay_share"] = ways["pipelines.graph_replays"] / total if total else None
    return ways


def _built(counters: dict) -> dict:
    """The counters of what was built (the wrappers' launch counts left out)."""
    return {k: v for k, v in counters.items()
            if not k.startswith("kernels.") or k in ("kernels.builds", "kernels.packs_built")}


def run(workload: str, seed: int, seconds: float, turns: int, device: str = "cuda",
        root: Path = REPO / "benchport") -> dict:
    t_start = time.perf_counter()
    import torch

    from benchport import generator, harness, keys
    from benchport import spans as spans_mod

    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, workload)
    config, traffic = harness.cell_files(root, bench, cell)
    opmod = harness.op_module(traffic["op"])
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        torch.zeros(1, device=dev)
        from pailliercryptolib_tpu_torch.ops import _build

        _build.load()
    from pailliercryptolib_tpu_torch.utils import trace as recorder

    key = keys.key_of(config, seed)
    op = opmod.Op(key, config, traffic, seed, dev)
    op.make_inputs()
    B, inflight = int(traffic["batch"]), int(traffic["inflight"])

    recorder.drain()
    t = time.perf_counter()
    with recorder.recording():
        op.key_setup()
        op.fetch(op.submit(generator.WARM_BASE))
        harness._sync(torch, dev)
    key_setup_s = time.perf_counter() - t
    setup = recorder.drain()

    streams = ([torch.cuda.Stream(device=dev) for _ in range(inflight)]
               if dev.type == "cuda" else [None] * inflight)
    for k, s in enumerate(streams):
        with harness._stream_ctx(torch, s):
            op.fetch(op.submit(generator.WARM_BASE + 1 + k))
        harness._sync(torch, dev)
    harness.closed_loop(torch, op, streams, generator.WARM_BASE + 1 + inflight,
                        count=2 * inflight)
    harness._sync(torch, dev)

    windows, on_spans, on_batches, on_counters = [], [], 0, {}
    first = 0
    last_off = None
    for on in [False, True, True, False] * turns:
        hspans = {"submit": [], "fetch": []}
        recorder.drain()
        gc0 = [g["collections"] for g in gc.get_stats()]
        if on:
            with recorder.recording():
                nb, secs, _ = harness.closed_loop(torch, op, streams, first,
                                                  seconds=seconds, spans=hspans)
                harness._sync(torch, dev)
            rec = recorder.drain()
            on_spans += rec["spans"]
            on_batches += nb
            for k in GRAPH_WAYS:
                on_counters[k] = on_counters.get(k, 0) + rec["counters"].get(k, 0)
            dropped = rec["dropped"]
        else:
            nb, secs, _ = harness.closed_loop(torch, op, streams, first, seconds=seconds,
                                              spans=hspans)
            harness._sync(torch, dev)
            dropped = 0
            last_off = hspans
        first += nb + inflight
        windows.append({"recording": on, "batches": nb, "seconds": secs,
                        "values_per_s": nb * B / secs,
                        "submit_ms": 1e3 * statistics.fmean(hspans["submit"]),
                        "fetch_ms": 1e3 * statistics.fmean(hspans["fetch"]),
                        "spans_dropped": dropped,
                        "gc_collections": [g["collections"] - c for g, c in
                                           zip(gc.get_stats(), gc0)]})

    tr, sp, program = spans_mod.traced_window(torch, op, streams, dev, B)
    readings = harness.Readings(config, traffic, _card(dev)["kind"], spans=last_off, trace=tr)
    per_layer = {}
    for m in harness.cell_metrics(bench, cell, True):
        v = harness.reader(root, m["name"])(readings)
        if v is not None:
            per_layer[m["name"]] = v
    split = spans_mod.split_ms(program["spans"], tr.batches)
    per_layer.update({
        "api.codec_in_ms": split.get("api.codec_in"),
        "api.codec_out_ms": split.get("api.codec_out"),
        "api.fetch_wait_ms": split.get("api.wait", 0.0),
        "pipelines.graph_replay_ms": split.get("pipelines.graph_replay"),
        "pipelines.launch_call_ms": sp["launch_call_ms"],
        "device.idle_codec_share": sp["idle_codec_share"],
        "engine.host_constants_s": spans_mod.host_constants_s(setup["spans"]),
    })
    for name in ("api.submit", "api.fetch"):
        if split.get(name):
            per_layer[f"{name}.child_share"] = 1 - split[f"{name}.self"] / split[name]
    op.release()

    off = [w["values_per_s"] for w in windows if not w["recording"]]
    on = [w["values_per_s"] for w in windows if w["recording"]]
    ratio = statistics.median(on) / statistics.median(off) if on and off else None
    return {
        "workload": workload, "seed": seed, "seconds": seconds, "device": _card(dev),
        "key_setup_s": key_setup_s,
        "setup_spans_ms": spans_mod.split_ms(setup["spans"], 1),
        "setup_counters": _built(setup["counters"]),
        "windows": windows,
        "on_over_off": ratio,
        "spans_per_batch": len(on_spans) / on_batches if on_batches else None,
        "split_ms_on_windows": spans_mod.split_ms(on_spans, on_batches),
        "graph_calls_on_windows": graph_calls(on_counters),
        "graph_calls_traced": graph_calls(program["counters"]),
        "per_layer": per_layer,
        "split_ms_traced": split,
        "window_counters": _built(program["counters"]),
        "traced": {"batches": tr.batches, "busy_s": tr.busy_s, "window_s": tr.window_s,
                   "idle_gaps_harness": tr.idle_gaps, "device_ops": tr.device_ops[:5],
                   **{k: sp[k] for k in ("idle_share", "idle_without_span_share",
                                         "idle_gaps", "runtime_ms", "waits_ms")}},
        "tool_seconds": time.perf_counter() - t_start,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=REPO / "benchport")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    res = run(args.workload, args.seed, args.seconds, args.turns, args.device, args.root)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
