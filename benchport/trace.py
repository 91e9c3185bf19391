"""Reading a torch.profiler trace of the traced window.

The window is the span of the annotation ``benchport.window``; the batches
inside it are whole (submitted and fetched inside it, the device drained
before it closes).  Device work is every kernel, copy and set of memory;
what the host was doing in an idle stretch is read from the harness's
annotations (``benchport.submit`` / ``benchport.fetch``) and the outermost
PyTorch operator running at the stretch's middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "benchport.window"
PHASES = ("benchport.submit", "benchport.fetch")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: (name, seconds) of every kernel launched in the window
    kernels: list = field(default_factory=list)
    #: whole batches and their rows inside the window
    batches: int = 0
    rows: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, needle: str) -> float:
        """Total seconds of the kernels whose name holds ``needle``."""
        return sum(d for name, d in self.kernels if needle in name)


def short_name(name: str) -> str:
    """A device op's name without its argument list, at most 100 characters:
    the template arguments stay, since they tell a kernel's forms apart."""
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:k]
            break
    return name.strip()[:100]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """The outermost of nested host spans, for the question: which one
    covers time t?"""

    def __init__(self, spans):
        self.spans = []
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            if not self.spans or a >= self.spans[-1][1]:
                self.spans.append((a, b, name))
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and self.spans[k][1] >= t:
            return self.spans[k][2]
        return None


def read(path: str, batches: int, rows: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and "dur" in e
           and w0 <= e["ts"] <= w1]
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    busy_us = sum(b - a for a, b in busy)

    by_name = defaultdict(float)
    for e in dev:
        by_name[short_name(e["name"])] += e["dur"] * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    tid = win[0].get("tid")
    phases = _Spans((e["ts"], e["ts"] + e["dur"], e["name"].split(".")[-1])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") in PHASES)
    ops = _Spans((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and e.get("tid") == tid)
    gaps = defaultdict(float)
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = 0.5 * (edge + a)
            label = phases.at(mid) or "harness"
            op = ops.at(mid)
            gaps[f"{label}:{op}" if op else label] += (a - edge) * 1e-6
        edge = max(edge, b)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        kernels=[(e["name"], e["dur"] * 1e-6) for e in dev if e.get("cat") == "kernel"],
        batches=batches,
        rows=rows,
        device_ops=[[k, v] for k, v in device_ops],
        idle_gaps=[[k, v] for k, v in idle_gaps],
    )
