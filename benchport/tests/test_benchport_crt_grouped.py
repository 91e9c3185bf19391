"""The readers of the grouped CRT decrypt (cell ``djn4096.decrypt_b8192``):
``kernels.k5_grouped_roofline`` on a synthetic device trace and
``pipelines.crt_grouped_share`` on a synthetic recorder drain, each also
where it finds nothing to read."""

from __future__ import annotations

from collections import namedtuple

import pytest

from kit import REPO

from benchport import harness, roofline
from benchport.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"
CONFIG = {"key_bits": 4096}
#: a span as the recorder keeps it (utils/trace.Span)
Span = namedtuple("Span", "id parent call name start_ns end_ns attrs")
K5_GROUPED = "void rns_modexp2_tc_kernel<0, 1, 1, 1, 1>(int const*, int const*, int*)"
K3 = "void rns_modexp2f_tc_kernel<true>(int const*, int const*, int*)"
OTHER = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"


def _read(name, readings):
    return harness.reader(REPO / "benchport", name)(readings)


def _trace(kernels, batches=8, rows=8 * 8192):
    return Trace(window_s=1.0, busy_s=0.9, kernels=kernels, batches=batches, rows=rows)


def _roofline(trace, kind=H100):
    return _read("kernels.k5_grouped_roofline",
                 harness.Readings(CONFIG, {}, kind, trace=trace))


def test_roofline_reads_the_grouped_k5_alone():
    """The CRT decrypt's least time over K5's seconds by name: K3 and the
    other kernels are not counted."""
    t = _trace([(K5_GROUPED, 0.40), (K5_GROUPED, 0.45), (K3, 5.0), (OTHER, 0.02)])
    want = 100.0 * roofline.k3_least_s(4096, 2048, 8 * 8192, roofline.PEAKS[H100]) / 0.85
    assert _roofline(t) == pytest.approx(want)
    assert 0 < _roofline(t) < 100


def test_roofline_does_not_match_k3():
    assert "rns_modexp2_tc_kernel" not in K3
    assert _roofline(_trace([(K3, 1.0), (OTHER, 0.1)])) is None


@pytest.mark.parametrize("case", ["no trace", "no peak", "no kernel"])
def test_roofline_finds_nothing_to_read(case):
    t = {"no trace": None, "no peak": _trace([(K5_GROUPED, 1.0)]),
         "no kernel": _trace([])}[case]
    assert _roofline(t, "cpu" if case == "no peak" else H100) is None


def _drain(calls, grouped):
    """A recorder's drain of ``calls`` decrypts, each an api.submit with a
    nested api.submit of the same call id, and ``grouped`` counted (None:
    a program without the counter)."""
    rec = []
    for c in range(1, calls + 1):
        t = c * 100_000_000
        rec += [Span(2 * c, 0, c, "api.submit", t, t + 10_000_000, None),
                Span(2 * c + 1, 2 * c, c, "api.submit", t, t + 1_000_000, None)]
    counters = {"pipelines.graph_replays": calls}
    if grouped is not None:
        counters["pipelines.crt_grouped"] = grouped
    return {"spans": rec, "counters": counters, "dropped": 0}


def _share(program):
    return _read("pipelines.crt_grouped_share",
                 harness.Readings(CONFIG, {}, H100, program=program))


@pytest.mark.parametrize("grouped,want", [(8, 1.0), (4, 0.5), (0, 0.0)])
def test_share_counts_grouped_calls(grouped, want):
    assert _share(_drain(8, grouped)) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no program", "no counter", "no calls"])
def test_share_finds_nothing_to_read(case):
    program = {"no program": None, "no counter": _drain(8, None),
               "no calls": _drain(0, 3)}[case]
    assert _share(program) is None
