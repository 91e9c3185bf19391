"""The roofline counts: least times at 2048 rows, and counts that depend on
the modulus width, the exponent bits and the rows only."""

from __future__ import annotations

import inspect

import pytest

from kit import REPO  # noqa: F401  (puts the repository on the path)

from benchport import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("fn,w,e,ms", [
    (roofline.k5_least_s, 4096, 2048, 2.222),
    (roofline.k3_least_s, 2048, 1024, 0.556),
    (roofline.k2_least_s, 4096, 1024, 0.139),
])
def test_least_times_at_2048_rows(fn, w, e, ms):
    assert fn(w, e, 2048, H100) * 1e3 == pytest.approx(ms, abs=0.0005)


@pytest.mark.parametrize("fn", [roofline.k5_least_s, roofline.k3_least_s, roofline.k2_least_s])
def test_counts_read_width_exponent_rows_only(fn):
    assert list(inspect.signature(fn).parameters) == ["w", "e", "rows", "peak"]
    base = fn(4096, 2048, 2048, H100)
    assert fn(4096, 2048, 4096, H100) == pytest.approx(2 * base)
    assert fn(4096, 4096, 2048, H100) == pytest.approx(2 * base)
    assert fn(8192, 2048, 2048, H100) == pytest.approx(4 * base)


def test_products_are_bound_by_operations():
    """At these widths the operations, not the bytes, bound every kernel."""
    for fn, w, e in ((roofline.k5_least_s, 4096, 2048), (roofline.k3_least_s, 2048, 1024),
                     (roofline.k2_least_s, 4096, 1024)):
        fast_memory = dict(H100, bytes_per_s=H100["bytes_per_s"] * 1e3)
        assert fn(w, e, 2048, fast_memory) == fn(w, e, 2048, H100)


def test_unknown_device_has_no_peak():
    assert roofline.peak_of("cpu") is None
