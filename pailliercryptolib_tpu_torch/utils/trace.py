"""The port's recorder: spans and counters at the boundaries where the host
time of a call goes.  Off unless asked for.

    from pailliercryptolib_tpu_torch.utils import trace

    with trace.recording():
        out = engine.encrypt_normal_dev(m, seed).fetch()
    rec = trace.drain()  # {"spans": [Span, ...], "counters": {...}, "dropped": 0}

Recording comes on inside :func:`recording`, or for the whole process under
``PAILLIER_TORCH_PERF=1`` (utils/config.py), which also prints each outermost
span as it closes, as host time.  Off, :func:`span` reads one module flag and
returns one shared no-op object: no clock read, no record, no torch call.

A :class:`Span` holds its name, start and end (``time.perf_counter_ns``), the
id of the span it was opened in (a stack a thread), a call id and its
attributes.  The outermost ``api.submit`` span of an engine call opens a call
id; the DevLimbs the call returns carries it (:meth:`_Span.carry`), so that
the spans of its ``fetch`` share it.  While recording under an active
``torch.profiler`` session, a span also opens
``torch.profiler.record_function(name)``: the profiler's chrome trace then
holds it as a ``user_annotation`` event, on the clock of the device's
kernels, copies and runtime calls.

Spans go to a buffer of :data:`CAPACITY`; spans past it are counted in
``dropped``.  Counters are integers; :func:`snapshot` adds the kernel
wrappers' own launch counts (``ops/cuda_rns2.py``, ``ops/cuda_modexp.py``) as
``kernels.launches.<wrapper>``, ``kernels.modexp2_forms.<form>`` and
``kernels.forms.<form>``.

Names follow the layers of the benchmark (``api.``, ``pipelines.``,
``kernels.``, ``engine.``, ``keys.``).
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

from .config import get_config

#: Spans kept until a :func:`drain`; later ones are dropped and counted
CAPACITY = 1 << 17
#: ``call=NEW``: open a call id, unless an enclosing span has one
NEW = -1


class Span(NamedTuple):
    id: int
    parent: int  # 0: opened in no other span
    call: int  # 0: no call
    name: str
    start_ns: int
    end_ns: int
    attrs: Optional[dict]


_on = False  # the one flag span() reads
_scopes = 0  # open recording() blocks
_export = False  # PAILLIER_TORCH_PERF=1
_lock = threading.Lock()
_spans: list = []
_dropped = 0
_counters: dict = {}
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()


class _Off:
    """The span returned while recording is off."""

    __slots__ = ()
    call = 0
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def carry(self, out):
        return out


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "call", "record", "id", "parent", "t0",
                 "seconds", "_rf")

    def __init__(self, name: str, call, attrs, record: bool):
        self.name, self.call, self.attrs, self.record = name, call, attrs, record
        self.seconds = 0.0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        if self.call is None or self.call == NEW:
            inherited = up.call if up is not None else 0
            self.call = inherited or (next(_calls) if self.call == NEW else 0)
        self.id = next(_ids)
        stack.append(self)
        self._rf = None
        if self.record and torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        self.seconds = (t1 - self.t0) * 1e-9
        if self.record:
            _keep(Span(self.id, self.parent, self.call, self.name, self.t0, t1,
                       self.attrs or None))
            if _export and not self.parent:
                _print(self.name, self.attrs, self.seconds)
        return None

    def carry(self, out):
        """``out`` (a DevLimbs) with this span's call id."""
        out.call = self.call
        return out


def span(name: str, call=None, **attrs):
    """A span around a ``with`` block.  ``call``: the call id its spans share
    (``NEW`` opens one; by default the enclosing span's)."""
    if not _on:
        return OFF
    return _Span(name, call, attrs, True)


def timed(name: str, **attrs):
    """A span that reads the clock even while recording is off, for one-off
    set-up whose seconds the program reports (``seconds`` once closed)."""
    return _Span(name, None, attrs, _on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _keep(rec: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAPACITY:
            _spans.append(rec)
        else:
            _dropped += 1


def _print(name: str, attrs: dict, seconds: float) -> None:
    parts = [f"B={attrs['rows']}"] if "rows" in attrs else []
    parts += [f"{k}={v}" for k, v in attrs.items() if k != "rows"]
    label = f"{name}[{' '.join(parts)}]" if parts else name
    print(f"[paillier-torch perf] host {label}: {seconds * 1e3:.2f} ms", flush=True)


def _refresh() -> None:
    global _on
    _on = _export or _scopes > 0


def set_export(on: bool) -> None:
    """Record for the whole process and print each outermost span (utils/config's
    ``perf``)."""
    global _export
    with _lock:
        _export = bool(on)
        _refresh()


@contextmanager
def recording():
    """Record the spans and counters of the block (nestable)."""
    global _scopes
    with _lock:
        _scopes += 1
        _refresh()
    try:
        yield
    finally:
        with _lock:
            _scopes -= 1
            _refresh()


def _kernel_counters() -> dict:
    from ..ops import cuda_modexp, cuda_rns2

    out = {}
    for mod in (cuda_rns2, cuda_modexp):
        out.update({f"kernels.launches.{k}": v for k, v in mod.LAUNCHES.items()})
    out.update({f"kernels.forms.{k}": v for k, v in cuda_rns2.KERNEL_FORMS.items()})
    out.update({f"kernels.modexp2_forms.{k}": v for k, v in cuda_rns2.MODEXP2_FORMS.items()})
    return out


def _take(clear: bool) -> dict:
    global _dropped
    with _lock:
        spans, counters, dropped = _spans[:], dict(_counters), _dropped
        if clear:
            _spans.clear()
            _counters.clear()
            _dropped = 0
    counters.update(_kernel_counters())
    return {"spans": spans, "counters": counters, "dropped": dropped}


def snapshot() -> dict:
    """The spans kept so far, the counters (the kernel wrappers' launch counts
    among them) and the count of spans dropped."""
    return _take(False)


def drain() -> dict:
    """:func:`snapshot`, then forget the spans, counters and drops (the kernel
    wrappers' counts stay where they are)."""
    return _take(True)


set_export(get_config().perf)
