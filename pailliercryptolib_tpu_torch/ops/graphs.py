"""CUDA graphs of the ``rns`` pipelines: the device part of a call is captured
once and replayed on the later calls with the same key.

An engine (models/engine.py) holds one :class:`GraphCache` and runs the device
part of three calls through :meth:`GraphCache.run`: the normal and the DJN
encrypt with a DeviceSeed (ChaCha20, the modexp kernel, the tail) and the CRT
decrypt (K3 and its tail).  ``run(op, fn, *inputs)`` returns ``fn(*inputs)``:

* on CPU tensors, eagerly, always;
* on CUDA tensors, eagerly the first time its key is seen.  The key is the op,
  the device, the current stream and the shape and dtype of every input
  (:func:`graph_key`).  What the pipeline makes lazily (constants, packs, the
  kernel library) is so made outside any capture;
* the second time, it captures ``fn`` into a ``torch.cuda.CUDAGraph`` over
  static copies of the inputs and replays it;
* every later time, it copies the inputs into the static ones on the current
  stream, replays the graph there and returns a clone of the graph's output,
  which the next replay overwrites.

The host so enqueues a call's thousands of kernels in one launch and never
waits for the device inside it.  ``fn`` must not synchronise with the host:
capture raises if it does.  A graph serves one stream, because its
intermediate tensors live in a device memory pool of its own that two streams
replaying it at once would share.  A cache keeps :data:`MAX_GRAPHS` graphs,
the least recently used going first.

The kernel wrappers count their launches when the host calls them
(``LAUNCHES`` and ``*_FORMS`` of ops/cuda_rns2.py and ops/cuda_modexp.py).  A
replay calls none, so it adds what its capture counted: a call counts what it
counts eagerly.  The recorder (utils/trace.py) counts each call's way as
``pipelines.graph_eager``, ``pipelines.graph_captures`` or
``pipelines.graph_replays``, and spans a replay as ``pipelines.graph_replay``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from ..utils import trace
from . import cuda_modexp, cuda_rns2

#: Graphs one cache keeps; each holds its pipeline's intermediate tensors in a
#: device memory pool of its own
MAX_GRAPHS = 8
#: Keys seen once and not yet captured that one cache remembers
MAX_SEEN = 4 * MAX_GRAPHS


def _counters():
    """The kernel wrappers' launch counters (dicts of name -> launches)."""
    return (cuda_rns2.LAUNCHES, cuda_rns2.KERNEL_FORMS, cuda_rns2.MODEXP2_FORMS,
            cuda_modexp.LAUNCHES, cuda_modexp.KERNEL_FORMS)


def graph_key(op: str, inputs, stream: int) -> tuple:
    """The key of a call of ``op`` on ``inputs`` (tensors on one device) from
    the stream whose handle is ``stream``."""
    return (op, inputs[0].device, stream,
            tuple((tuple(t.shape), t.dtype) for t in inputs))


class _Graph:
    """One captured pipeline: static inputs, the graph, its output and the
    launches its capture counted."""

    __slots__ = ("inputs", "graph", "output", "launches")

    def __init__(self, fn, inputs):
        dev = inputs[0].device
        self.inputs = [t.clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        before = [dict(d) for d in _counters()]
        with torch.cuda.device(dev):
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev),
                                  capture_error_mode="thread_local"):
                self.output = fn(*self.inputs)
        self.launches = [
            (d, k, v - was.get(k, 0))
            for d, was in zip(_counters(), before) for k, v in d.items()
            if v != was.get(k, 0)
        ]

    def replay(self, inputs=None) -> torch.Tensor:
        """The graph run on the current stream (over ``inputs``, copied in),
        as a tensor of its own."""
        if inputs is not None:
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
            for d, k, n in self.launches:
                d[k] += n
        self.graph.replay()
        return self.output.clone()


class GraphCache:
    """The graphs of one engine's pipelines, by :func:`graph_key`."""

    def __init__(self):
        self._graphs = OrderedDict()
        self._seen = OrderedDict()
        self._lock = threading.Lock()

    def run(self, op: str, fn, *inputs) -> torch.Tensor:
        """``fn(*inputs)``: eagerly on the CPU and at a key's first call,
        captured at its second, replayed after that."""
        if inputs[0].device.type != "cuda":
            trace.count("pipelines.graph_eager")
            return fn(*inputs)
        stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
        key = graph_key(op, inputs, stream)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                with trace.span("pipelines.graph_replay", op=op):
                    out = graph.replay(inputs)
                trace.count("pipelines.graph_replays")
                return out
            if key in self._seen:
                del self._seen[key]
                graph = _Graph(fn, inputs)
                self._graphs[key] = graph
                if len(self._graphs) > MAX_GRAPHS:
                    self._graphs.popitem(last=False)
                trace.count("pipelines.graph_captures")
                return graph.replay()
            self._seen[key] = None
            if len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
        trace.count("pipelines.graph_eager")
        return fn(*inputs)
