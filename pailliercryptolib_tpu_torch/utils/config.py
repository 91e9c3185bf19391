"""Runtime configuration: one dataclass + environment overrides.

Own copy of the JAX package's ``utils/config.py`` without its compile-cache
switch (the port compiles its kernels itself, ops/_build.py).

Env overrides (checked once at first access):
  PAILLIER_TORCH_BACKEND  "rns" | "cios" | "plain": the backend of engines
                          that are given none (ops/dispatch.default_backend)
  PAILLIER_TORCH_PERF     "1" -> the recorder (utils/trace.py) records for the
                          whole process and exports each outermost span as it
                          closes: ``[paillier-torch perf] host api.submit[B=4096
                          op=encrypt_normal]: <t> ms``.  These are host
                          times: a call returns once its launches are
                          enqueued, so ``api.submit`` is codec, upload and
                          enqueue, and ``api.fetch`` holds the wait for the
                          device (``api.wait``)

An operator who wants the split of a few calls, without the prints, wraps them
in ``utils.trace.recording()`` and reads ``utils.trace.snapshot()`` /
``drain()``: every span (name, start, end, parent, call id) and counter.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    backend: Optional[str] = None  # None -> ops/dispatch.default_backend
    perf: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            backend=os.environ.get("PAILLIER_TORCH_BACKEND"),
            perf=os.environ.get("PAILLIER_TORCH_PERF", "0") == "1",
        )


_CONFIG: Optional[Config] = None


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
    return _CONFIG


def set_config(cfg: Config) -> None:
    global _CONFIG
    _CONFIG = cfg
    from . import trace

    trace.set_export(cfg.perf)


def perf_timer(label: str):
    """The JAX package's name for a host-time span: ``utils.trace.span``."""
    from .trace import span

    return span(label)
