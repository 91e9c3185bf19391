"""Runtime configuration: one dataclass + environment overrides.

Own copy of the JAX package's ``utils/config.py`` without its compile-cache
switch (the port compiles its kernels itself, ops/_build.py).

Env overrides (checked once at first access):
  PAILLIER_TORCH_BACKEND  "rns" | "cios" | "plain": the backend of engines
                          that are given none (ops/dispatch.default_backend)
  PAILLIER_TORCH_PERF     "1" -> print per-batch host wall timings
"""

from __future__ import annotations

import dataclasses
import os
import time
from contextlib import contextmanager
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


@contextmanager
def perf_timer(label: str):
    """Wall-clock a batched operation and print when perf mode is on.
    Launches are asynchronous, so this is host time (codec + enqueue)
    unless the caller synchronises inside the block."""
    t0 = time.perf_counter()
    yield
    if get_config().perf:
        dt = (time.perf_counter() - t0) * 1000.0
        print(f"[paillier-torch perf] {label}: {dt:.2f} ms", flush=True)
