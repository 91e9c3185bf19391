"""ctypes bindings for the native host codec (``csrc/host_codec.cpp``).

Own copy of the JAX package's ``utils/native.py``.  The C++ source is
compiled with g++ at first use into ``build/`` at the repository root (the
kernel library's directory, ops/_build.py), never into the package: the
library's name carries a hash of the source and the flags, and g++ links it
in a temporary directory that is then renamed into place, so processes that
build at the same time (``pytest -n``) do not see each other's half-written
files and a stale library is never loaded.  Every consumer falls back to the
numpy codec of ops/limbs.py when g++ or the library is missing, as the
reference falls back to its CPU path (#ifdef IPCL_USE_QAT,
ipcl/mod_exp.cpp:13-16).  The results are the same either way: host code,
exact integers.

    g++ -O3 -shared -fPIC -o build/<tmp>/lib.so csrc/host_codec.cpp
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..ops._build import BUILD_DIR, CSRC

SRC = CSRC / "host_codec.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    """Where the library of the present source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libhost_codec-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless its library is already there; return its
    path.  Raises when g++ is missing or fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host codec is not built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / "lib.so"
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(out), str(SRC)],
            check=True, capture_output=True,
        )
        os.replace(out, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            i64 = ctypes.c_int64
            lib.pack_limbs.argtypes = [u8p, i64, i64, u32p, i64]
            lib.unpack_limbs.argtypes = [u32p, i64, i64, u8p, i64]
            lib.pack_windows.argtypes = [u8p, i64, i64, u32p, i64]
            for fn in (lib.pack_limbs, lib.unpack_limbs, lib.pack_windows):
                fn.restype = None
            _LIB = lib
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def available() -> bool:
    """Whether the native codec is in use (else the numpy one)."""
    return _load() is not None


def _bytes_matrix(xs: Sequence[int], nbytes: int) -> np.ndarray:
    buf = bytearray(len(xs) * nbytes)
    for i, x in enumerate(xs):
        buf[i * nbytes : (i + 1) * nbytes] = int(x).to_bytes(nbytes, "little")
    return np.frombuffer(bytes(buf), np.uint8).reshape(len(xs), nbytes)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def ints_to_limbs(xs: Sequence[int], num_limbs: int) -> Optional[np.ndarray]:
    """[batch, num_limbs] uint32 15-bit limbs, least significant first; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    nbytes = -(-(num_limbs * 15) // 8)
    mat = np.ascontiguousarray(_bytes_matrix(xs, nbytes))
    out = np.empty((len(xs), num_limbs), np.uint32)
    lib.pack_limbs(_u8(mat), len(xs), nbytes, _u32(out), num_limbs)
    return out


def limbs_to_ints(limbs: np.ndarray) -> Optional[List[int]]:
    """Inverse of :func:`ints_to_limbs` on canonical limbs; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    limbs = np.ascontiguousarray(limbs, np.uint32)
    if limbs.ndim == 1:
        limbs = limbs[None]
    batch, L = limbs.shape
    nbytes = -(-(L * 15) // 8)
    out = np.empty((batch, nbytes), np.uint8)
    lib.unpack_limbs(_u32(limbs), batch, L, _u8(out), nbytes)
    return [int.from_bytes(row.tobytes(), "little") for row in out]


def ints_to_windows(xs: Sequence[int], nw: int) -> Optional[np.ndarray]:
    """[batch, nw] uint8 4-bit windows, most significant first; None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    nbytes = -(-(nw * 4) // 8)
    mat = np.ascontiguousarray(_bytes_matrix(xs, nbytes))
    out = np.empty((len(xs), nw), np.uint32)
    lib.pack_windows(_u8(mat), len(xs), nbytes, _u32(out), nw)
    return out.astype(np.uint8)  # values < 16
