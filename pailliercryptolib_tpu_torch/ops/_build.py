"""Build and load the port's CUDA kernels.

The sources under ``pailliercryptolib_tpu_torch/csrc/`` have a plain C
interface (no PyTorch headers), so ``nvcc`` compiles each in seconds.  Every
``*.cu`` is compiled to an object file, all compilations started together,
and the objects are linked into ONE shared library that ``ctypes`` loads.
The build happens at the first kernel launch — importing the package needs
neither ``nvcc`` nor a GPU — into ``build/`` at the repository root.  The
library's name carries a hash of the sources and the compiler flags, so a
change of either builds a new library and nothing stale is ever loaded.
Each build compiles and links in a temporary directory of its own and then
renames the library into place: processes that build at the same time do not
see each other's half-written files.  A failed build raises with the
compiler's output; nothing falls back to another implementation.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <tmp>/<name>.o
    nvcc -shared -o <tmp>/lib.so <tmp>/*.o

``ptxas -v`` reports registers, shared memory and spills of every kernel;
the report is kept beside the library and :func:`kernel_stats` parses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: C signatures of the launchers (every function returns the cudaError_t of
#: its launch as an int; strides are long long, in elements).
SIGNATURES = {
    "fb_table2_tc_launch": [_P] * 8 + [_I] * 7 + [_P],
    "fb_table2_tc_max_clusters": [_I] * 5,
    "fb_modexp2_tc_launch": [_P] * 7 + [_I] * 8 + [_P],
    "fb_modexp2_tc_max_clusters": [_I] * 5,
    "rns_modexp2f_tc_launch": [_P] * 9 + [_I] * 6 + [_P],
    "rns_modexp2_tc_launch": [_P] * 9 + [_I] * 11 + [_P],
    "rns_modexp2_tc_max_clusters": [_I] * 5,
    "rns_tc_smem_bytes": [_I],
    "rns_modexp2f_tc_max_clusters": [_I] * 3,
    "probe_mont_chain_launch": [_P] * 6 + [_I] * 7 + [_P],
    "mod_mul_launch": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P],
    "mont_raw_launch": [_P, _P, _LL, _LL, _P, _P, _I, _I, _I, _P],
    "modexp_launch": [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "probe_barrett_chain_launch": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "probe_chain_launch": [_P, _P, _P, _LL, _LL, _I, _I, _I, _P],
    "probe_chain_grid": [_LL, _I, _I],
    "probe_lag_chain_launch": [_P, _P, _P, _LL, _LL, _I, _I, _P],
    "probe_i8mm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "probe_f32mm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds the last build in this process took, span ``kernels.build`` (0.0
#: when the library was already there)
last_build_seconds = 0.0


def _sources():
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources, sorted(CSRC.glob("*.cuh"))


def lib_path() -> Path:
    """Where the library of the present sources and flags lives."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpaillier_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (on PATH or under CUDA_HOME): the CUDA kernels of "
        "pailliercryptolib_tpu_torch are compiled at first use"
    )


def _run_all(cmds):
    """Start every command at once, wait for all, raise on any failure with
    the compiler's output; return the outputs."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failures, outputs = [], []
    for cmd, p in procs:
        out, _ = p.communicate()
        outputs.append(out)
        if p.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return outputs


def build() -> Path:
    """Compile the sources unless their library is already there; return its
    path."""
    global last_build_seconds
    lib = lib_path()
    if lib.exists():
        return lib
    sources, _ = _sources()
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with trace.timed("kernels.build") as sp, tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        objs = [tmp / (src.stem + ".o") for src in sources]
        outputs = _run_all(
            [
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objs)
            ]
        )
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / "lib.so"), *map(str, objs)]])
        (tmp / "ptxas.log").write_text("\n".join(outputs))
        # the report first: whoever sees the library also finds its report
        os.replace(tmp / "ptxas.log", lib.with_suffix(".ptxas.log"))
        os.replace(tmp / "lib.so", lib)
    last_build_seconds = sp.seconds
    trace.count("kernels.builds")
    return lib


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '(\S+)'.*?"
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?"
    r"Used (\d+) registers(?:, used \d+ barriers)?"
    r"(?:, \d+ bytes cumulative stack size)?(?:, (\d+) bytes smem)?",
    re.S,
)


def _kernel_name(entry: str) -> str:
    """``fb_table2_kernel`` out of ``_ZN4prns16fb_table2_kernelE...``: the
    length-prefixed part of a mangled name that ends in ``_kernel``, with
    boolean or integer template arguments (``ILb0ELb1EE``, ``ILi9EE``)
    appended as ``<0,1>``, ``<9>``."""
    pos = len(entry) - len(entry.removeprefix("_ZN").removeprefix("_Z"))
    while m := re.match(r"\d+", entry[pos:]):  # the parts in turn: a name may end in digits
        start = pos + m.end()
        pos = start + int(m.group(0))
        name = entry[start:pos]
        if name.endswith("_kernel"):
            targs = re.match(r"I((?:L[bi]\d+E)+)E", entry[pos:])
            if targs:
                name += "<" + ",".join(re.findall(r"L[bi](\d+)E", targs.group(1))) + ">"
            return name
    return entry


def parse_ptxas(report: str) -> list:
    """Per compiled kernel: registers a thread, static shared memory, stack
    frame and spill bytes, from a ``ptxas -v`` report."""
    stats = []
    for entry, stack, st, ld, regs, smem in _PTXAS_ENTRY.findall(report):
        stats.append(
            {
                "kernel": _kernel_name(entry),
                "registers": int(regs),
                "smem_bytes": int(smem or 0),
                "stack_bytes": int(stack),
                "spill_store_bytes": int(st),
                "spill_load_bytes": int(ld),
            }
        )
    return stats


def kernel_stats() -> list:
    """:func:`parse_ptxas` of the report kept beside the built library."""
    return parse_ptxas(build().with_suffix(".ptxas.log").read_text())


def load():
    """The loaded kernel library (built on first call), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # words of power-table scratch a modexp launch needs (0: L not served)
            lib.modexp_table_words.argtypes = [_I, _I, _I]
            lib.modexp_table_words.restype = _LL
            _lib = lib
        return _lib


def need_cuda(name: str, *tensors) -> None:
    """Raise unless the operands of kernel ``name`` are contiguous tensors on
    one CUDA device."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"{name}: the kernel runs on a CUDA tensor only (got {t.device}); "
                f"call {name}_plain for the plain version"
            )
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {t.device} and {tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def check_launch(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def current_stream_ptr():
    import torch

    return torch.cuda.current_stream().cuda_stream
