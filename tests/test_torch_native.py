"""The port's native host codec (utils/native.py, csrc/host_codec.cpp)
against its numpy codec (ops/limbs.py ``*_np``) and the JAX package's native
codec, on random and edge values, at the limb counts of 256- to 4096-bit keys
(18-547) and 32-1024 exponent windows.  Tolerance: exact equality."""

import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu.ops import limbs as jlb
from pailliercryptolib_tpu_torch.ops import limbs as tlb
from pailliercryptolib_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent


def _values(bits, seed):
    rng = random.Random(seed)
    return [rng.getrandbits(bits) for _ in range(40)] + [
        0, 1, (1 << bits) - 1, 1 << (bits - 1), rng.getrandbits(bits // 2)]


def test_native_available_and_built_outside_the_package():
    assert native.available()
    lib = native.lib_path()
    assert lib.parent == REPO / "build" and lib.exists()
    assert not list((REPO / "pailliercryptolib_tpu_torch").rglob("*.so"))


@pytest.mark.parametrize("L", [18, 35, 69, 137, 274, 410, 547])
def test_limbs_equal_numpy_and_reference(L):
    xs = _values(15 * L, L)
    got = native.ints_to_limbs(xs, L)
    assert got.dtype == np.uint32 and got.shape == (len(xs), L)
    assert np.array_equal(got, tlb.ints_to_limbs_np(xs, L))
    assert np.array_equal(got, jlb.ints_to_limbs(xs, L))
    assert np.array_equal(tlb.ints_to_limbs(xs, L), got)
    assert native.limbs_to_ints(got) == xs == tlb.limbs_to_ints_np(got)
    assert tlb.limbs_to_ints(got) == jlb.limbs_to_ints(got) == xs


@pytest.mark.parametrize("nw", [32, 64, 256, 512, 1024])
def test_windows_equal_numpy_and_reference(nw):
    es = _values(4 * nw, nw)
    got = native.ints_to_windows(es, nw)
    assert got.dtype == np.uint8 and got.shape == (len(es), nw)
    assert np.array_equal(got, tlb.ints_to_windows_np(es, 4 * nw))
    assert np.array_equal(got, jlb.ints_to_windows(es, 4 * nw))
    assert np.array_equal(tlb.ints_to_windows(es, 4 * nw), got)


def test_numpy_fallback_without_the_library(monkeypatch):
    xs = _values(1024, 3)
    want = tlb.ints_to_limbs(xs, 69), tlb.ints_to_windows(xs, 1024)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    assert np.array_equal(tlb.ints_to_limbs(xs, 69), want[0])
    assert np.array_equal(tlb.ints_to_windows(xs, 1024), want[1])
    assert tlb.limbs_to_ints(want[0]) == xs


def test_two_processes_build_at_once(tmp_path):
    """Two processes building into one empty build directory at the same
    time both load a whole library; one library and no temporary file is
    left there."""
    build = tmp_path / "build"
    code = (
        "import pathlib, sys\n"
        "from pailliercryptolib_tpu_torch.utils import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "assert native.available(), 'no library'\n"
        "assert native.limbs_to_ints(native.ints_to_limbs([12345678901234567890], 6))"
        " == [12345678901234567890]\n"
        "print(native.lib_path())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [q.name for q in build.iterdir()] == [pathlib.Path(paths.pop()).name]
