"""The port's mesh across processes: two gloo processes on the CPU, one
global mesh of four entries.

Launches tests/torch_multihost_driver.py twice; the driver runs the public
API over the mesh, checks that each process computes only its own entries'
rows and that ``fetch`` all-gathers, and holds the ciphertexts bit for bit
against host pow().  Counterpart of tests/test_multihost.py."""

import os
import socket
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_public_api():
    assert torch.distributed.is_gloo_available()
    port = _free_port()
    driver = os.path.join(os.path.dirname(__file__), "torch_multihost_driver.py")
    procs = [
        subprocess.Popen(
            [sys.executable, driver, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"TORCH_MULTIHOST_OK pid={i}" in out, out
