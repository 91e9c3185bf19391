"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from kit import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "pailliercryptolib_tpu"}
PROGRAM = "pailliercryptolib_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_sys_modules_after_import():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import runpy\n"
        "import benchport.harness, benchport.reference.paillier, benchport.reference.chacha20\n"
        "sys.argv = ['run.py', '--help']\n"
        "try:\n"
        "    runpy.run_path(%r, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "import pailliercryptolib_tpu_torch.models.engine\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(REPO), str(REPO / "benchport" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_file_of_the_benchmark_names_jax():
    for path in (REPO / "benchport").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path) if m}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchport" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path) if m}
        assert PROGRAM not in tops and "torch" not in tops, (path, tops)
        assert tops <= {"__future__", "math", "numpy"}, (path, tops)


def test_harness_guard_compares_whole_names(monkeypatch):
    from benchport import harness

    monkeypatch.setitem(sys.modules, "pailliercryptolib_tpu_torch_fake", sys)
    assert "pailliercryptolib_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
