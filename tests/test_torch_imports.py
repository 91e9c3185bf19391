"""The PyTorch port's test files must not stop a run that has no torch (the
reference's CI installs jax, numpy and pytest only): each takes torch through
``pytest.importorskip("torch")`` before any import that pulls torch in, so
that without torch the file is skipped and the JAX package's tests run.  A
static check with ``ast``; this file itself imports no torch."""

import ast
import pathlib

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
FILES = sorted(p.name for p in TESTS.glob("test_torch_*.py") if p.name != "test_torch_imports.py")


def _needs_torch(node) -> bool:
    """An import statement that pulls torch in: torch itself, the port, or
    another of the port's test files."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""]
    else:
        return False
    return any(n == "torch" or n.startswith(("torch.", "pailliercryptolib_tpu_torch",
                                               "test_torch_"))
               for n in names)


def _is_skip(node) -> bool:
    """``torch = pytest.importorskip("torch")``"""
    if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
        return False
    f = node.value.func
    return (
        [t.id for t in node.targets if isinstance(t, ast.Name)] == ["torch"]
        and isinstance(f, ast.Attribute) and f.attr == "importorskip"
        and isinstance(f.value, ast.Name) and f.value.id == "pytest"
        and [a.value for a in node.value.args if isinstance(a, ast.Constant)] == ["torch"]
    )


def test_the_port_has_test_files():
    assert len(FILES) >= 11


@pytest.mark.parametrize("name", FILES)
def test_torch_comes_through_importorskip(name):
    tree = ast.parse((TESTS / name).read_text(), name)
    skipped = False
    for node in tree.body:  # module level, in order
        if _is_skip(node):
            skipped = True
        elif _needs_torch(node):
            assert skipped, f"{name}:{node.lineno} imports torch before importorskip"
    assert skipped, f"{name} does not take torch through pytest.importorskip"
    # no import of torch anywhere else in the file either
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert "torch" not in [a.name for a in node.names], f"{name}:{node.lineno}"
