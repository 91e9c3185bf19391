"""The four scripts of examples_torch/ (the port's counterparts of
examples/) run their ``main`` on the CPU at 256-bit keys; each asserts its
own results (round trips, homomorphic sums and products, serialized bytes,
every backend and hybrid split against the plaintexts)."""

import importlib.util
import pathlib

import pytest
torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"
NAMES = ["example_encrypt_decrypt", "example_add_mul", "example_serialization",
         "example_backends"]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_are_the_reference_set():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)
    ref = pathlib.Path(__file__).resolve().parent.parent / "examples"
    assert sorted(p.stem for p in ref.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_main_on_cpu(name, capsys):
    torch.set_num_threads(1)
    _load(name).main(device="cpu", bits=256)
    out = capsys.readouterr().out
    assert "OK" in out or "HybridMode.XLA" in out
