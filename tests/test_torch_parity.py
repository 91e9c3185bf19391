"""Every public name of the JAX package has its counterpart in the port.

A static walk with ``ast``: one case per module of ``pailliercryptolib_tpu/``.
A module's public names are its top-level ``def`` / ``class`` names that do
not start with ``_``, its top-level UPPER_CASE constants, and the public
methods and properties of its public top-level classes (``Class.method``).
Each must be defined under the same name in the same module of
``pailliercryptolib_tpu_torch/`` (a method also through a base class of that
module), or have an entry in ``COUNTERPARTS`` (its counterpart elsewhere in
the port, which must exist) or in ``NOT_PORTED`` (a reason, and the name in
``ROADMAP.md``'s list "Do not port these TPU workarounds").  A failing case
names the module and every name that has none.

Neither the JAX package nor the port is imported; torch is taken through
``pytest.importorskip`` only because every ``test_torch_*.py`` file does
(``tests/test_torch_imports.py``)."""

import ast
import pathlib
import re

import pytest
torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "pailliercryptolib_tpu"
PORT = ROOT / "pailliercryptolib_tpu_torch"
ROADMAP = ROOT / "ROADMAP.md"
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

#: (JAX module, name) -> (port module, name): the Pallas kernels and the
#: helpers of their modules, whose port lives in the CUDA kernels' modules
COUNTERPARTS = {
    ("ops/pallas_modexp.py", "pallas_mod_mul"): ("ops/cuda_modexp.py", "mod_mul"),
    ("ops/pallas_modexp.py", "pallas_modexp"): ("ops/cuda_modexp.py", "modexp"),
    ("ops/pallas_modexp.py", "pallas_mont_raw"): ("ops/cuda_modexp.py", "mont_raw"),
    ("ops/pallas_rns2.py", "pallas_fb_table2"): ("ops/cuda_rns2.py", "fb_table2"),
    ("ops/pallas_rns2.py", "pallas_fb_modexp2"): ("ops/cuda_rns2.py", "fb_modexp2"),
    ("ops/pallas_rns2.py", "pallas_rns_modexp2f"): ("ops/cuda_rns2.py", "rns_modexp2f"),
    ("ops/pallas_rns2.py", "pallas_rns_modexp2"): ("ops/cuda_rns2.py", "rns_modexp2"),
    ("ops/pallas_rns2.py", "fb_digit_planes2"): ("ops/cuda_rns2.py", "fb_gather_table"),
    ("ops/pallas_rns2.py", "stack_group_consts2"): ("ops/cuda_rns2.py", "stack_group_consts2"),
    ("ops/pallas_rns2.py", "fold_group_consts2"): ("ops/cuda_rns2.py", "fold_group_consts2"),
    ("ops/pallas_rns2.py", "unfold_rns_out"): ("ops/cuda_rns2.py", "unfold_rns_out"),
    ("ops/pallas_rns2.py", "FB_TABLE"): ("ops/cuda_rns2.py", "FB_TABLE"),
    ("ops/pallas_rns2.py", "FB_WINDOW_BITS"): ("ops/cuda_rns2.py", "FB_WINDOW_BITS"),
    ("ops/pallas_rns2.py", "ALPHA_W_BITS"): ("ops/cuda_rns2.py", "ALPHA_W_BITS"),
}

_TILE = ("the TPU's 128-row batch tile, which the Pallas kernels' grids and "
         "the engines' padding are cut to; the port's kernels take any batch "
         "and mask their ragged last row tile")
#: (JAX module, name) -> why the port leaves it out; the name also stands
#: (in backquotes) in ROADMAP.md's list "Do not port these TPU workarounds"
NOT_PORTED = {
    ("ops/pallas_modexp.py", "BATCH_TILE"): _TILE,
    ("ops/pallas_rns2.py", "BATCH_TILE"): _TILE,
    ("models/engine.py", "PrivateEngine.rns_crt_grouped"): (
        "the integer-Barrett flavour of the grouped (p^2, q^2) constant set, "
        "built only for the profiling tools that compare the reduction "
        "flavours; the port's kernels run the f32-reciprocal flavour "
        "(PrivateEngine.rns_crt_stacked)"),
}

MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _assigned(node) -> list:
    """The plain names an Assign / AnnAssign binds (tuples unpacked)."""
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        out += [e.id for e in elts if isinstance(e, ast.Name)]
    return out


def _defs(body) -> dict:
    """name -> node of the defs, classes and assignments of one body."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _assigned(node):
                out[name] = node
    return out


def public_names(path: pathlib.Path) -> list:
    """A module's public names: top-level functions and classes, UPPER_CASE
    constants, and ``Class.method`` for the public methods and properties of
    its public classes."""
    names = []
    for name, node in _defs(_tree(path).body).items():
        if name.startswith("_"):
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            if UPPER.match(name):
                names.append(name)
            continue
        names.append(name)
        if isinstance(node, ast.ClassDef):
            names += [f"{name}.{m.name}" for m in node.body
                      if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and not m.name.startswith("_")]
    return sorted(set(names))


def has_name(module: str, name: str, root: pathlib.Path = PORT) -> bool:
    """``name`` (``f`` or ``Class.method``) is defined in ``module`` of the
    port (``root``); a method in the class's body or in a base class that the
    module defines."""
    path = root / module
    if not path.is_file():
        return False
    top = _defs(_tree(path).body)
    if "." not in name:
        return name in top
    cls, meth = name.split(".", 1)

    def in_class(c, seen):
        node = top.get(c)
        if not isinstance(node, ast.ClassDef) or c in seen:
            return False
        return meth in _defs(node.body) or any(
            in_class(b.id, seen | {c}) for b in node.bases if isinstance(b, ast.Name))

    return in_class(cls, frozenset())


def _do_not_port_block() -> str:
    text = ROADMAP.read_text()
    start = text.index("**Do not port these TPU workarounds.**")
    end = text.find("\n\n", start)
    return text[start:] if end < 0 else text[start:end]


def test_every_module_is_walked():
    assert "models/engine.py" in MODULES and "ops/pallas_rns2.py" in MODULES
    assert len(MODULES) >= 20


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_counterparts(module):
    missing = []
    for name in public_names(JAX / module):
        key = (module, name)
        if key in NOT_PORTED:
            continue
        target = COUNTERPARTS.get(key, (module, name))
        if not has_name(*target):
            missing.append(name if target == (module, name)
                           else f"{name} -> {target[0]}:{target[1]}")
    assert not missing, (
        f"pailliercryptolib_tpu/{module}: no counterpart in "
        f"pailliercryptolib_tpu_torch/ for {', '.join(missing)}")


@pytest.mark.parametrize(
    "key", sorted(COUNTERPARTS) + sorted(NOT_PORTED), ids=lambda k: f"{k[0]}:{k[1]}")
def test_table_entries_name_public_names(key):
    """No entry of the tables outlives its name in the JAX package, and none
    hides a name that the port has at the same place."""
    module, name = key
    assert name in public_names(JAX / module), f"{module}:{name} is not a public name"
    assert not has_name(module, name), f"{module}:{name} is in the port: drop the entry"


@pytest.mark.parametrize("key", sorted(NOT_PORTED), ids=lambda k: f"{k[0]}:{k[1]}")
def test_not_ported_is_in_the_roadmap(key):
    """A name is left out only with a reason and a line of ROADMAP.md's list
    of TPU workarounds that the port does not take over."""
    assert len(NOT_PORTED[key]) > 40
    attr = key[1].split(".")[-1]
    assert f"`{attr}`" in _do_not_port_block(), (
        f"{key[0]}:{key[1]} is not in ROADMAP.md's 'Do not port' list")


def test_the_walk_sees_a_missing_name(tmp_path):
    """The walk itself: a name dropped from a copy of a port module fails its
    module's check; a method that a base class defines is found."""
    assert has_name("models/engine.py", "ShardedLimbs.fetch")
    assert has_name("models/engine.py", "ShardedLimbs.encrypt_djn") is False
    assert has_name("models/engine.py", "PrivateEngine.decrypt_crt")
    assert not has_name("models/engine.py", "PrivateEngine.rns_crt_grouped")
    module = "ops/montgomery.py"
    tree = _tree(PORT / module)
    tree.body = [n for n in tree.body if getattr(n, "name", None) != "carry_round2"]
    (tmp_path / "ops").mkdir()
    (tmp_path / module).write_text(ast.unparse(tree))
    assert has_name(module, "carry_round2")
    assert not has_name(module, "carry_round2", root=tmp_path)
    assert has_name(module, "carry_round", root=tmp_path)
    assert "carry_round2" in public_names(JAX / module)
