"""Nothing that runs on the card imports JAX or the JAX package, and the
plain references import nothing of the port: an AST scan of every module
under ``portbench/``, compared by whole top-level name."""

import ast
import os

import pytest

from portbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mrisr_tpu",
             "bench", "benchmarks", "chip_smoke"}


def modules():
    for base, _, files in os.walk(core.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, core.HERE))
def test_no_jax_or_jax_package(path):
    bad = set(top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def test_whole_names_let_the_port_pass():
    tree = "import mrisr_tpu_torch.serve\nfrom mrisr_tpu_torch import api\n"
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0]
             for n in ast.parse(tree).body}
    assert names == {"mrisr_tpu_torch"} and not names & FORBIDDEN


def test_references_import_nothing_of_the_port():
    ref = os.path.join(core.HERE, "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            got = set(top_level_imports(os.path.join(ref, f)))
            assert "mrisr_tpu_torch" not in got, f
            assert got <= {"__future__", "math", "typing", "numpy", "torch",
                           "portbench"}, (f, got)


def test_guard_names_loaded_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "mrisr_tpu.config",
                        types.ModuleType("mrisr_tpu.config"))
    assert core.forbidden_loaded() == ["mrisr_tpu"]
    monkeypatch.delitem(sys.modules, "mrisr_tpu.config")
    monkeypatch.setitem(sys.modules, "mrisr_tpu_torch_x",
                        types.ModuleType("mrisr_tpu_torch_x"))
    assert "mrisr_tpu" not in core.forbidden_loaded()
