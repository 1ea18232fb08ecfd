"""No module under portbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "c99_vectordb_tpu"}
PROGRAM = "c99_vectordb_tpu_torch"


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert PROGRAM not in imported(path)


def test_the_guard_sees_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import c99_vectordb_tpu_torch.api\nfrom jax import numpy\n")
    assert imported(f) == {"c99_vectordb_tpu_torch", "jax"}
    f.write_text("import c99_vectordb_tpu.models as m\n")
    assert imported(f) & BANNED == {"c99_vectordb_tpu"}
