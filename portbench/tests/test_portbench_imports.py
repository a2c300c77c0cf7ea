"""The import boundary: nothing under portbench/ imports JAX or the JAX
package (top-level names compared whole: `llm_tpu_torch` is the port),
and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "llm_tpu"}


def _tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PB / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_nothing_of_the_port(path):
    assert "llm_tpu_torch" not in _tops(path)
    assert _tops(path) <= {"__future__", "math", "numpy", "torch",
                           "portbench"}


def test_the_check_sees_each_form_of_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom llm_tpu.ops import x\n"
                   "import importlib\nimportlib.import_module('flax.linen')\n"
                   "from llm_tpu_torch import serve\nfrom . import y\n")
    assert _tops(src) == {"jax", "llm_tpu", "importlib", "flax",
                          "llm_tpu_torch"}
    assert _tops(src) & FORBIDDEN == {"jax", "llm_tpu", "flax"}
