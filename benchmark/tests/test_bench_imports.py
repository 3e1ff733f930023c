"""What the benchmark may import: nothing under benchmark/ has the
top-level name jax, jaxlib, flax or fembrain_tpu (compared whole, so the
port fembrain_tpu_torch is not caught by a prefix), and the reference
imports nothing of the port."""
import ast

import pytest

from harness import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "fembrain_tpu"}
SOURCES = sorted(p for p in bench.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__", "import_module")):
            out.add("<dynamic>")
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(bench.HERE)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    names = top_names(path)
    assert not names & FORBIDDEN
    assert "<dynamic>" not in names


def test_reference_imports_nothing_of_the_port():
    for path in (bench.HERE / "reference").glob("*.py"):
        names = top_names(path)
        assert "fembrain_tpu_torch" not in names, path
        assert names <= {"__future__", "dataclasses", "math", "re",
                         "pathlib", "numpy", "scipy", "torch"}, (path, names)


def test_the_check_compares_whole_names():
    assert "fembrain_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "fembrain_tpu.ops".split(".")[0] in FORBIDDEN
