"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Import names are
compared by their top-level part, whole: the port's name begins with
the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "wesup_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_imports(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.relative_to(HERE).parts:
        assert "wesup_tpu_torch" not in tops, path


def test_the_check_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom jax import numpy\nimport wesup_tpu_torch\n")
    assert imported_tops(f) == {"os", "jax", "wesup_tpu_torch"}
    assert imported_tops(f) & FORBIDDEN == {"jax"}
