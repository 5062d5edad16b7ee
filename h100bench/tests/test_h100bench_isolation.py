"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program either: every module of the folder
parsed (top-level names compared whole: the port's name begins with the
JAX package's), then a tiny run's ``sys.modules`` in a fresh interpreter."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import hygiene

BENCH = Path(__file__).resolve().parents[1]
PORT = "spark_rapids_ml_tpu_torch"


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).partition(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & set(hygiene.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert PORT not in tops and not tops & set(hygiene.FORBIDDEN), tops


def test_forbidden_names_compare_whole():
    assert hygiene.forbidden_modules([PORT, f"{PORT}.ops", "jaxtyping", "flaxen"]) == []
    assert hygiene.forbidden_modules(["jax.numpy", "spark_rapids_ml_tpu.ops", "os"]) == [
        "jax", "spark_rapids_ml_tpu"]


SCRIPT = """
import json, sys
sys.path.insert(0, {checkout!r}); sys.path.insert(0, {tests!r})
import torch
from conftest import tiny_cell
from h100bench import hygiene, run
for name in ("kmeans-c5.fit",):
    res = run.run_cell(tiny_cell(name), 12345, 0.2, True, torch.device("cpu"), 0.0)
    assert res["correct"], res
print(json.dumps({{"forbidden": hygiene.forbidden_modules(),
                  "port": any(m.startswith({port!r}) for m in sys.modules)}}))
"""


def test_a_tiny_run_loads_neither():
    code = SCRIPT.format(checkout=str(BENCH.parent), tests=str(BENCH / "tests"), port=PORT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip().splitlines()[-1]
    seen = json.loads(out)
    assert seen == {"forbidden": [], "port": True}
