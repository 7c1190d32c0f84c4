"""What the benchmark's modules import: never JAX or the JAX package
(top-level names compared whole, since the port's name begins with the
JAX package's), and in the plain reference nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sexy_raytracer_tpu"}
PORT = "sexy_raytracer_tpu_torch"
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in top_level_imports(path)
    # within the benchmark, only the reference's own modules
    text = path.read_text()
    assert "loops" not in text and "harness" not in text


def test_guard_compares_whole_names():
    assert "sexy_raytracer_tpu" in FORBIDDEN
    assert PORT.split(".")[0] not in FORBIDDEN


# the JAX package's benchmark files, which measure the TPU: named by
# parts so that this file does not name them itself
OLD = ["bench" + ".py", "chip_" + "smoke", "BENCH" + "_", "MULTI" + "CHIP_",
       "BASE" + "LINE.json"]


@pytest.mark.parametrize("path", [p for p in MODULES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_none_of_the_old_benchmark(path):
    text = path.read_text()
    assert not [o for o in OLD if o in text]
