"""The port runs where there is no JAX: no module of
``sexy_raytracer_tpu_torch`` and not ``chip_smoke.py`` imports ``jax``,
``jaxlib`` or anything of the JAX package ``sexy_raytracer_tpu``, at any
depth of the file (a scan of every import statement)."""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "sexy_raytracer_tpu"}


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "sexy_raytracer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
