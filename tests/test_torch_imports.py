"""The port runs where there is no JAX: no module of
``sexy_raytracer_tpu_torch`` and not ``chip_smoke.py`` imports ``jax``,
``jaxlib`` or anything of the JAX package ``sexy_raytracer_tpu``, at any
depth of the file (a scan of every import statement)."""

import ast
import pathlib

import pytest

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


@pytest.mark.parametrize("module", ["ops/brute.py", "ops/bvh_traverse.py",
                                    "models/bvh.py", "native/bvh_native.py",
                                    "native/__init__.py"])
def test_big_scene_modules_import_no_jax(module):
    """The big-scene modules are in the scan and import none of it; the
    native builder's source is the JAX package's, byte for byte."""
    path = REPO / "sexy_raytracer_tpu_torch" / module
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    if module.startswith("native/"):
        cpp = "native/bvh_builder.cpp"
        assert (REPO / "sexy_raytracer_tpu_torch" / cpp).read_bytes() \
            == (REPO / "sexy_raytracer_tpu" / cpp).read_bytes()


@pytest.mark.parametrize("module", ["ops/shade.py", "ops/histogram.py",
                                    "utils/profiling.py", "tools/__init__.py",
                                    "tools/profile.py", "tools/devtime.py",
                                    "tools/prof_step.py",
                                    "tools/prof_dump.py",
                                    "tools/histogram_split.py"])
def test_tool_and_reference_modules_import_no_jax(module):
    """The profiling tools and the reference integrator's modules are in
    the scan and import none of it."""
    path = REPO / "sexy_raytracer_tpu_torch" / module
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", ["diff/inverse.py", "diff/silhouette.py",
                                    "diff/__init__.py", "render/camera.py",
                                    "utils/rng.py"])
def test_inverse_rendering_modules_import_no_jax(module):
    """The inverse-rendering path's modules are in the scan and import
    none of it."""
    path = REPO / "sexy_raytracer_tpu_torch" / module
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", ["models/gltf.py", "models/flatten.py",
                                    "models/presets.py", "oracle/reference.py",
                                    "oracle/__init__.py", "__main__.py",
                                    "utils/png.py"])
def test_entry_point_modules_import_no_jax(module):
    """The user entry points (the glTF loader, the flattened export, the
    preset registry, the numpy oracle and the command line) are in the
    scan and import none of it."""
    path = REPO / "sexy_raytracer_tpu_torch" / module
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_cli_runs_without_jax(tmp_path):
    """``python -m sexy_raytracer_tpu_torch render`` on the CPU in a
    process where any import of jax fails."""
    import subprocess
    import sys

    script = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['sexy_raytracer_tpu_torch', 'render', '--preset', "
        "'shirley_parity', '--height', '9', '--spp', '1', '--device', "
        f"'cpu', '--out', {str(tmp_path / 'x.png')!r}]\n"
        "runpy.run_module('sexy_raytracer_tpu_torch', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "x.png").exists()


@pytest.mark.parametrize("path", [
    "sexy_raytracer_tpu_torch/parallel/__init__.py",
    "sexy_raytracer_tpu_torch/parallel/mesh.py",
    "sexy_raytracer_tpu_torch/parallel/render.py",
    "sexy_raytracer_tpu_torch/graft_entry.py",
    "tests/torch_parallel_ranks.py"])
def test_mesh_modules_import_no_jax(path):
    """The mesh modules and the graft entry points are in the scan and
    import none of it; nor do the tests' rank bodies, so that a spawned
    rank starts without JAX."""
    path = REPO / path
    assert path.exists()
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "tools/run_inverse_experiment.py", "tools/run_flagship_render.py",
    "tools/run_scaling_curve.py", "tools/check_find_referee.py",
    "tools/diag_r5.py"])
def test_ported_root_tools_import_no_jax(module):
    """The root tools' counterparts are in the scan and import none of it,
    nor the root ``tools/`` scripts (``tools.*``, ``tputime``), whose
    helpers they copy."""
    path = REPO / "sexy_raytracer_tpu_torch" / module
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN | {"tools", "tputime"}]
    assert not bad, bad
