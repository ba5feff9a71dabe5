"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
loads no file of the JAX package by path, and it never drops to the CPU
unless asked."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dccrg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                ROOT / "kernel_probe.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dccrg_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


#: calls that run or load a source file by path
_BY_PATH = {"spec_from_file_location", "SourceFileLoader", "SourcelessFileLoader",
            "run_path", "run_module", "load_source", "exec", "execfile"}


def _call_name(func) -> str:
    return func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_package_files_loaded_by_path(path):
    """No port file runs a file by path (``importlib.util.
    spec_from_file_location``, ``runpy``, ``exec``), the way a module of
    ``dccrg_tpu/`` could be loaded without importing the package, and no
    ``importlib.import_module`` / ``__import__`` names the JAX package."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name in _BY_PATH:
            bad.append(f"{name}() at line {node.lineno}")
        elif name in ("import_module", "__import__") and node.args:
            arg = node.args[0]
            if not isinstance(arg, ast.Constant) or _forbidden(str(arg.value)):
                bad.append(f"{name}() at line {node.lineno}")
    assert not bad, f"{path.name} loads code dynamically: {bad}"


_PROBE = """
import sys
import numpy as np
import dccrg_tpu_torch as P
g = (P.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
     .set_periodic(True, True, True)
     .set_geometry(P.CartesianGeometry, start=(0, 0, 0),
                   level_0_cell_length=(1 / 8, 1 / 8, 1 / 8))
     .initialize(device="cpu"))
for dtype in (np.float32, np.float64):
    a = P.Advection(g, dtype=dtype)
    s = a.initialize_state()
    dt = 0.4 * a.max_time_step(s)
    for _ in range(3):
        s = a.step(s, dt)
    assert np.isfinite(a.total_mass(s))
# adaptive refinement: refine a ball, run the flat path (its twin on the
# CPU), one adaptation cycle, a gather step and a halo exchange on 3 slots
for D in (1, 3):
    g = (P.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(P.CartesianGeometry, start=(0, 0, 0),
                       level_0_cell_length=(1 / 8, 1 / 8, 1 / 8))
         .initialize(n_devices=D, device="cpu"))
    ids = g.get_cells()
    g.refine_completely_many(
        ids[np.linalg.norm(g.geometry.get_center(ids) - 0.45, axis=1) < 0.28])
    g.stop_refining()
    a = P.Advection(g, dtype=np.float32)
    assert a._flat_kind == ("pallas" if D == 1 else None)
    s = a.initialize_state()
    s = a.run(s, 3, 0.3 * a.max_time_step(s))
    s = a.check_for_adaptation(s)
    a, s, new, removed = a.adapt_grid(s)
    s = a.step(s, 0.3 * a.max_time_step(s))
    s = g.update_copies_of_remote_neighbors(s)
    assert np.isfinite(a.total_mass(s))
    # Vlasov on the refined grid (general path) and GoL on a 2-D board
    v = P.Vlasov(g, nv=2, dtype=np.float32)
    assert np.isfinite(v.total_mass(v.run(v.initialize_state(), 2, 0.3 * v.max_time_step())))
    b = (P.Grid().set_initial_length((8, 8, 1)).set_neighborhood_length(1)
         .initialize(n_devices=D, device="cpu"))
    gol = P.GameOfLife(b)
    assert len(gol.alive_cells(gol.run(gol.new_state([27, 28, 29]), 3))) == 3
g = (P.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
     .set_periodic(True, True, False)
     .set_geometry(P.CartesianGeometry, start=(0, 0, 0),
                   level_0_cell_length=(1 / 8, 1 / 8, 1 / 8))
     .initialize(device="cpu"))
v = P.Vlasov(g, nv=2, dtype=np.float32)
assert v._fused_block and np.isfinite(v.total_mass(v.run(v.initialize_state(), 2, 0.01)))
# Poisson on a refined grid: the f64 flat solve and the f32 whole-solve
# path (its twin on the CPU)
g = (P.Grid().set_initial_length((6, 6, 6)).set_neighborhood_length(0)
     .set_periodic(True, True, True).set_maximum_refinement_level(1)
     .set_geometry(P.CartesianGeometry, start=(0, 0, 0),
                   level_0_cell_length=(1 / 6, 1 / 6, 1 / 6))
     .initialize(device="cpu"))
ids = g.get_cells()
g.refine_completely_many(
    ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
g.stop_refining()
x = g.geometry.get_center(g.get_cells())[:, 0]
for dtype in (np.float64, np.float32):
    p = P.Poisson(g, dtype=dtype)
    assert (p._solve_fast is not None) == (dtype == np.float32)
    s, res, it = p.solve(p.initialize_state(np.sin(2 * np.pi * x)), max_iterations=20)
    assert np.isfinite(res) and it > 0
# checkpoint round trip, VTK, the boxed passes and the flat XLA forms
import os, tempfile
a = P.Advection(g, dtype=np.float64)
s = a._boxed_run(a.initialize_state(), 2, 0.3 * a.max_time_step(a.initialize_state()))
with tempfile.TemporaryDirectory() as tmp:
    g.save_grid_data(s, os.path.join(tmp, "c.dc"), a.spec)
    g2, s2, _ = P.Grid.load_grid_data(os.path.join(tmp, "c.dc"), a.spec, n_devices=2,
                                      device="cpu")
    g2.write_vtk_file(os.path.join(tmp, "c.vtk"),
                      {"density": g2.get_cell_data(s2, "density", g2.get_cells())})
a2 = P.Advection(g2, dtype=np.float64)
assert np.isfinite(a2.total_mass(a2.run(g2.update_copies_of_remote_neighbors(s2), 2, 0.01)))
root = os.path.realpath("dccrg_tpu") + os.sep
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dccrg_tpu")
             or os.path.realpath(getattr(sys.modules[m], "__file__", None) or "")
             .startswith(root)))
"""


def test_import_and_run_leave_no_jax_modules():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cuda_grid_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import dccrg_tpu_torch as P

    with pytest.raises(RuntimeError, match="CUDA"):
        g = P.Grid().set_initial_length((8, 8, 8)).initialize(device="cuda")
        P.Advection(g, dtype="float32").initialize_state()
