"""Nothing the benchmark runs loads the JAX package or JAX, and the plain
reference imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "dccrg_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        assert "dccrg_tpu_torch" not in set(_imports(path)), path
        assert "portbench" not in set(_imports(path)), path


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process, then ``sys.modules`` by top-level
    name (``dccrg_tpu_torch`` begins with ``dccrg_tpu``: compared whole)."""
    code = f"""
import sys, time
sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})
sys.path.insert(0, {str(REPO)!r})
import pathlib
from conftest import tiny_tree
from portbench import load, run
root = tiny_tree(pathlib.Path({str(tmp_path)!r}))
bench = load.benchmark(root)
r = run.run_cell(bench, load.workload(bench, "adv_amr_128.step20"), 3, 0.2, True,
                 "cpu", time.perf_counter(), root=root, log=lambda m: None)
assert r["correct"]
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
print("FORBIDDEN", run.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(p.stdout.split("LOADED")[1].split("FORBIDDEN")[0].strip()
                 .strip("[]").replace("'", "").replace(" ", "").split(","))
    assert "dccrg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
    assert p.stdout.strip().endswith("FORBIDDEN []")
