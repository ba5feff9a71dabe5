"""The port's user examples (``dccrg_tpu_torch/examples/``) on the CPU, each
with small arguments and ``--device cpu``: every one prints its PASSED
line.  Where an example prints a result, it is held to the JAX package's
example (``examples/``) run with the same arguments in a subprocess
(``JAX_PLATFORMS=cpu``, x64 off as the script leaves it):

* ``vlasov``: the phase-space mass before and after and the density
  field's min and max, both at the example's 200 steps, within 4 float32
  ULP a step relative (``tests/test_torch_vlasov.py``'s float32 step
  tolerance, over 200 steps) and one unit in the last printed digit;
* ``poisson``: cells and refined cells exact, iterations within 1 and the
  error against the analytic solution at rtol 1e-3 (the float32 solve's
  tolerance in ``tests/test_torch_poisson_kernel.py``);
* ``stretched_poisson``: the operator path and the analytic error at rtol
  1e-3 (its float32 stop is the semi-convergence rule, so the iteration
  counts of two rounding orders are not compared);
* ``advection_amr``: steps, time and cells exact, the mass at rel 1e-6
  (``tests/test_torch_advection_amr.py``'s mass tolerance);
* ``restart``: the PASSED line (bit-identity on 4 then 2 slots) equal.

``dc2vtk`` converts the checkpoint that the port's ``restart`` writes.
"""
import importlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: each example's small arguments (the JAX example's where it takes them)
ARGS = {
    "simple_game_of_life": [],
    "game_of_life": ["40", "12"],
    "vlasov": [],
    "poisson": [],
    "advection_amr": ["--cells", "100", "--tmax", "0.1"],
    "restart": [],
    "particles": [],
    "stretched_poisson": [],
    "dc2vtk": [],
    "ensemble_serving": ["--scenarios", "4", "--steps", "5"],
}

#: the JAX example's arguments for the examples held to it
JAX_ARGS = {
    "vlasov": [],
    "poisson": [],
    "stretched_poisson": [],
    "advection_amr": ["--cells", "100", "--tmax", "0.1"],
    "restart": [],
}

NUM = r"([-+0-9.e]+)"


def _run_port(name, argv, capsys):
    mod = importlib.import_module(f"dccrg_tpu_torch.examples.{name}")
    assert mod.main(argv + ["--device", "cpu"]) is None
    return capsys.readouterr().out


def _start_jax(name):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *JAX_ARGS[name]],
        cwd=str(ROOT), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish_jax(p):
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    return out


def _close_as_printed(port, jax_value, digits, steps=200):
    """``port`` within ``steps`` x 4 float32 ULP of ``jax_value``, relative,
    plus one unit in the last of the ``digits`` printed after the point of
    a ``%e`` form."""
    unit = 10.0 ** (np.floor(np.log10(abs(jax_value))) - digits)
    return abs(port - jax_value) <= steps * 4 * np.finfo(np.float32).eps * abs(jax_value) + unit


def _grab(pattern, text):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return [float(v) if any(c in v for c in ".e") else int(v) for v in m.groups()]


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_passes(name, tmp_path, capsys):
    jax_run = _start_jax(name) if name in JAX_ARGS else None
    argv = list(ARGS[name])
    if name == "dc2vtk":
        dc = str(tmp_path / "mid.dc")
        assert "PASSED" in _run_port("restart", ["--save", dc], capsys)
        argv = [dc, str(tmp_path / "mid.vtk"), "density:f4"]
    out = _run_port(name, argv, capsys)
    assert re.search(r"^PASSED", out, re.M), out
    if jax_run is None:
        return
    want = _finish_jax(jax_run)
    if name == "vlasov":
        for pat, digits in ((rf"phase-space mass {NUM} -> {NUM}", 6),
                            (rf"density field: min {NUM} max {NUM}", 4)):
            for p, j in zip(_grab(pat, out), _grab(pat, want)):
                assert _close_as_printed(p, j, digits), (pat, p, j)
    elif name == "poisson":
        pat = (rf"(\d+) cells \((\d+) refined\), (\d+) iterations, residual {NUM}, "
               rf"max rel error vs analytic {NUM}")
        p, j = _grab(pat, out), _grab(pat, want)
        assert p[:2] == j[:2]
        assert abs(p[2] - j[2]) <= 1, (p, j)
        assert p[4] == pytest.approx(j[4], rel=1e-3)
    elif name == "stretched_poisson":
        pat = r"operator path: (\w+), .* max rel error vs analytic ([-+0-9.e]+)"
        (pp, pe), (jp, je) = [re.search(pat, t).groups() for t in (out, want)]
        assert pp == jp
        assert float(pe) == pytest.approx(float(je), rel=1e-3)
    elif name == "advection_amr":
        pat = rf"done: (\d+) steps, t={NUM}, (\d+) cells, mass {NUM}"
        p, j = _grab(pat, out), _grab(pat, want)
        assert p[:3] == j[:3]
        assert p[3] == pytest.approx(j[3], rel=1e-6)
    elif name == "restart":
        line = [ln for ln in out.splitlines() if ln.startswith("PASSED")]
        assert line == [ln for ln in want.splitlines() if ln.startswith("PASSED")]


def test_example_asked_for_cuda_does_not_run_on_the_cpu():
    """Where there is no CUDA, an example left at its default device fails
    and says so; nothing carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "dccrg_tpu_torch.examples.simple_game_of_life"],
                       cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
