"""The dense advection slice end to end: the PyTorch port's Advection (on
the CPU) against the JAX package's, from identical numpy inputs.

Tolerances are the JAX package's own for the same comparisons
(tests/test_advection_dense.py): f64 rtol=1e-13, atol=1e-16; f32 against
the interpret-mode Pallas kernels rtol=2e-7 a step and rtol=1e-6,
atol=1e-9 for a run; mass conservation rel=1e-12 in f64.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu_torch.convert import state_from_numpy, state_to_numpy


def _grid(pkg, n, nz, periodic, D):
    g = (
        pkg.Grid()
        .set_initial_length((n, n, nz))
        .set_neighborhood_length(0)
        .set_periodic(*periodic)
        .set_geometry(
            pkg.CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / n, 1.0 / n, 1.0 / nz),
        )
    )
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))
    return g.initialize(n_devices=D, device="cpu")


def _pair(n=8, nz=8, periodic=(True, True, True), D=8, dtype=np.float64,
          use_pallas=True):
    """(jax model, jax state, port model, port state) with a seeded vz so
    all six faces carry flux; the port starts from the JAX state."""
    jg = _grid(dccrg_tpu, n, nz, periodic, D)
    ja = JAdvection(jg, dtype=dtype, use_pallas=use_pallas)
    js = ja.initialize_state()
    cells = jg.get_cells()
    vz = 0.3 * np.sin(2 * np.pi * jg.geometry.get_center(cells)[:, 2])
    js = ja.set_cell_data(js, "vz", cells, vz.astype(dtype))
    pa = dccrg_tpu_torch.Advection(_grid(dccrg_tpu_torch, n, nz, periodic, D),
                                   dtype=dtype)
    ps = state_from_numpy(pa, {k: np.asarray(v) for k, v in js.items()})
    return ja, js, pa, ps


def _rho(state):
    return np.asarray(state["density"]) if not hasattr(state["density"], "numpy") \
        else state["density"].numpy()


def test_initialize_state_matches_jax():
    for D, dtype in ((8, np.float64), (1, np.float32)):
        jg = _grid(dccrg_tpu, 8, 8, (True, True, True), D)
        ja = JAdvection(jg, dtype=dtype)
        pa = dccrg_tpu_torch.Advection(_grid(dccrg_tpu_torch, 8, 8, (True, True, True), D),
                                       dtype=dtype)
        js, ps = ja.initialize_state(), pa.initialize_state()
        assert set(js) == set(ps)
        for k in js:
            np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]))
        assert pa.max_time_step(ps) == ja.max_time_step(js)
        assert pa.total_mass(ps) == ja.total_mass(js)


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False)])
def test_f64_matches_jax(periodic):
    ja, js, pa, ps = _pair(periodic=periodic)
    assert pa.dense_kind == ("xla",) and not pa.fused
    dt = 0.4 * ja.max_time_step(js)
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    j, p = js, ps
    for _ in range(8):
        j, p = ja.step(j, dt), pa.step(p, dt)
    np.testing.assert_allclose(_rho(p), _rho(j), rtol=1e-13, atol=1e-16)
    j, p = ja.run(j, 5, dt), pa.run(p, 5, dt)
    np.testing.assert_allclose(_rho(p), _rho(j), rtol=1e-13, atol=1e-16)
    assert pa.total_mass(p) == pytest.approx(pa.total_mass(ps), rel=1e-12)


@pytest.mark.parametrize("nz,D,kind,fused", [
    (8, 1, ("blocked_direct", 8), True),
    (32, 4, ("blocked_direct", 8), False),
    (7, 1, ("plane",), True),
])
def test_f32_kernel_path_matches_pallas(nz, D, kind, fused):
    """f32 through the kernel wrappers (their twins on the CPU) against the
    JAX package's Pallas kernels in interpret mode."""
    ja, js, pa, ps = _pair(nz=nz, D=D, dtype=np.float32, use_pallas="interpret",
                           periodic=(True, True, False))
    assert pa.dense_kind == ja.dense_kind == kind
    assert pa.fused == (ja._fused_run is not None) == fused
    dt = np.float32(0.4 * ja.max_time_step(js))
    # per step: each of 8 steps from the same (JAX) state in both packages
    j = js
    for _ in range(8):
        p = pa.step(state_from_numpy(pa, {k: np.asarray(v) for k, v in j.items()}), dt)
        j = ja.step(j, dt)
        np.testing.assert_allclose(_rho(p), _rho(j), rtol=2e-7, atol=1e-9)
    j, p = ja.run(js, 5, dt), pa.run(ps, 5, dt)
    np.testing.assert_allclose(_rho(p), _rho(j), rtol=1e-6, atol=1e-9)


def test_mass_conservation_f64():
    _, _, pa, ps = _pair(D=1)
    m0 = pa.total_mass(ps)
    dt = 0.4 * pa.max_time_step(ps)
    s = ps
    for _ in range(20):
        s = pa.step(s, dt)
    assert pa.total_mass(s) == pytest.approx(m0, rel=1e-12)


def _port_density(D, nz, dtype, how, steps):
    pa = dccrg_tpu_torch.Advection(_grid(dccrg_tpu_torch, 8, nz, (True, True, True), D),
                                   dtype=dtype)
    s = pa.initialize_state()
    cells = pa.grid.get_cells()
    vz = 0.3 * np.sin(2 * np.pi * pa.grid.geometry.get_center(cells)[:, 2])
    s = pa.set_cell_data(s, "vz", cells, vz)
    dt = 0.4 * pa.max_time_step(s)
    if how == "run":
        s = pa.run(s, steps, dt)
    else:
        for _ in range(steps):
            s = pa.step(s, dt)
    return pa.get_cell_data(s, "density", cells)


@pytest.mark.parametrize("dtype,nz,how", [
    (np.float64, 8, "step"), (np.float64, 8, "run"),
    (np.float32, 32, "step"), (np.float32, 32, "run"),
])
def test_device_count_invariance(dtype, nz, how):
    """One, four and eight slab slots give bitwise-equal results (f32 run:
    the whole-run kernel's twin on one slot vs blocked steps on more; equal
    up to the sign of zero, which == ignores)."""
    ref = _port_density(1, nz, dtype, how, 6)
    for D in (4, 8):
        np.testing.assert_array_equal(_port_density(D, nz, dtype, how, 6), ref)


def test_state_round_trip():
    _, js, pa, ps = _pair(D=4, nz=8)
    back = state_to_numpy(ps)
    assert set(back) == set(js)
    for k, v in js.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    with pytest.raises(ValueError, match="shape"):
        state_from_numpy(pa, {"density": np.zeros((1, 2, 3, 4))})


@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_max_diff_matches_jax(periodic):
    ja, js, pa, ps = _pair(periodic=periodic, D=4)
    dt = 0.4 * ja.max_time_step(js)
    js, ps = ja.step(js, dt), pa.step(ps, dt)
    got = pa.compute_max_diff(ps, 0.25)["max_diff"].numpy()
    ref = np.asarray(ja.compute_max_diff(js, 0.25)["max_diff"])
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-16)
