"""The AMR advection slice end to end: the port's Advection on refined grids
(on the CPU) against the JAX package's, from identical inputs, compared by
cell id.

Tolerances are the JAX package's own for the same comparisons:
flat run against the reference numerics 2e-6 of the peak density and
level-weighted mass rel=1e-6 (test_advection_flat.py:63-68); f64 gather
step rtol=1e-12; the refinement indicator rtol=1e-12, atol=1e-14
(test_advection_amr.py:114-117); mass across an adaptation cycle rel=1e-10
(test_advection_amr.py:59).
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu_torch.convert import rows_state_from_numpy
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts


def _make(pkg, levels, D=1, periodic=(True, True, True)):
    """The JAX flat tests' grids: the 8^3 ball of test_advection_flat.py
    (two levels) and ``ball_grid`` of test_advection_flat_ml.py (three)."""
    cell = (1 / 8,) * 3 if levels == 1 else (0.1, 0.07, 0.13)
    g = (
        pkg.Grid()
        .set_initial_length((8, 8, 8))
        .set_neighborhood_length(0)
        .set_periodic(*periodic)
        .set_maximum_refinement_level(levels)
        .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=cell)
    )
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    if levels == 1:
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.45, axis=1)
        for cid in ids[r < 0.28]:
            g.refine_completely(int(cid))
        g.stop_refining()
        return g
    for rad in (0.3, 0.15):
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        lv = g.mapping.get_refinement_level(ids)
        for cid in ids[(r < rad) & (lv == lv.max())]:
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def _seed(adv, state, dtype):
    """test_advection_flat.py's seeded velocities: vz and vy vary, so all
    six faces carry flux in both directions."""
    g = adv.grid
    ids = g.get_cells()
    cen = g.geometry.get_center(ids)
    state = adv.set_cell_data(state, "vz", ids,
                              (0.3 * np.sin(2 * np.pi * cen[:, 2])).astype(dtype))
    state = adv.set_cell_data(state, "vy", ids,
                              (0.2 + 0.1 * np.cos(2 * np.pi * cen[:, 1])).astype(dtype))
    return state


def _pair(levels, dtype, D=1, use_pallas=True, periodic=(True, True, True)):
    """(jax grid, jax model, jax state, port grid, port model, port state);
    the port's state is the JAX state carried over by cell id."""
    jg = _make(dccrg_tpu, levels, D, periodic)
    ja = JAdvection(jg, dtype=dtype, use_pallas=use_pallas)
    js = ja._exchange(_seed(ja, ja.initialize_state(), dtype))
    pg = _make(dccrg_tpu_torch, levels, D, periodic)
    pa = dccrg_tpu_torch.Advection(pg, dtype=dtype, use_kernels=use_pallas is not False)
    host = {k: np.asarray(v) for k, v in js.items()}
    ps = rows_state_from_numpy(pg, host, jg.epoch.cell_ids)
    return jg, ja, js, pg, pa, ps


def _rho(g, adv, state):
    return np.asarray(adv.get_cell_data(state, "density", g.get_cells()), np.float64)


def _lvl_mass(g, rho):
    lvl = g.mapping.get_refinement_level(g.get_cells())
    return float(np.sum(rho * (1.0 / 8.0) ** lvl))


@pytest.mark.parametrize("levels,kind", [(1, "pallas"), (2, "ml_pallas")])
def test_dispatch_labels_match_jax(levels, kind):
    jg, ja, _, pg, pa, _ = _pair(levels, np.float32, use_pallas="interpret")
    assert ja._flat_kind == kind + "_interpret"
    assert pa._flat_kind == kind
    assert pa.dense is None and ja.dense is None
    # float64: no kernel; the JAX package's f64 form (None on two levels,
    # the "ml" pyramid on three); kernels turned off: the gather path
    assert (dccrg_tpu_torch.Advection(pg, dtype=np.float64)._flat_kind
            == JAdvection(jg, dtype=np.float64)._flat_kind
            == (None if levels == 1 else "ml"))
    assert dccrg_tpu_torch.Advection(pg, dtype=np.float32,
                                     use_kernels=False)._flat_kind is None
    assert JAdvection(jg, dtype=np.float32, use_pallas=False)._flat_kind is None


def test_uniform_and_multi_slot_grids_take_the_gather_path():
    pg = _make(dccrg_tpu_torch, 1, D=3)
    assert dccrg_tpu_torch.Advection(pg, dtype=np.float32)._flat_kind is None
    g = (dccrg_tpu_torch.Grid().set_initial_length((4, 4, 4))
         .set_neighborhood_length(0).set_periodic(True, True, True)
         .set_geometry(dccrg_tpu_torch.CartesianGeometry, start=(0, 0, 0),
                       level_0_cell_length=(0.25, 0.25, 0.25))
         .initialize(device="cpu"))
    a = dccrg_tpu_torch.Advection(g, dtype=np.float32, allow_dense=False)
    assert a.dense is None and a._flat_kind is None


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True)])
def test_f32_flat_run_matches_jax(levels, periodic):
    """``run(7)`` through the flat kernels' twins against the JAX package's
    interpret-mode Pallas run, by cell; level-weighted mass conserved."""
    jg, ja, js, pg, pa, ps = _pair(levels, np.float32, use_pallas="interpret",
                                   periodic=periodic)
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    dt = np.float32(0.3 * ja.max_time_step(js))
    reset_counts()
    a, b = ja.run(js, 7, dt), pa.run(ps, 7, dt)
    name = "flat_amr_run" if levels == 1 else "flat_ml_run"
    assert PLAIN_CALLS[name] == 1 and sum(PLAIN_CALLS.values()) == 1
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    ra, rb = _rho(jg, ja, a), _rho(pg, pa, b)
    assert np.abs(rb - ra).max() <= 2e-6 * np.abs(ra).max()
    m0 = _lvl_mass(pg, _rho(pg, pa, ps))
    assert _lvl_mass(pg, rb) == pytest.approx(m0, rel=1e-6)
    assert np.abs(rb - _rho(pg, pa, ps)).max() > 0


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("D", [1, 3])
def test_f64_gather_step_matches_jax(levels, D):
    """The gather step in float64 against the JAX package's general path,
    with max_time_step and total_mass alongside."""
    jg, ja, js, pg, pa, ps = _pair(levels, np.float64, D=D, use_pallas=False)
    assert pa._flat_kind is None
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    dt = 0.3 * ja.max_time_step(js)
    for _ in range(4):
        js, ps = ja.step(js, dt), pa.step(ps, dt)
    np.testing.assert_allclose(_rho(pg, pa, ps), _rho(jg, ja, js), rtol=1e-12)
    js, ps = ja.run(js, 3, dt), pa.run(ps, 3, dt)
    np.testing.assert_allclose(_rho(pg, pa, ps), _rho(jg, ja, js), rtol=1e-12)
    assert pa.total_mass(ps) == pytest.approx(ja.total_mass(js), rel=1e-12)


@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
@pytest.mark.parametrize("levels", [1, 2])
def test_max_diff_matches_jax(levels, periodic):
    jg, ja, js, pg, pa, ps = _pair(levels, np.float64, D=3, use_pallas=False,
                                   periodic=periodic)
    dt = 0.3 * ja.max_time_step(js)
    js, ps = ja.step(js, dt), pa.step(ps, dt)
    cells = pg.get_cells()
    np.testing.assert_allclose(
        pa.get_cell_data(pa.compute_max_diff(ps, 0.25), "max_diff", cells),
        np.asarray(ja.get_cell_data(ja.compute_max_diff(js, 0.25), "max_diff", cells)),
        rtol=1e-12, atol=1e-14,
    )


def _amr_pair(dense):
    """The reference 2d.cpp flow's grid (test_advection_amr.py's make):
    10x10x1, periodic in x and y, two refinement levels; ``dense`` starts on
    the dense layout, whose first adapt is the first refine."""
    out = []
    for pkg in (dccrg_tpu, dccrg_tpu_torch):
        g = (pkg.Grid().set_initial_length((10, 10, 1))
             .set_maximum_refinement_level(2).set_neighborhood_length(0)
             .set_periodic(True, True, False)
             .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(0.1, 0.1, 0.1)))
        g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=1)) if pkg is dccrg_tpu
             else g.initialize(device="cpu"))
        out.append((g, pkg.models.Advection(g, allow_dense=dense) if pkg is dccrg_tpu
                    else dccrg_tpu_torch.Advection(g, allow_dense=dense)))
    return out


def _same_by_cell(jg, ja, js, pg, pa, ps):
    """Same leaves; velocities (re-derived from the cell centers) exactly,
    densities (remapped after float64 steps) at the gather step's
    rtol=1e-12."""
    np.testing.assert_array_equal(pg.get_cells(), jg.get_cells())
    cells = pg.get_cells()
    for k in ("vx", "vy", "vz"):
        np.testing.assert_array_equal(pa.get_cell_data(ps, k, cells),
                                      np.asarray(ja.get_cell_data(js, k, cells)))
    np.testing.assert_allclose(pa.get_cell_data(ps, "density", cells),
                               np.asarray(ja.get_cell_data(js, "density", cells)),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("dense", [True, False])
def test_adaptation_cycle_matches_jax(dense):
    """check_for_adaptation + adapt_grid, first from the initial grid (dense
    or row layout), then from the refined grid after a few steps: the same
    leaf set and the same state by cell, and mass conserved."""
    (jg, ja), (pg, pa) = _amr_pair(dense)
    assert (pa.dense is not None) == dense == (ja.dense is not None)
    js, ps = ja.initialize_state(), pa.initialize_state()
    for _ in range(2):
        js, ps = ja.check_for_adaptation(js), pa.check_for_adaptation(ps)
        ja, js, jnew, jrem = ja.adapt_grid(js)
        pa, ps, pnew, prem = pa.adapt_grid(ps)
        np.testing.assert_array_equal(pnew, jnew)
        np.testing.assert_array_equal(prem, jrem)
        assert pa.dense is None
        _same_by_cell(jg, ja, js, pg, pa, ps)
        m0 = pa.total_mass(ps)
        dt = 0.25 * pa.max_time_step(ps)
        assert dt == 0.25 * ja.max_time_step(js)
        for _ in range(3):
            js, ps = ja.step(js, dt), pa.step(ps, dt)
        assert pa.total_mass(ps) == pytest.approx(m0, rel=1e-10)
    assert len(pg.get_cells()) > 100
    assert pg.mapping.get_refinement_level(pg.get_cells()).max() == 2


def test_adaptation_conserves_mass():
    """Mass before and after an adapt (inherit / mean remap) is the same."""
    (_, _), (pg, pa) = _amr_pair(False)
    s = pa.initialize_state()
    for _ in range(3):
        s = pa.check_for_adaptation(s)
        m0 = pa.total_mass(s)
        pa, s, _, _ = pa.adapt_grid(s)
        assert pa.total_mass(s) == pytest.approx(m0, rel=1e-10)
        s = pa.step(s, 0.25 * pa.max_time_step(s))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("levels", [1, 2])
def test_gather_path_device_count_invariance(levels, dtype):
    """The gather path at one and three slots gives bitwise-equal densities
    by cell (float32: with kernels off, so both take the gather step)."""
    out = []
    for D in (1, 3):
        g = _make(dccrg_tpu_torch, levels, D)
        a = dccrg_tpu_torch.Advection(g, dtype=dtype, use_kernels=False)
        s = _seed(a, a.initialize_state(), dtype)
        s = g.update_copies_of_remote_neighbors(s)
        dt = 0.3 * a.max_time_step(s)
        s = a.run(s, 5, dt)
        out.append(_rho(g, a, s))
    np.testing.assert_array_equal(out[1], out[0])
