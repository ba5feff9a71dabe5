"""The port's flat XLA forms in plain torch — the z-slab ``sharded``
two-level run and the multi-level ``ml`` pyramid run (``ops/flat_amr.py``)
— against the JAX package's, on the CPU (tests/test_advection_flat.py and
tests/test_advection_flat_ml.py mirrored; their lane-padding cases test a
TPU-only layout the port does not have).

Tolerances are those files' own: flat against boxed 2e-6 of the peak and
level-weighted mass rel 1e-6 (test_advection_flat.py:63-72, :155); one slot
against four 2e-7 / 1e-9 (:195); the adaptation cycle's mass 1e-5 (:214);
ml against the gather path 1e-11 of the peak and mass 1e-12
(test_advection_flat_ml.py:68-70), f32 5e-6, the dispatch case 5e-11.  The
port's forms against the JAX package's: 2e-7 / 1e-9 in f32 and the f64
gather tolerance 1e-12 in f64.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection


def _kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def make(pkg, periodic=(True, True, True), n=8, n_dev=1):
    """test_advection_flat.py::make: the 8^3 ball r < 0.28 around 0.45."""
    g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(*periodic).set_maximum_refinement_level(1)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(**_kw(pkg, n_dev)))
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.45, axis=1) < 0.28])
    g.stop_refining()
    return g


def ball_grid(pkg, n_dev, n=8, periodic=(True, True, True)):
    """test_advection_flat_ml.py::ball_grid: three levels, non-power-of-two
    cell lengths."""
    g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(*periodic).set_maximum_refinement_level(2)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(0.1, 0.07, 0.13))
         .initialize(**_kw(pkg, n_dev)))
    for rad in (0.3, 0.15):
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        lv = g.mapping.get_refinement_level(ids)
        g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
        g.stop_refining()
    assert g.mapping.get_refinement_level(g.get_cells()).max() == 2
    return g


def seeded_state(adv, g, dtype=np.float32):
    s0 = adv.initialize_state()
    ids = g.get_cells()
    cen = g.geometry.get_center(ids)
    s0 = adv.set_cell_data(s0, "vz", ids, (0.3 * np.sin(2 * np.pi * cen[:, 2])).astype(dtype))
    s0 = adv.set_cell_data(s0, "vy", ids, (0.2 + 0.1 * np.cos(2 * np.pi * cen[:, 1])).astype(dtype))
    return g.update_copies_of_remote_neighbors(s0), ids


def lvl_mass(g, ids, rho):
    lvl = g.mapping.get_refinement_level(ids)
    return float(np.sum(np.asarray(rho, np.float64) * (1.0 / 8.0) ** lvl))


def _rho(g, adv, s, ids):
    return np.asarray(adv.get_cell_data(s, "density", ids), np.float64)


# -------------------------------------------- tests/test_advection_flat.py


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True)])
def test_flat_matches_boxed(periodic):
    """B5's twin (``"pallas"``) against the port's boxed passes; both against
    the JAX package's interpret kernel."""
    g = make(dccrg_tpu_torch, periodic)
    flat = dccrg_tpu_torch.Advection(g, dtype=np.float32, allow_boxed=False)
    boxed = dccrg_tpu_torch.Advection(g, dtype=np.float32, use_kernels=False)
    assert flat._flat_kind == "pallas" and boxed._flat_run is None
    s0, ids = seeded_state(flat, g)
    dt = np.float32(0.3 * flat.max_time_step(s0))
    ra = _rho(g, flat, flat.run(s0, 7, dt), ids)
    rb = _rho(g, boxed, boxed._boxed_run(s0, 7, dt), ids)
    assert np.abs(ra - rb).max() <= 2e-6 * np.abs(rb).max()
    m0 = lvl_mass(g, ids, flat.get_cell_data(s0, "density", ids))
    assert lvl_mass(g, ids, ra) == pytest.approx(m0, rel=1e-6)
    jg = make(dccrg_tpu, periodic)
    ja = JAdvection(jg, dtype=np.float32, use_pallas="interpret")
    js, _ = seeded_state(ja, jg)
    rj = _rho(jg, ja, ja.run(js, 7, dt), ids)
    assert np.abs(ra - rj).max() <= 2e-6 * np.abs(rj).max()


def test_flat_open_boundary_differs_from_periodic():
    def run(periodic):
        g = make(dccrg_tpu_torch, periodic)
        adv = dccrg_tpu_torch.Advection(g, dtype=np.float32, allow_boxed=False)
        s0, ids = seeded_state(adv, g)
        return _rho(g, adv, adv.run(s0, 7, np.float32(0.3 * adv.max_time_step(s0))), ids)

    assert np.abs(run((True, True, True)) - run((True, False, True))).max() > 1e-4


def test_flat_gating():
    """f64 on two levels and one slot has no flat form (the gather step
    takes it); uniform grids take the dense path."""
    g = make(dccrg_tpu_torch)
    assert dccrg_tpu_torch.Advection(g)._flat_run is None
    gu = (dccrg_tpu_torch.Grid().set_initial_length((8, 8, 8))
          .set_neighborhood_length(0).set_periodic(True, True, True)
          .set_geometry(dccrg_tpu_torch.CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1 / 8,) * 3)
          .initialize(device="cpu"))
    assert dccrg_tpu_torch.Advection(gu, dtype=np.float32).dense is not None


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True)])
def test_flat_sharded_matches_boxed(n_dev, periodic):
    """The z-slab sharded form (two ringed planes a step, collective-free
    coarse pool) matches the boxed passes, keeps mass, and equals the JAX
    package's sharded form; ``use_kernels=False`` opts out of it."""
    g = make(dccrg_tpu_torch, periodic, n_dev=n_dev)
    flat = dccrg_tpu_torch.Advection(g, dtype=np.float32)
    boxed = dccrg_tpu_torch.Advection(g, dtype=np.float32, use_kernels=False)
    assert flat._flat_kind == "sharded" and not flat._prefer_boxed
    assert boxed._flat_run is None and boxed._boxed_run is not None
    s0, ids = seeded_state(flat, g)
    dt = np.float32(0.3 * flat.max_time_step(s0))
    ra = _rho(g, flat, flat.run(s0, 7, dt), ids)
    rb = _rho(g, boxed, boxed._boxed_run(s0, 7, dt), ids)
    assert np.abs(ra - rb).max() / np.abs(rb).max() < 2e-6
    m0 = lvl_mass(g, ids, flat.get_cell_data(s0, "density", ids))
    assert lvl_mass(g, ids, ra) == pytest.approx(m0, rel=1e-6)
    jg = make(dccrg_tpu, periodic, n_dev=n_dev)
    ja = JAdvection(jg, dtype=np.float32)
    assert ja._flat_kind == "sharded"
    rj = _rho(jg, ja, ja.run(_carry_back(jg, ja, g, s0), 7, dt), ids)
    np.testing.assert_allclose(ra, rj, rtol=2e-7, atol=1e-9)


def _carry_back(jg, ja, pg, ps):
    """A port state as a JAX state, by cell id."""
    ids = pg.get_cells()
    js = ja.initialize_state()
    for k in ("density", "vx", "vy", "vz"):
        js = jg.set_cell_data(js, k, ids, pg.get_cell_data(ps, k, ids))
    return jg.update_copies_of_remote_neighbors(js)


def test_flat_sharded_device_count_invariant():
    """One slot (B5's twin) and four (the sharded form) agree."""
    out = []
    for n_dev in (1, 4):
        g = make(dccrg_tpu_torch, n_dev=n_dev)
        adv = dccrg_tpu_torch.Advection(g, dtype=np.float32, allow_boxed=False)
        assert adv._flat_kind == ("pallas" if n_dev == 1 else "sharded")
        s0, ids = seeded_state(adv, g)
        out.append(_rho(g, adv, adv.run(s0, 7, np.float32(0.3 * adv.max_time_step(s0))), ids))
    np.testing.assert_allclose(out[0], out[1], rtol=2e-7, atol=1e-9)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_flat_run_feeds_adaptation_cycle(n_dev):
    """A flat run's state drives check_for_adaptation / adapt_grid, and the
    new model rebuilds its fast paths for the adapted grid."""
    g = make(dccrg_tpu_torch, n_dev=n_dev)
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float32)
    assert adv._flat_run is not None
    s0, ids = seeded_state(adv, g)
    state = adv.run(s0, 5, np.float32(0.3 * adv.max_time_step(s0)))
    m0 = lvl_mass(g, ids, adv.get_cell_data(state, "density", ids))
    adv.check_for_adaptation(state)
    adv2, state2, _, _ = adv.adapt_grid(state)
    ids2 = adv2.grid.get_cells()
    m1 = lvl_mass(adv2.grid, ids2, adv2.get_cell_data(state2, "density", ids2))
    assert m1 == pytest.approx(m0, rel=1e-5)
    assert adv2._flat_run is not None or adv2._boxed_run is not None
    out = adv2.run(state2, 3, np.float32(0.3 * adv2.max_time_step(state2)))
    m2 = lvl_mass(adv2.grid, ids2, adv2.get_cell_data(out, "density", ids2))
    assert m2 == pytest.approx(m1, rel=1e-5)


# ----------------------------------------- tests/test_advection_flat_ml.py


@pytest.mark.parametrize("n_dev", [1, 8])
def test_ml_flat_matches_general_path(n_dev):
    """The f64 ``ml`` form against the gather path (1e-11, mass 1e-12) and
    against the JAX package's ``ml`` form (1e-12)."""
    g = ball_grid(dccrg_tpu_torch, n_dev)
    ids = np.sort(g.get_cells())
    adv_ml = dccrg_tpu_torch.Advection(g, dtype=np.float64)
    assert adv_ml._flat_kind == "ml"
    adv_gen = dccrg_tpu_torch.Advection(g, dtype=np.float64, use_kernels=False)
    s = adv_gen.initialize_state()
    dt = 0.3 * adv_gen.max_time_step(s)
    out = adv_ml._flat_run.run(s, 10, dt)
    st = s
    for _ in range(10):
        st = adv_gen.step(st, dt)
    a, b = _rho(g, adv_ml, out, ids), _rho(g, adv_gen, st, ids)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-11
    vol = np.prod(g.geometry.get_length(ids), axis=-1)
    np.testing.assert_allclose((a * vol).sum(), (b * vol).sum(), rtol=1e-12)
    jg = ball_grid(dccrg_tpu, n_dev)
    ja = JAdvection(jg, dtype=np.float64)
    assert ja._flat_kind == "ml"
    np.testing.assert_allclose(a, _rho(jg, ja, ja._flat_run(ja.initialize_state(), 10, dt), ids),
                               rtol=1e-12, atol=1e-14)


def test_ml_flat_nonperiodic_boundaries():
    g = ball_grid(dccrg_tpu_torch, 1, periodic=(False, False, False))
    ids = np.sort(g.get_cells())
    adv_ml = dccrg_tpu_torch.Advection(g, dtype=np.float64)
    assert adv_ml._flat_kind == "ml"
    adv_gen = dccrg_tpu_torch.Advection(g, dtype=np.float64, use_kernels=False)
    rho = np.random.default_rng(0).uniform(1.0, 2.0, len(ids))
    s = adv_gen.set_cell_data(adv_gen.initialize_state(), "density", ids, rho)
    s = g.update_copies_of_remote_neighbors(s)
    dt = 0.3 * adv_gen.max_time_step(s)
    out = adv_ml._flat_run.run(s, 8, dt)
    for _ in range(8):
        s = adv_gen.step(s, dt)
    a, b = _rho(g, adv_ml, out, ids), _rho(g, adv_gen, s, ids)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-11


@pytest.mark.parametrize("form", ["ml_pallas", "ml"])
def test_ml_f32_forms_match_general_path(form):
    """B6's twin (``ml_pallas``) and the f32 ``ml`` pyramid form (the one a
    grid takes past B6's fit rule or on several slots) against the gather
    path, 5e-6."""
    g = ball_grid(dccrg_tpu_torch, 1 if form == "ml_pallas" else 2)
    ids = np.sort(g.get_cells())
    adv_k = dccrg_tpu_torch.Advection(g, dtype=np.float32, allow_boxed=False)
    assert adv_k._flat_kind == form
    adv_gen = dccrg_tpu_torch.Advection(g, dtype=np.float32, use_kernels=False)
    s = adv_gen.initialize_state()
    dt = np.float32(0.3 * adv_gen.max_time_step(s))
    out = adv_k._flat_run.run(s, 6, dt)
    for _ in range(6):
        s = adv_gen.step(s, dt)
    a, b = _rho(g, adv_k, out, ids), _rho(g, adv_gen, s, ids)
    assert np.abs(a - b).max() / np.abs(b).max() < 5e-6


def test_two_level_grids_keep_the_tuned_paths():
    g = (dccrg_tpu_torch.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(dccrg_tpu_torch.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 8,) * 3)
         .initialize(n_devices=8, device="cpu"))
    g.refine_completely(1)
    g.stop_refining()
    assert dccrg_tpu_torch.Advection(g, dtype=np.float32)._flat_kind == "sharded"


def test_ml_run_dispatch_and_fallback_shape():
    """``run`` takes the ml form (or boxed by the cost edge) with the same
    physics as the gather step (5e-11)."""
    g = ball_grid(dccrg_tpu_torch, 1, n=6)
    ids = np.sort(g.get_cells())
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float64)
    assert adv._flat_kind == "ml"
    s = adv.initialize_state()
    dt = 0.3 * adv.max_time_step(s)
    out = adv.run(s, 6, dt)
    gen = dccrg_tpu_torch.Advection(g, dtype=np.float64, use_kernels=False)
    s2 = s
    for _ in range(6):
        s2 = gen.step(s2, dt)
    a, b = _rho(g, adv, out, ids), _rho(g, gen, s2, ids)
    assert np.abs(a - b).max() / np.abs(b).max() < 5e-11
