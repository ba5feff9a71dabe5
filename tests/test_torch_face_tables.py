"""Face classification at neighborhood length n >= 1 (the port's
``build_face_tables``): a larger face neighbor listed once for every
neighborhood offset it covers is priced once.  The port's steps at n = 1
and n = 2 are held against the JAX package's n = 0 step on the same leaves
(``initialize(leaf_set=...)``), whose face entries are unique.

Tolerances: the f64 gather step 1e-12 relative and mass 1e-12
(tests/test_torch_advection_amr.py); the flat runs against the gather step
at test_advection_flat_ml.py's 5e-6 (f32) and 1e-11 (f64) of the peak
density; Vlasov f64 1e-12 relative.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu_torch.models import advection as port_advection
from dccrg_tpu_torch.parallel.stencil import StencilTables


def _ball(hood, levels, D=1, periodic=True, leaf_set=None, pkg=dccrg_tpu_torch):
    """An 8^3 grid refined in balls around 0.45 (r < 0.3, then r < 0.15),
    or built from ``leaf_set``."""
    g = (pkg.Grid().set_initial_length((8, 8, 8))
         .set_neighborhood_length(hood)
         .set_periodic(periodic, periodic, periodic)
         .set_maximum_refinement_level(levels)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 8,) * 3))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D), leaf_set=leaf_set)
    g = g.initialize(n_devices=D, device="cpu", leaf_set=leaf_set)
    if leaf_set is None:
        for rad in (0.3, 0.15)[:levels]:
            ids = g.get_cells()
            r = np.linalg.norm(g.geometry.get_center(ids) - 0.45, axis=1)
            lv = g.mapping.get_refinement_level(ids)
            g.refine_completely_many(ids[(r < rad) & (lv == lv.max())])
            g.stop_refining()
    return g


def _state(adv, dtype=np.float64):
    """The rotating hump with seeded vy / vz, so all six faces carry flux."""
    g = adv.grid
    ids = g.get_cells()
    cen = g.geometry.get_center(ids)
    s = adv.initialize_state()
    s = adv.set_cell_data(s, "vz", ids, (0.3 * np.sin(2 * np.pi * cen[:, 2])).astype(dtype))
    s = adv.set_cell_data(s, "vy", ids, (0.2 + 0.1 * np.cos(2 * np.pi * cen[:, 1])).astype(dtype))
    return g.update_copies_of_remote_neighbors(s)


def _jax_twin(pg, ps, levels, D, periodic=True):
    """The JAX package's n = 0 grid on the port grid's leaves, its gather
    model and the port state carried over by cell id."""
    jg = _ball(0, levels, D, periodic, leaf_set=pg.get_cells(), pkg=dccrg_tpu)
    ja = JAdvection(jg, dtype=np.float64, use_pallas=False, allow_boxed=False)
    js = ja.initialize_state()
    ids = pg.get_cells()
    for k in ("density", "vx", "vy", "vz"):
        js = ja.set_cell_data(js, k, ids, pg.get_cell_data(ps, k, ids))
    return jg, ja, ja._exchange(js)


def _rho(g, adv, s):
    return np.asarray(adv.get_cell_data(s, "density", g.get_cells()), np.float64)


@pytest.mark.parametrize("hood,levels,D", [
    (1, 1, 1), (1, 1, 8), (1, 2, 1), (1, 2, 8), (2, 1, 1), (2, 1, 8), (2, 2, 1),
])
def test_step_at_hood_n_matches_jax_hood0(hood, levels, D):
    """Four gather steps at n = 1 / 2 equal the JAX n = 0 step's on the
    same leaves, and the port's own mass is kept."""
    pg = _ball(hood, levels, D)
    pa = dccrg_tpu_torch.Advection(pg, dtype=np.float64, use_kernels=False)
    ps = _state(pa)
    jg, ja, js = _jax_twin(pg, ps, levels, D)
    dt = 0.3 * pa.max_time_step(ps)
    m0 = pa.total_mass(ps)
    for _ in range(4):
        ps, js = pa.step(ps, dt), ja.step(js, dt)
    np.testing.assert_allclose(_rho(pg, pa, ps), _rho(jg, ja, js), rtol=1e-12)
    assert pa.total_mass(ps) == pytest.approx(m0, rel=1e-12)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("hood", [0, 1, 2])
def test_mass_kept_on_periodic_grids(hood, levels):
    """The C1 configuration (ball grid, f64, periodic): mass changes by no
    more than rounding over 8 gather steps at any neighborhood length."""
    g = _ball(hood, levels)
    a = dccrg_tpu_torch.Advection(g, dtype=np.float64, use_kernels=False)
    s = _state(a)
    m0, dt = a.total_mass(s), 0.3 * a.max_time_step(s)
    for _ in range(8):
        s = a.step(s, dt)
    assert a.total_mass(s) == pytest.approx(m0, rel=1e-12)


@pytest.mark.parametrize("levels,dtype,kind,tol", [
    (1, np.float32, "pallas", 5e-6),
    (2, np.float32, "ml_pallas", 5e-6),
    (2, np.float64, "ml", 1e-11),
])
def test_flat_run_matches_step_at_hood1(levels, dtype, kind, tol):
    """The flat run (B5 / B6 twins, or the f64 pyramid form) equals the
    gather step at n = 1: the flat tables classify voxel faces, which do
    not depend on the neighborhood, and the repaired step now agrees."""
    g = _ball(1, levels)
    a = dccrg_tpu_torch.Advection(g, dtype=dtype, allow_boxed=False)
    assert a._flat_kind == kind
    s = _state(a, dtype)
    dt = dtype(0.3 * a.max_time_step(s))
    out = a.run(s, 6, dt)
    st = s
    for _ in range(6):
        st = a.step(st, dt)
    ra, rb = _rho(g, a, out), _rho(g, a, st)
    assert np.abs(ra - rb).max() <= tol * np.abs(rb).max()


@pytest.mark.parametrize("hood,D", [(1, 1), (1, 3), (2, 1)])
def test_vlasov_gather_step_at_hood_n_matches_hood0(hood, D):
    """The Vlasov gather step shares the face tables: at n = 1 / 2 it
    equals the port's own n = 0 step on the same leaves, and keeps mass."""
    g1 = _ball(hood, 1, D)
    g0 = _ball(0, 1, D, leaf_set=g1.get_cells())
    out = []
    for g in (g1, g0):
        v = dccrg_tpu_torch.Vlasov(g, nv=3, dtype=np.float64)
        assert v.info is None
        s = v.initialize_state()
        m0 = v.total_mass(s)
        dt = 0.5 * v.max_time_step()
        for _ in range(3):
            s = v.step(s, dt)
        assert v.total_mass(s) == pytest.approx(m0, rel=1e-12)
        out.append(np.asarray(g.get_cell_data(s, "f", g1.get_cells())))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-12, atol=1e-14)


def _unrepaired_face_tables(grid, tables):
    """The face classification before the repair, as the port and the JAX
    package had it (every valid entry classified, every face entry priced),
    in its dense [D, R, K] form: the reference for byte identity."""
    from dccrg_tpu_torch.core.neighbors import face_directions

    epoch = grid.epoch
    hood = epoch.hoods[None]
    off = hood.nbr_offset.astype(np.int64)
    nlen = hood.nbr_len.astype(np.int64)
    clen = epoch.cell_len.astype(np.int64)[..., None]
    direction = np.where(hood.nbr_valid, face_directions(off, clen, nlen), 0).astype(np.int8)
    length = tables.length.cpu().numpy()
    vol = length.prod(axis=-1)
    nb = hood.nbr_rows
    D, R, K = nb.shape
    nlen_phys = length[np.arange(D)[:, None, None], nb]
    ai = np.maximum(np.abs(direction).astype(np.int64) - 1, 0)
    other = np.stack([(ai + 1) % 3, (ai + 2) % 3], axis=-1)
    own = np.broadcast_to(length[:, :, None], nlen_phys.shape)
    cell_area = np.take_along_axis(own, other, axis=-1).prod(axis=-1)
    nbr_area = np.take_along_axis(nlen_phys, other, axis=-1).prod(axis=-1)
    return {
        "face_dir": direction,
        "min_area": np.where(direction != 0, np.minimum(cell_area, nbr_area), 0.0),
        "cell_axis_len": np.take_along_axis(own, ai[..., None], axis=-1)[..., 0],
        "nbr_axis_len": np.take_along_axis(nlen_phys, ai[..., None], axis=-1)[..., 0],
        "inv_volume": np.where(vol > 0, 1.0 / vol, 0.0),
    }


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("levels", [1, 2])
def test_hood0_tables_byte_identical_to_unrepaired(levels, periodic, D):
    """At n = 0 every face entry is unique: the tables are the unrepaired
    classification's byte for byte.  At n = 1 the repair only drops
    entries (the repeated coarse faces), and every kept entry's factors
    are the unrepaired ones."""
    for hood in (0, 1):
        g = _ball(hood, levels, D, periodic)
        t = StencilTables(g, None, with_geometry=True)
        fixed, dev = port_advection.build_face_tables(g, None, t, np.float64)
        raw = _unrepaired_face_tables(g, t)
        assert sorted(fixed) == sorted(raw)
        assert dev["face_dir"].numpy().tobytes() == fixed["face_dir"].tobytes()
        if hood == 0:
            for k in raw:
                assert fixed[k].dtype == raw[k].dtype and fixed[k].shape == raw[k].shape, k
                assert fixed[k].tobytes() == np.ascontiguousarray(raw[k]).tobytes(), k
            continue
        kept = fixed["face_dir"] != 0
        dropped = (raw["face_dir"] != 0) & ~kept
        assert dropped.any() and not (kept & (raw["face_dir"] == 0)).any()
        for k in ("face_dir", "min_area", "cell_axis_len", "nbr_axis_len"):
            np.testing.assert_array_equal(fixed[k][kept], raw[k][kept])
        assert (fixed["min_area"][dropped] == 0).all()
        np.testing.assert_array_equal(fixed["inv_volume"], raw["inv_volume"])
