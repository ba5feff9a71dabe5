"""The Poisson slice end to end: the port's ``Poisson`` (on the CPU) against
the JAX package's, from identical inputs, compared by cell id; plus the
port-internal checks of tests/test_poisson.py and test_poisson_rolled.py
(flat and rolled operators against the gather oracle, the dense-matrix
oracle, device-count invariance, gating, restarts) and the stretched
geometry.

Tolerances are the JAX tests' own: factor tables exact; f64 solves rtol
1e-10 / atol 1e-12 with iterations within 1 (test_flat_path_matches_gather
_refined); the operator against the dense matrix at atol 1e-12
(test_refined_operator_matches_oracle); flat against gather rtol 1e-10 /
atol 1e-12 refined, 1e-9 / 1e-11 with roles; rolled against gather 1e-12
of the peak (test_poisson_rolled.py); 1 vs 4 slots rtol 1e-11 / atol
1e-14 (test_flat_path_multi_device_invariant); the float32 whole-solve path
at test_fused_bicg_matches_xla_flat's; Advection's f64 gather step at
1e-13 by cell.
"""
import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu.models import Poisson as JPoisson
from dccrg_tpu_torch.convert import rows_state_from_numpy
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
from test_poisson import dense_matrix_oracle

TP = dccrg_tpu_torch.Poisson


def _grid(pkg, length, max_ref=0, periodic=(True, True, True), cell=None, D=1,
          refine=()):
    """test_poisson.py's make_grid, then each entry of ``refine`` (a
    function of the grid giving the cells to refine) in turn."""
    n = np.asarray(length)
    g = (pkg.Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(0).set_periodic(*periodic)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=cell or tuple(1.0 / n)))
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    for pick in refine:
        for cid in pick(g):
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def _ball(center, rad):
    def pick(g):
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - center, axis=1)
        lv = g.mapping.get_refinement_level(ids)
        return ids[(r < rad) & (lv == lv.max())]
    return pick


def _pair(*args, **kw):
    return _grid(dccrg_tpu, *args, **kw), _grid(dccrg_tpu_torch, *args, **kw)


def _sol(g, state, ids=None):
    ids = g.get_cells() if ids is None else ids
    return np.asarray(g.get_cell_data(state, "solution", ids), np.float64)


def _rhs(g):
    c = g.geometry.get_center(g.get_cells())
    return np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])


def _roles_6x4(g):
    """test_boundary_and_skip_match_dense_oracle's roles."""
    cells = g.get_cells()
    ctr = g.geometry.get_center(cells)
    skip = cells[(ctr[:, 0] > 5 / 6) & (ctr[:, 1] > 3 / 4)]
    bnd = cells[ctr[:, 0] < 1 / 6]
    solve = cells[~np.isin(cells, skip) & ~np.isin(cells, bnd)]
    return dict(solve_cells=solve, skip_cells=skip), bnd


# ------------------------------------------------------------ factors


@pytest.mark.parametrize("D", [1, 3])
def test_factor_tables_match_jax(D):
    """Leaf factors, [D, R, K] multipliers, diagonal rows and solve mask,
    exactly, on a refined grid with all three roles."""
    jg, pg = _pair((8, 8, 8), 1, periodic=(True, False, True), D=D,
                   refine=[_ball(0.45, 0.3)])
    cells = jg.get_cells()
    rng = np.random.default_rng(0)
    skip = rng.choice(cells, 40, replace=False)
    solve = np.setdiff1d(cells, rng.choice(cells, 60, replace=False))
    kw = dict(solve_cells=solve, skip_cells=skip, allow_flat=False,
              allow_rolled=False)
    jp, pp = JPoisson(jg, **kw), TP(pg, **kw)
    for a in ("_f_pos_leaf", "_f_neg_leaf", "_scaling_leaf", "_cell_type_leaf",
              "_scaling_np"):
        np.testing.assert_array_equal(getattr(pp, a), getattr(jp, a), err_msg=a)
    for i in range(2):
        np.testing.assert_array_equal(pp._mult_np[i], jp._mult_np[i])
        np.testing.assert_array_equal(pp._mult_table(i).numpy(), np.asarray(jp._mult_table(i)))
    np.testing.assert_array_equal(pp._solve_mask.numpy(), np.asarray(jp._solve_mask))


# ------------------------------------------------------ solves vs JAX


def _solve_pair(jg, pg, kw, rhs, ub=None, bnd=None, **solve_kw):
    jp, pp = JPoisson(jg, **kw), TP(pg, **kw)
    js = jp.initialize_state(rhs)
    if ub is not None:
        js = jg.set_cell_data(js, "solution", bnd, ub)
    ps = rows_state_from_numpy(pg, {k: np.asarray(v) for k, v in js.items()},
                               jg.epoch.cell_ids)
    jo, jr, ji = jp.solve(js, **solve_kw)
    po, pr, pi = pp.solve(ps, **solve_kw)
    return jp, pp, (jo, jr, ji), (po, pr, pi)


@pytest.mark.parametrize("space", ["gather", "rolled", "flat"])
def test_f64_solve_matches_jax(space):
    """The three operator spaces on test_poisson_rolled.py's 8^3 refined
    ball, f64."""
    jg, pg = _pair((8, 8, 8), 1, refine=[_ball(0.5, 0.3)])
    kw = {"gather": dict(allow_flat=False, allow_rolled=False),
          "rolled": dict(allow_flat=False, allow_rolled=True),
          "flat": dict(allow_rolled=False)}[space]
    jp, pp, (jo, jr, ji), (po, pr, pi) = _solve_pair(
        jg, pg, kw, _rhs(jg), max_iterations=200, stop_residual=1e-10)
    assert (pp._flat is not None, pp._rolled is not None) == (
        space == "flat", space == "rolled")
    assert (jp._flat is not None, jp._rolled is not None) == (
        space == "flat", space == "rolled")
    assert abs(pi - ji) <= 1
    np.testing.assert_allclose(_sol(pg, po), _sol(jg, jo), rtol=1e-10, atol=1e-12)
    assert pr == pytest.approx(jr, rel=1e-6)
    assert pp.residual(po) == pytest.approx(jp.residual(jo), rel=1e-6)


def test_f64_gather_solve_with_roles_matches_jax():
    """test_boundary_and_skip_match_dense_oracle's grid: boundary cells
    keep their values, skipped cells stay 0."""
    jg, pg = _pair((6, 4, 1), periodic=(False, False, False),
                   cell=(1 / 6, 1 / 4, 1.0))
    roles, bnd = _roles_6x4(jg)
    rng = np.random.default_rng(4)
    rhs, ub = rng.standard_normal(len(jg.get_cells())), rng.standard_normal(len(bnd))
    jp, pp, (jo, jr, ji), (po, pr, pi) = _solve_pair(
        jg, pg, dict(allow_flat=False, **roles), rhs, ub, bnd,
        max_iterations=1000, stop_residual=1e-13)
    assert abs(pi - ji) <= 1
    sol = _sol(pg, po)
    np.testing.assert_allclose(sol, _sol(jg, jo), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(_sol(pg, po, bnd), ub)
    np.testing.assert_array_equal(_sol(pg, po, roles["skip_cells"]), 0.0)


def test_f32_fast_path_matches_jax_interpret():
    """The whole-solve path (its twin here) against the JAX package's
    Pallas kernel in interpret mode, through both models' solve()."""
    jg, pg = _pair((12, 12, 12), 1, refine=[_ball(0.5, 0.3)])
    rhs = np.random.default_rng(5).standard_normal(len(jg.get_cells()))
    jp = JPoisson(jg, dtype=np.float32, use_pallas="interpret")
    pp = TP(pg, dtype=np.float32)
    assert jp._solve_fast is not None and pp._solve_fast is not None
    js, ps = jp.initialize_state(rhs), pp.initialize_state(rhs)
    reset_counts()
    po, pr, pi = pp.solve(ps, max_iterations=60, stop_residual=1e-5)
    assert PLAIN_CALLS["bicg_solve"] == 1 and sum(LAUNCHES.values()) == 0
    jo, jr, ji = jp.solve(js, max_iterations=60, stop_residual=1e-5)
    assert abs(pi - ji) <= 1 and pi == ji
    assert pr == pytest.approx(jr, rel=1e-5)
    np.testing.assert_allclose(_sol(pg, po), _sol(jg, jo), rtol=1e-5, atol=1e-7)
    assert po["solution"].dtype == torch.float32


# ------------------------------------------------------ port-internal


def test_refined_operator_matches_dense_oracle():
    """A·v and Aᵀ·v of the gather, rolled and flat operators against the
    independently built dense matrix (test_poisson.py's oracle)."""
    g = _grid(dccrg_tpu_torch, (4, 4, 1), 1, periodic=(True, True, False),
              refine=[lambda g: [6, 11]])
    cells = g.get_cells()
    A = dense_matrix_oracle(g)
    pg = TP(g, allow_flat=False, allow_rolled=False)
    pr = TP(g, allow_flat=False, allow_rolled=True)
    pf = TP(g)
    assert pr._rolled is not None and pf._flat is not None
    rng = np.random.default_rng(2)
    for _ in range(2):
        v = rng.standard_normal(len(cells))
        x = g.set_cell_data(g.new_state(pg.spec), "solution", cells, v)["solution"]
        fwd, rev, vox, wb, _ = pf._flat
        for i, M in ((0, A), (1, A.T)):
            outs = [pg._apply(x, pg._mult_tables()[i])[0], pr._rolled[i](x),
                    wb((fwd, rev)[i](vox(x)))]
            for out in outs:
                got = g.get_cell_data({"x": out}, "x", cells)
                np.testing.assert_allclose(got, M @ v, atol=1e-12)


@pytest.mark.parametrize("periodic,D", [((True, True, True), 1),
                                        ((False, True, False), 1),
                                        ((True, True, True), 2)])
def test_rolled_matches_gather_operator(periodic, D):
    g = _grid(dccrg_tpu_torch, (8, 8, 8), 1, periodic=periodic, D=D,
              refine=[_ball(0.5, 0.3)])
    pr = TP(g, allow_flat=False, allow_rolled=True)
    pg = TP(g, allow_flat=False, allow_rolled=False)
    assert pr._rolled is not None and pg._rolled is None
    ids = g.get_cells()
    local = pg.tables.local_mask
    rng = np.random.default_rng(3)
    for _ in range(2):
        v = rng.standard_normal(len(ids))
        x = g.set_cell_data(g.new_state(pg.spec), "solution", ids, v)["solution"]
        for i in range(2):
            a_g = pg._apply(x, pg._mult_tables()[i])[0]
            a_r = pr._rolled[i](x)
            d = (a_g - a_r)[local].abs().max()
            assert float(d) < 1e-12 * max(1.0, float(a_g[local].abs().max()))


def test_flat_matches_gather_uniform_with_roles():
    g = _grid(dccrg_tpu_torch, (6, 6, 6), periodic=(False, False, False))
    cells = g.get_cells()
    ctr = g.geometry.get_center(cells)
    skip = cells[np.linalg.norm(ctr - 0.5, axis=1) < 0.17]
    on_face = (ctr < 1.0 / 6).any(axis=1) | (ctr > 5.0 / 6).any(axis=1)
    bnd = cells[on_face & ~np.isin(cells, skip)]
    solve = cells[~on_face & ~np.isin(cells, skip)]
    kw = dict(solve_cells=solve, skip_cells=skip)
    p_flat = TP(g, **kw)
    p_gather = TP(g, allow_flat=False, allow_rolled=False, **kw)
    assert p_flat._flat is not None and p_gather._flat is None
    rng = np.random.default_rng(3)
    s0 = g.set_cell_data(g.new_state(p_flat.spec), "rhs", cells,
                         rng.standard_normal(len(cells)))
    s0 = g.set_cell_data(s0, "solution", bnd, rng.standard_normal(len(bnd)))
    out_f, _, it_f = p_flat.solve(s0, max_iterations=150, stop_residual=1e-12)
    out_g, _, it_g = p_gather.solve(s0, max_iterations=150, stop_residual=1e-12)
    assert abs(it_f - it_g) <= 1
    np.testing.assert_allclose(_sol(g, out_f), _sol(g, out_g), rtol=1e-9, atol=1e-11)


def test_three_level_flat_matches_gather():
    """Three levels: the flat operator's reshape pyramid equals the gather
    operator to f64 roundoff, and the whole-solve kernel stays off."""
    g = _grid(dccrg_tpu_torch, (8, 8, 8), 2, refine=[_ball(0.5, 0.3), _ball(0.5, 0.2)])
    p_flat = TP(g)
    assert p_flat._flat_tables["vl"] == 2 and p_flat._solve_fast is None
    assert TP(g, dtype=np.float32)._solve_fast is None
    p_gather = TP(g, allow_flat=False, allow_rolled=False)
    ids = g.get_cells()
    v = np.random.default_rng(1).standard_normal(len(ids))
    x = g.set_cell_data(g.new_state(p_flat.spec), "solution", ids, v)["solution"]
    fwd, rev, vox, wb, _ = p_flat._flat
    for i, fl in enumerate((fwd, rev)):
        a_g = g.get_cell_data({"x": p_gather._apply(x, p_gather._mult_tables()[i])[0]}, "x", ids)
        a_f = g.get_cell_data({"x": wb(fl(vox(x)))}, "x", ids)
        np.testing.assert_allclose(a_f, a_g, rtol=1e-13, atol=1e-13)


def test_device_count_invariance():
    """test_device_count_invariance (gather, 1 vs 4 slots) and
    test_flat_path_multi_device_invariant (flat, z-slab slots)."""
    sols = []
    for D in (1, 4):
        g = _grid(dccrg_tpu_torch, (8, 4, 1), periodic=(True, True, False), D=D)
        p = TP(g)
        x = g.geometry.get_center(g.get_cells())[:, 0]
        s, _, _ = p.solve(p.initialize_state(np.cos(2 * np.pi * x)),
                          max_iterations=500, stop_residual=1e-13)
        sol = _sol(g, s)
        sols.append(sol - sol.mean())
    np.testing.assert_allclose(sols[0], sols[1], atol=1e-10)

    out = []
    for D in (1, 4):
        g = _grid(dccrg_tpu_torch, (8, 8, 8), 1, D=D, refine=[_ball(0.45, 0.3)])
        p = TP(g)
        assert p._flat is not None and p._flat_tables["n_devices"] == D
        s, _, it = p.solve(p.initialize_state(_rhs(g)), max_iterations=100,
                           stop_residual=1e-11)
        out.append((_sol(g, s), it))
    assert abs(out[0][1] - out[1][1]) <= 1
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-11, atol=1e-14)


def test_fast_solver_gating():
    """f64, kernels off, several slots and three levels (above) stay off the
    whole-solve kernel; f32 on one slot takes it."""
    g = _grid(dccrg_tpu_torch, (8, 8, 8))
    assert TP(g)._solve_fast is None
    assert TP(g, dtype=np.float32, use_kernels=False)._solve_fast is None
    assert TP(g, dtype=np.float32)._solve_fast is not None
    g4 = _grid(dccrg_tpu_torch, (8, 8, 8), D=4)
    p4 = TP(g4, dtype=np.float32)
    assert p4._flat is not None and p4._solve_fast is None
    # the rolled default follows the grid's device: off on the CPU
    assert TP(g, allow_flat=False)._rolled is None


def test_solve_restarts_recover_breakdown():
    """test_solve_restarts_recover_breakdown's seed-529 configuration: the
    single trajectory stops far from the target by the semi-convergence
    rule; restarts from the best solution reach it."""
    rng = np.random.default_rng(529)
    n = int(rng.choice([4, 6, 8]))
    D = int(rng.choice([1, 2, 4]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    maxref = int(rng.integers(0, 2))
    g = _grid(dccrg_tpu_torch, (n, n, n), maxref, periodic=periodic, D=D)
    ids = g.get_cells()
    k = max(1, int(0.2 * len(ids)))
    for cid in rng.choice(ids, size=k, replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    cells = g.get_cells()
    rhs = rng.standard_normal(len(cells))
    rng.integers(0, 3)
    p = TP(g, skip_cells=rng.choice(cells, size=len(cells) // 8 + 1, replace=False))
    assert p._flat is not None
    s0 = g.set_cell_data(g.new_state(p.spec), "rhs", cells, rhs - rhs.mean())
    _, res1, it1 = p.solve(s0, max_iterations=60, stop_residual=1e-11)
    # where the trajectory breaks down depends on the dots' rounding (the
    # JAX package's stops near 1e-5, this one's below 1e-7): it stops early,
    # far above the target
    assert it1 < 60 and res1 > 1e-9
    _, res, it = p.solve(s0, max_iterations=60, stop_residual=1e-11, restarts=4)
    assert res <= 1e-9 and it > it1


# ------------------------------------------------------ stretched geometry


def _stretched(pkg, nx=24):
    """test_stretched_grid.py's make_stretched: geometric x, uniform y/z."""
    bx = np.cumsum(np.concatenate([[0.0], 1.06 ** np.arange(nx)]))
    bx /= bx[-1]
    g = (pkg.Grid().set_initial_length((nx, 6, 1)).set_neighborhood_length(0)
         .set_periodic(False, True, False)
         .set_geometry(pkg.StretchedCartesianGeometry,
                       coordinates=(bx, np.linspace(0.0, 1.0, 7), np.array([0.0, 1.0]))))
    return (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=1)) if pkg is dccrg_tpu
            else g.initialize(device="cpu"))


def test_stretched_geometry_matches_jax():
    jg, pg = _stretched(dccrg_tpu, 12), _stretched(dccrg_tpu_torch, 12)
    cells = pg.get_cells()
    assert pg.geometry.uniform_level0 is False
    np.testing.assert_array_equal(pg.geometry.get_center(cells), jg.geometry.get_center(cells))
    np.testing.assert_array_equal(pg.geometry.get_length(cells), jg.geometry.get_length(cells))
    pts = np.random.default_rng(0).uniform(-0.2, 1.2, (50, 3))
    np.testing.assert_array_equal(pg.geometry.get_cell(0, pts), jg.geometry.get_cell(0, pts))


def test_poisson_on_stretched_grid():
    """test_poisson_on_stretched_grid's analytic check: the variable-spacing
    factors reproduce u = cos(pi x) (zero flux at the walls).  The flat
    layout refuses stretched geometry, so the gather operator solves."""
    g = _stretched(dccrg_tpu_torch)
    p = TP(g)
    assert p._flat is None and p._rolled is None
    x = g.geometry.get_center(g.get_cells())[:, 0]
    rhs = -np.pi ** 2 * np.cos(np.pi * x)
    state, res, _ = p.solve(p.initialize_state(rhs), max_iterations=3000,
                            stop_residual=1e-12)
    sol = _sol(g, state)
    expect = np.cos(np.pi * x)
    np.testing.assert_allclose(sol - sol.mean() + expect.mean(), expect, atol=5e-2)
    assert res < 0.05 * np.linalg.norm(rhs)
    # the rolled operator engages there too (test_rolled_engages_on_
    # stretched_geometry) and is the gather operator
    pr = TP(g, allow_rolled=True)
    assert pr._flat is None and pr._rolled is not None
    v = np.random.default_rng(0).standard_normal(len(x))
    xs = g.set_cell_data(g.new_state(p.spec), "solution", g.get_cells(), v)["solution"]
    for i in range(2):
        a_g = p._apply(xs, p._mult_tables()[i])[0]
        assert float((a_g - pr._rolled[i](xs)).abs().max()) < 1e-12 * max(
            1.0, float(a_g.abs().max()))


def test_advection_on_stretched_grid_matches_jax():
    """test_advection_on_stretched_geometry: no dense path; the f64 gather
    run against the JAX package's by cell at 1e-13, mass conserved."""
    n = 8
    xs = np.cumsum(np.r_[0, 1.1 ** np.arange(n)])
    xs /= xs[-1]
    out = []
    for pkg in (dccrg_tpu, dccrg_tpu_torch):
        g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
             .set_periodic(True, True, True)
             .set_geometry(pkg.StretchedCartesianGeometry,
                           coordinates=(xs, np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1))))
        g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=1)) if pkg is dccrg_tpu
             else g.initialize(device="cpu"))
        adv = (JAdvection if pkg is dccrg_tpu else dccrg_tpu_torch.Advection)(g, dtype=np.float64)
        assert adv.dense is None
        s = adv.initialize_state()
        dt = np.float64(0.4 * adv.max_time_step(s))
        ids = g.get_cells()
        vol = np.prod(g.geometry.get_length(ids), axis=1)
        m0 = float((np.asarray(g.get_cell_data(s, "density", ids)) * vol).sum())
        dens = np.asarray(g.get_cell_data(adv.run(s, 20, dt), "density", ids))
        assert abs(float((dens * vol).sum()) - m0) <= 1e-12 * max(m0, 1.0)
        out.append(dens)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-13, atol=1e-13)
