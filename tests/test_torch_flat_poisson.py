"""The port's flat-voxel Poisson operator (``ops/flat_poisson.py``) against
the JAX package's: ``build_flat_poisson``'s tables exactly (two- and
three-level grids, a uniform grid with all three cell roles, the periodic
self-coupling grids of test_poisson.py, four device slots), and the float64
``apply_fwd`` / ``apply_rev`` / ``voxelize`` / ``writeback`` on the same
seeded vectors at rtol = atol = 1e-13 (the operator-identity bound of
test_poisson.py::test_flat_path_three_levels_matches_gather)."""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Poisson as JPoisson


def _grid(pkg, n=(8, 8, 8), levels=0, periodic=(True, True, True), D=1,
          cell=None, refine=None):
    """``refine(g, level)`` returns the cells to refine, once per level."""
    g = (pkg.Grid().set_initial_length(n).set_neighborhood_length(0)
         .set_periodic(*periodic).set_maximum_refinement_level(levels)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=cell or tuple(1.0 / np.asarray(n))))
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    for level in range(levels):
        for cid in refine(g, level):
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def _ball(center, radii):
    """Refine the finest leaves inside a ball, one radius per level
    (test_poisson.py's refined grids)."""
    def pick(g, level):
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - center, axis=1)
        lv = g.mapping.get_refinement_level(ids)
        return ids[(r < radii[level]) & (lv == lv.max())]

    return pick


def _roles(g):
    """test_flat_path_matches_gather_uniform_with_roles: a skipped ball,
    boundary cells on the domain faces, the rest solved."""
    cells = g.get_cells()
    ctr = g.geometry.get_center(cells)
    skip = cells[np.linalg.norm(ctr - 0.5, axis=1) < 0.17]
    on_face = (ctr < 1.0 / 6).any(axis=1) | (ctr > 5.0 / 6).any(axis=1)
    solve = cells[~on_face & ~np.isin(cells, skip)]
    return dict(solve_cells=solve, skip_cells=skip)


CASES = {
    "two_level": dict(levels=1, refine=_ball(0.45, (0.3,))),
    "three_level": dict(levels=2, refine=_ball(0.5, (0.3, 0.2))),
    "uniform_roles": dict(n=(6, 6, 6), periodic=(False, False, False)),
    "self_coupling_1d": dict(n=(8, 1, 1), cell=(1.0 / 8, 1.0, 1.0)),
    "self_coupling_coarse": dict(
        n=(8, 2, 1), levels=1, cell=(1.0 / 8, 0.5, 1.0),
        refine=lambda g, level: g.get_cells()[:4]),
    "four_slots": dict(D=4, levels=1, refine=_ball(0.45, (0.3,))),
}


def _pair(case):
    kw = CASES[case]
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    roles = _roles(jg) if case == "uniform_roles" else {}
    jp = JPoisson(jg, allow_rolled=False, **roles)
    pp = dccrg_tpu_torch.Poisson(pg, allow_rolled=False, **roles)
    assert jp._flat is not None and pp._flat is not None
    return jg, jp, pg, pp


def _equal(got, want, key):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for a, b in zip(got, want):
            _equal(a, b, key)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_match_jax(case):
    jg, jp, pg, pp = _pair(case)
    want, got = jp._flat_tables, pp._flat_tables
    assert got.keys() == want.keys()
    for k in want:
        _equal(got[k], want[k], k)
    # the leaf factors both tables come from
    for a in ("_f_pos_leaf", "_f_neg_leaf", "_scaling_leaf", "_cell_type_leaf"):
        np.testing.assert_array_equal(getattr(pp, a), getattr(jp, a), err_msg=a)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"four_slots"}))
def test_operator_matches_jax(case):
    """f64 lift, A·v, Aᵀ·v and write-back of one seeded vector.  Four slots
    are held by their tables here (the JAX package's sharded operator is
    slow to compile on the CPU); test_torch_poisson.py holds the port's
    four-slot solve against its one-slot solve."""
    jg, jp, pg, pp = _pair(case)
    ids = pg.get_cells()
    v = np.random.default_rng(4).standard_normal(len(ids))
    spec = {"x": ((), np.float64)}
    jx = jg.set_cell_data(jg.new_state(spec), "x", ids, v)["x"]
    px = pg.set_cell_data(pg.new_state(spec), "x", ids, v)["x"]
    jf, jr, jvox, jwb, jmasks = jp._flat
    pf, pr, pvox, pwb, pmasks = pp._flat
    jv, pv = jvox(jx), pvox(px)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    for k in ("solve", "dot"):
        np.testing.assert_array_equal(pmasks[k].numpy(), np.asarray(jmasks[k]))
    for japply, papply in ((jf, pf), (jr, pr)):
        ja, pa = np.asarray(japply(jv)), papply(pv)
        np.testing.assert_allclose(pa.numpy(), ja, rtol=1e-13, atol=1e-13)
        got = pg.get_cell_data({"x": pwb(pa)}, "x", ids)
        want = np.asarray(jg.get_cell_data({"x": jwb(ja)}, "x", ids))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
        assert pwb(pa).shape == tuple(pg.new_state(spec)["x"].shape)
