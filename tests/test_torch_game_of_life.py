"""The port's GameOfLife (on the CPU) against the JAX package's, from the
same initial cells, compared by cell id: alive sets and live-neighbor
counts must be equal (the game is exact), on the general gather path, the
dense 2-D path (the whole-run kernel's twin on one device, the dense loop on
more) and refined grids."""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import GameOfLife as JGameOfLife
from dccrg_tpu_torch.convert import rows_state_from_numpy
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts


def _grid(pkg, n=10, D=1, periodic=(False, False, False), max_ref=0, refine_at=()):
    g = (
        pkg.Grid()
        .set_initial_length((n, n, 1))
        .set_maximum_refinement_level(max_ref)
        .set_neighborhood_length(1)
        .set_periodic(*periodic)
    )
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    for c in refine_at:
        g.refine_completely(c)
    if refine_at:
        g.stop_refining()
    return g


def _pair(alive, **kw):
    """(jax model, jax state, port model, port state) from the same cells."""
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    jm, pm = JGameOfLife(jg), dccrg_tpu_torch.GameOfLife(pg)
    return jm, jm.new_state(alive_cells=alive), pm, pm.new_state(alive_cells=alive)


def _assert_same(jm, js, pm, ps):
    assert set(pm.alive_cells(ps).tolist()) == set(jm.alive_cells(js).tolist())
    cells = jm.grid.get_cells()
    np.testing.assert_array_equal(cells, pm.grid.get_cells())
    np.testing.assert_array_equal(
        pm.grid.get_cell_data(ps, "live_neighbor_count", cells),
        np.asarray(jm.grid.get_cell_data(js, "live_neighbor_count", cells)))


# the reference's blinker and the JAX tests' still life and glider
# (tests/test_game_of_life.py); cells of the 10x10 board
PATTERNS = {
    "blinker": [54, 55, 56],
    "block": [44, 45, 54, 55],
    "glider": [2, 13, 21, 22, 23],
}


@pytest.mark.parametrize("how", ["step", "run"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_patterns_match_jax(pattern, how):
    jm, js, pm, ps = _pair(PATTERNS[pattern])
    for _ in range(4):
        if how == "step":
            js, ps = jm.step(js), pm.step(ps)
        else:
            js, ps = jm.run(js, 3), pm.run(ps, 3)
        _assert_same(jm, js, pm, ps)


def test_patterns_behave():
    """The port alone: the blinker oscillates, the block stays, the glider
    moves by (1, 1) in 4 turns."""
    for pattern, turns, expect in (
        ("blinker", 1, {45, 55, 65}), ("blinker", 2, {54, 55, 56}),
        ("block", 5, set(PATTERNS["block"])),
        ("glider", 4, {c + 11 for c in PATTERNS["glider"]}),
    ):
        g = _grid(dccrg_tpu_torch)
        gol = dccrg_tpu_torch.GameOfLife(g)
        s = gol.run(gol.new_state(alive_cells=PATTERNS[pattern]), turns)
        assert set(gol.alive_cells(s).tolist()) == expect, (pattern, turns)


@pytest.mark.parametrize("dense", [True, False])
def test_periodic_wrap_matches_jax(dense):
    """A blinker crossing the x boundary of a periodic 8x8 board."""
    ids = [1 + 7 + 3 * 8, 1 + 0 + 3 * 8, 1 + 1 + 3 * 8]
    kw = dict(n=8, periodic=(True, True, False))
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    jm = JGameOfLife(jg)
    pm = dccrg_tpu_torch.GameOfLife(pg, allow_dense=dense)
    assert (pm.dense2d is not None) == dense
    js, ps = jm.new_state(alive_cells=ids), pm.new_state(alive_cells=ids)
    js, ps = jm.run(js, 1), pm.run(ps, 1)
    assert set(pm.alive_cells(ps).tolist()) == {1 + 0 + 2 * 8, 1 + 0 + 3 * 8,
                                                1 + 0 + 4 * 8}
    _assert_same(jm, js, pm, ps)
    js, ps = jm.run(js, 1), pm.run(ps, 1)
    assert set(pm.alive_cells(ps).tolist()) == set(ids)
    _assert_same(jm, js, pm, ps)


@pytest.mark.parametrize("periodic", [(False, False, False), (True, True, False)],
                         ids=["open", "periodic"])
@pytest.mark.parametrize("D", [1, 2, 5])
def test_dense2d_matches_general_and_jax(D, periodic):
    """Mirrors test_dense2d_matches_general: the dense 2-D path (the
    whole-run kernel's twin on one device, the dense loop on more) equals
    the general gather path and the JAX package, alive sets and counts."""
    kw = dict(D=D, periodic=periodic)
    rng = np.random.default_rng(0)
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    cells = pg.get_cells()
    alive0 = cells[rng.random(len(cells)) < 0.35]
    fast = dccrg_tpu_torch.GameOfLife(pg)
    slow = dccrg_tpu_torch.GameOfLife(pg, allow_dense=False)
    assert fast.dense2d is not None and slow.dense2d is None
    assert fast.fused == (D == 1)
    reset_counts()
    s = fast.run(fast.new_state(alive_cells=alive0), 13)
    assert PLAIN_CALLS["gol_run"] == (1 if D == 1 else 0)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    r = slow.run(slow.new_state(alive_cells=alive0), 13)
    jm = JGameOfLife(jg)
    js = jm.run(jm.new_state(alive_cells=alive0), 13)
    _assert_same(jm, js, fast, s)
    _assert_same(jm, js, slow, r)


def test_board_over_threshold_takes_dense_loop(monkeypatch):
    """A one-slot board that ``gol_run_fits`` refuses runs the dense loop,
    not the whole-run kernel, and gives the same result."""
    from dccrg_tpu_torch.models import game_of_life as pgol

    g = _grid(dccrg_tpu_torch)
    alive0 = g.get_cells()[np.random.default_rng(4).random(100) < 0.35]
    fused = dccrg_tpu_torch.GameOfLife(g)
    monkeypatch.setattr(pgol, "gol_run_fits", lambda ny, nx: False)
    loop = dccrg_tpu_torch.GameOfLife(g)
    assert fused.fused and not loop.fused and loop.dense2d is not None
    reset_counts()
    s = loop.run(loop.new_state(alive_cells=alive0), 9)
    assert PLAIN_CALLS["gol_run"] == 0
    r = fused.run(fused.new_state(alive_cells=alive0), 9)
    for k in s:
        assert bool((s[k] == r[k]).all()), k


@pytest.mark.parametrize("D", [1, 3])
def test_refined_grid_matches_jax(D):
    """Mirrors tests/test_gol_refined.py: life on a statically refined grid
    (the general path) equals the JAX package's, cell by cell."""
    kw = dict(D=D, max_ref=1, refine_at=(1, 34, 67))
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    cells = pg.get_cells()
    np.testing.assert_array_equal(cells, jg.get_cells())
    alive0 = cells[np.random.default_rng(2).random(len(cells)) < 0.3]
    jm, pm = JGameOfLife(jg), dccrg_tpu_torch.GameOfLife(pg)
    assert pm.dense2d is None
    js, ps = jm.new_state(alive_cells=alive0), pm.new_state(alive_cells=alive0)
    for _ in range(3):
        js, ps = jm.run(js, 2), pm.run(ps, 2)
        _assert_same(jm, js, pm, ps)


def test_refined_blinker_away_from_refinement():
    """The refined2d design: a blinker far from a refined corner behaves as
    on the uniform grid."""
    g = _grid(dccrg_tpu_torch, max_ref=1, refine_at=(1,))
    gol = dccrg_tpu_torch.GameOfLife(g)
    s = gol.new_state(alive_cells=[54, 55, 56])
    for turn in range(1, 7):
        s = gol.step(s)
        expect = {45, 55, 65} if turn % 2 else {54, 55, 56}
        assert set(gol.alive_cells(s).tolist()) == expect, turn


def test_jax_row_state_carries_over():
    """A JAX state after a few turns enters the port from numpy by cell id
    (convert.rows_state_from_numpy) and both go on in lockstep."""
    kw = dict(D=3, max_ref=1, refine_at=(28, 71))
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    cells = jg.get_cells()
    alive0 = cells[np.random.default_rng(9).random(len(cells)) < 0.4]
    jm, pm = JGameOfLife(jg), dccrg_tpu_torch.GameOfLife(pg)
    js = jm.run(jm.new_state(alive_cells=alive0), 3)
    host = {k: np.asarray(v) for k, v in js.items()}
    ps = rows_state_from_numpy(pg, host, jg.epoch.cell_ids)
    _assert_same(jm, js, pm, ps)
    js, ps = jm.run(js, 4), pm.run(ps, 4)
    _assert_same(jm, js, pm, ps)


def test_device_count_invariance():
    finals = []
    alive0 = np.flatnonzero(np.random.default_rng(11).random(100) < 0.35) + 1
    for D in (1, 2, 5):
        g = _grid(dccrg_tpu_torch, D=D)
        gol = dccrg_tpu_torch.GameOfLife(g, allow_dense=False)
        finals.append(frozenset(gol.alive_cells(gol.run(gol.new_state(alive0), 10)).tolist()))
    assert finals[0] == finals[1] == finals[2]


def test_unported_forms_raise():
    """The cohort forms the JAX package has are ported (no form raises
    any more): the gather step in cohort form, and the wide step where
    the JAX package has one — on one slot every neighbor is local (a
    budget of 255), on two slots the length-1 hood funds one step (no
    wide step).  tests/test_torch_wide_halo.py holds the engaged forms."""
    for D in (1, 2):
        g = _grid(dccrg_tpu_torch, D=D)
        gol = dccrg_tpu_torch.GameOfLife(g)
        jgol = dccrg_tpu.models.GameOfLife(_grid(dccrg_tpu, D=D))
        spec, jspec = gol.batch_step_spec(), jgol.batch_step_spec()
        assert spec.kind == jspec.kind == "gol"
        assert (spec.wide is None) == (jspec.wide is None) == (D == 2)
        if D == 1:
            assert spec.wide.budget == jspec.wide.budget == 255
