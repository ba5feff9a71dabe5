"""The port's user neighborhoods, additional item hooks and invariant checker
against the JAX package's (tests/test_user_neighborhoods.py mirrored, with
the neighborhood half of
tests/test_cell_datatype.py::test_policy_sees_neighborhood_and_pair), at 1
and 8 slots.  Neighbor lists, schedules, epochs and item tables are
compared exactly; exchanged states by cell id, bitwise.
(tests/test_user_neighborhoods.py::test_timers_record_phases reads the
JAX package's telemetry registry, which the port does not have yet.)"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.parallel.stencil import StencilTables as JStencilTables
from dccrg_tpu_torch.parallel.stencil import StencilTables
from dccrg_tpu_torch.utils.verify import (
    compare_epochs,
    verify_finite,
    verify_grid,
    verify_user_data,
)


def make_grid(pkg, hood=1, length=(6, 6, 1), max_ref=0, n_dev=8):
    n = np.asarray(length)
    g = (pkg.Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(hood).set_periodic(True, True, False)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n)))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev))
    return g.initialize(n_devices=n_dev, device="cpu")


def both(**kw):
    return tuple(make_grid(pkg, **kw) for pkg in (dccrg_tpu, dccrg_tpu_torch))


@pytest.mark.parametrize("n_dev", [1, 8])
def test_add_remove_neighborhood(n_dev):
    jg, tg = both(n_dev=n_dev)
    xy = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    for g in (jg, tg):
        assert g.add_neighborhood(7, xy)
        assert not g.add_neighborhood(8, [(2, 0, 0)])      # outside the default
        assert not g.add_neighborhood(7, [(1, 0, 0)])      # id taken
        assert not g.add_neighborhood(None, [(1, 0, 0)])
    assert 7 in tg.epoch.hoods
    compare_epochs(tg.epoch, jg.epoch)
    for cell in (8, 1, 36):
        for a, b in zip(tg.get_neighbors_of(cell, hood_id=7),
                        jg.get_neighbors_of(cell, hood_id=7)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tg.get_neighbors_to(cell, hood_id=7),
                                      jg.get_neighbors_to(cell, hood_id=7))
    assert len(tg.get_neighbors_of(8, hood_id=7)[0]) == 4
    for d in range(n_dev):
        np.testing.assert_array_equal(tg.inner_cells(d, 7), jg.inner_cells(d, 7))
        assert (tg.get_number_of_update_send_cells(d, 7)
                == jg.get_number_of_update_send_cells(d, 7))
    if n_dev > 1:
        assert (tg.epoch.hoods[7].pair_counts.sum()
                < tg.epoch.hoods[None].pair_counts.sum())
    for g in (jg, tg):
        assert g.remove_neighborhood(7)
        assert not g.remove_neighborhood(7) and not g.remove_neighborhood(None)
    assert 7 not in tg.epoch.hoods
    compare_epochs(tg.epoch, jg.epoch)
    # a zero-length default is the six face neighbors: a user hood must
    # take its offsets from them
    jz, tz = both(hood=0, n_dev=n_dev)
    for g in (jz, tz):
        assert not g.add_neighborhood(3, [(1, 1, 0)])
        assert g.add_neighborhood(3, [(1, 0, 0), (0, -1, 0)])
    compare_epochs(tz.epoch, jz.epoch)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_user_hood_exchange_and_states_stay_valid(n_dev):
    jg, tg = both(n_dev=n_dev)
    cells = tg.get_cells()
    states = [g.set_cell_data(g.new_state({"v": ((), np.float64)}, fill=-1.0), "v",
                              cells, cells.astype(np.float64)) for g in (jg, tg)]
    for g in (jg, tg):
        g.add_neighborhood(3, [(1, 0, 0), (-1, 0, 0)])
    # the state made before the registration still fits the layout
    outs = [g.update_copies_of_remote_neighbors(s, hood_id=3)
            for g, s in zip((jg, tg), states)]
    verify_grid(tg)
    for d in range(n_dev):
        n = int(tg.epoch.n_local[d] + tg.epoch.n_ghost[d])
        np.testing.assert_array_equal(outs[1]["v"][d, :n].numpy(),
                                      np.asarray(outs[0]["v"])[d, :n])


def test_cell_and_neighbor_item_hooks():
    jg, tg = both(hood=0)
    kw = dict(
        cell_items={
            "center": lambda grid, ids: grid.geometry.get_center(ids),
            "is_edge": lambda grid, ids: grid.mapping.get_indices(ids)[:, 0] == 0,
        },
        neighbor_items={
            "nbr_is_local": lambda grid, src, nbr, off: (
                grid.get_owner(nbr) == grid.get_owner(src)),
            "offset_norm": lambda grid, src, nbr, off: np.abs(off).sum(axis=1),
        },
    )
    t, j = StencilTables(tg, **kw), JStencilTables(jg, **kw)
    for name in ("center", "is_edge", "nbr_is_local", "offset_norm", "nbr_rows",
                 "nbr_valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    D, R = tg.n_devices, tg.epoch.R
    assert tuple(t.center.shape) == (D, R, 3)
    assert t.nbr_is_local.shape == t.nbr_rows.shape
    pos = int(tg.leaves.position(np.uint64(1)))
    d, r = tg.leaves.owner[pos], tg.epoch.row_of[pos]
    np.testing.assert_allclose(t.center[d, r].numpy(), tg.geometry.get_center(np.uint64(1)))
    assert (t.offset_norm[t.nbr_valid] == 1).all()


def test_verify_grid_passes_and_catches_corruption():
    tg = make_grid(dccrg_tpu_torch, hood=1, max_ref=1)
    tg.refine_completely(8)
    tg.stop_refining()
    verify_grid(tg)
    tg.leaves.owner[0] = 99
    with pytest.raises(AssertionError):
        verify_grid(tg)


def test_verify_user_data_and_finite():
    tg = make_grid(dccrg_tpu_torch, hood=1)
    spec = {"v": ((), np.float64), "w": ((2,), np.float32)}
    state = tg.new_state(spec)
    cells = tg.get_cells()
    state = tg.set_cell_data(state, "v", cells, np.arange(len(cells), dtype=np.float64))
    verify_user_data(tg, state, spec)
    verify_finite(tg, state, spec)
    bad = tg.set_cell_data(state, "w", cells[3:4], np.array([[np.nan, 0.0]], np.float32))
    with pytest.raises(AssertionError, match="non-finite"):
        verify_finite(tg, bad, spec)


def test_policy_sees_neighborhood_and_pair():
    """The cell_datatype policy receives (sender, receiver, hood_id): keyed
    on the neighborhood it gives each hood its own schedule, in both
    packages alike."""
    jg, tg = (make_grid(pkg, length=(8, 8, 1), n_dev=8)
              for pkg in (dccrg_tpu, dccrg_tpu_torch))
    outs = []
    for g in (jg, tg):
        assert g.add_neighborhood(7, [(0, 1, 0)])
        seen = set()

        def spy(field, cell_ids, sender, receiver, hood_id, seen=seen):
            seen.add((sender, receiver, hood_id))
            return np.full(len(cell_ids), hood_id == 7)

        cells = g.get_cells()
        st = g.set_cell_data(g.new_state({"rho": ((), np.float64)}, fill=-1.0), "rho",
                             cells, cells.astype(np.float64))
        out_default = g.halo(None, cell_datatype=spy)(st)
        out7 = g.halo(7, cell_datatype=spy)(st)
        assert any(h == 7 for _s, _r, h in seen) and any(h is None for _s, _r, h in seen)
        assert all(s != r for s, r, _h in seen)
        outs.append((out_default, out7, seen))
    (jd, j7, jseen), (td, t7, tseen) = outs
    assert jseen == tseen
    ep = tg.epoch
    ghost = ~ep.local_mask & (ep.cell_len != 0)
    assert (td["rho"].numpy()[ghost] == -1.0).all()        # nothing moved
    assert t7["rho"].numpy().max() > 0
    np.testing.assert_array_equal(td["rho"].numpy(), np.asarray(jd["rho"]))
    np.testing.assert_array_equal(t7["rho"].numpy(), np.asarray(j7["rho"]))
