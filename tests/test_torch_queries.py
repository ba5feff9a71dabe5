"""The port's query surface against the JAX package's (tests/test_queries.py
mirrored): local / inner / outer cells, owners, neighbor-relation criteria,
getters, copy_structure and the single-process collectives, on the same
grids at 1 and 8 slots.  Every answer is compared exactly."""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.utils import collectives as jcoll
from dccrg_tpu_torch.grid import (
    HAS_LOCAL_NEIGHBOR_OF,
    HAS_LOCAL_NEIGHBOR_TO,
    HAS_NO_NEIGHBOR,
    HAS_REMOTE_NEIGHBOR_OF,
    HAS_REMOTE_NEIGHBOR_TO,
)
from dccrg_tpu_torch.utils import collectives as tcoll


def make_grid(pkg, D=8, length=(8, 8, 1), hood=1, max_ref=0):
    g = (pkg.Grid().set_initial_length(length).set_neighborhood_length(hood)
         .set_maximum_refinement_level(max_ref))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))
    return g.initialize(n_devices=D, device="cpu")


@pytest.fixture(params=[1, 8])
def grids(request):
    return make_grid(dccrg_tpu, request.param), make_grid(dccrg_tpu_torch, request.param)


CRITERIA = [HAS_NO_NEIGHBOR, HAS_LOCAL_NEIGHBOR_OF, HAS_REMOTE_NEIGHBOR_TO,
            HAS_LOCAL_NEIGHBOR_OF | HAS_LOCAL_NEIGHBOR_TO,
            HAS_REMOTE_NEIGHBOR_OF | HAS_REMOTE_NEIGHBOR_TO]


def test_criteria_bitmask(grids):
    jg, tg = grids
    for d in range(tg.n_devices):
        np.testing.assert_array_equal(tg.neighbor_criteria(d), jg.neighbor_criteria(d))
        for crit in CRITERIA:
            for exact in (False, True):
                np.testing.assert_array_equal(
                    tg.get_cells_by_criteria(d, crit, exact_match=exact),
                    jg.get_cells_by_criteria(d, crit, exact_match=exact))
        for name in ("local_cells", "inner_cells", "outer_cells", "remote_cells"):
            np.testing.assert_array_equal(getattr(tg, name)(d), getattr(jg, name)(d))
        # the JAX test's own assertions, on the port
        outer = set(tg.outer_cells(d).tolist())
        with_remote = set(tg.get_cells_by_criteria(
            d, HAS_REMOTE_NEIGHBOR_OF | HAS_REMOTE_NEIGHBOR_TO).tolist())
        assert with_remote == outer
        assert set(tg.get_cells_by_criteria(
            d, HAS_LOCAL_NEIGHBOR_OF | HAS_LOCAL_NEIGHBOR_TO).tolist()) <= set(
            tg.local_cells(d).tolist())
        assert not len(tg.get_cells_by_criteria(d, HAS_NO_NEIGHBOR))
    ids = np.concatenate([tg.get_cells(), [np.uint64(10**6)]]).astype(np.uint64)
    np.testing.assert_array_equal(tg.get_owner(ids), jg.get_owner(ids))
    np.testing.assert_array_equal(tg.is_local(ids, 0), jg.is_local(ids, 0))
    np.testing.assert_array_equal(tg.local_cells(), jg.local_cells())


def test_exact_match(grids):
    jg, tg = grids
    bits = HAS_LOCAL_NEIGHBOR_OF | HAS_LOCAL_NEIGHBOR_TO
    for d in range(tg.n_devices):
        exact = set(tg.get_cells_by_criteria(d, bits, exact_match=True).tolist())
        assert exact == set(tg.inner_cells(d).tolist())


@pytest.mark.parametrize("name", ["HAS_LOCAL_NEIGHBOR_BOTH", "HAS_REMOTE_NEIGHBOR_BOTH"])
def test_both_masks(grids, name):
    """The two ``*_BOTH`` masks: the JAX values, exported, and the same
    ``get_cells_by_criteria`` answers as the JAX grid's, either match."""
    import dccrg_tpu.grid as jgrid
    import dccrg_tpu_torch.grid as tgrid

    jg, tg = grids
    mask = getattr(tgrid, name)
    assert mask == getattr(jgrid, name) and name in tgrid.__all__
    for d in range(tg.n_devices):
        for exact in (False, True):
            np.testing.assert_array_equal(
                tg.get_cells_by_criteria(d, mask, exact_match=exact),
                jg.get_cells_by_criteria(d, getattr(jgrid, name), exact_match=exact))


def test_getters(grids):
    jg, tg = grids
    for name in ("get_maximum_refinement_level", "get_neighborhood_length",
                 "get_load_balancing_method", "get_periodicity", "get_total_cells"):
        assert getattr(tg, name)() == getattr(jg, name)(), name
    assert tg.length == tuple(jg.length)
    for d in range(tg.n_devices):
        for name in ("get_local_cell_count", "get_ghost_cell_count",
                     "get_number_of_update_send_cells",
                     "get_number_of_update_receive_cells"):
            assert getattr(tg, name)(d) == getattr(jg, name)(d), (name, d)
    assert sum(tg.get_local_cell_count(d) for d in range(tg.n_devices)) == 64
    assert (tg.get_ghost_cell_count(0) > 0) == (tg.n_devices > 1)
    for g in (jg, tg):
        g.set_partitioning_option("IMBALANCE_TOL", "1.05")
    assert tg.get_partitioning_options() == jg.get_partitioning_options() == {
        "IMBALANCE_TOL": "1.05"}
    assert tg.get_partitioning_options(0) == {} == jg.get_partitioning_options(0)


def test_copy_structure():
    jg, tg = make_grid(dccrg_tpu), make_grid(dccrg_tpu_torch)
    j2, t2 = jg.copy_structure(), tg.copy_structure()
    np.testing.assert_array_equal(t2.get_cells(), tg.get_cells())
    assert t2.epoch is tg.epoch and t2.device == tg.device
    s1 = tg.new_state({"a": ((), np.float64)})
    s2 = t2.new_state({"b": ((2,), np.int32)})
    assert s2["b"].shape[:2] == s1["a"].shape[:2] and s2["b"].device == s1["a"].device
    # mutating the copy (a rebalance) leaves the original alone; the new
    # owners are the JAX package's
    for g in (j2, t2):
        g.pin(1, 7)
        g.balance_load()
    assert int(t2.get_owner(np.uint64(1))) == 7
    assert int(tg.get_owner(np.uint64(1))) == 0
    np.testing.assert_array_equal(t2.leaves.owner, j2.leaves.owner)
    np.testing.assert_array_equal(tg.leaves.owner, jg.leaves.owner)
    np.testing.assert_array_equal(t2.get_cells(), tg.get_cells())


def test_collectives(grids):
    jg, tg = grids
    vals = np.arange(tg.n_devices, dtype=float)
    assert tcoll.all_gather(vals) == jcoll.all_gather(vals) == vals.tolist()
    for op in (np.add, np.minimum, np.maximum):
        assert tcoll.all_reduce(vals, op=op) == jcoll.all_reduce(vals, op=op)
    for d in range(tg.n_devices):
        np.testing.assert_array_equal(tcoll.halo_peers(tg, d), jcoll.halo_peers(jg, d))
        assert tcoll.some_reduce(tg, vals, d) == jcoll.some_reduce(jg, vals, d)
    if tg.n_devices == 8:
        peers = tcoll.halo_peers(tg, 3)
        assert 2 in peers and 4 in peers
        assert tcoll.some_reduce(tg, vals, 3) < vals.sum()
    pins, weights = {1: 2}, {3: 4.0}
    assert tcoll.sync_partition_inputs(pins, weights) == (pins, weights)
