"""The port's load balancing against the JAX package's
(tests/test_load_balancing.py mirrored): every partitioning method, pins,
weights, options and hierarchies give the JAX package's owner arrays
exactly; epochs after a balance equal the JAX package's table by table
(``compare_epochs``); states after ``balance_load`` + ``remap_state`` and
after the staged form are bitwise equal by cell id; a gather-path advection
run across a balance is bitwise equal to the run without one.

Tolerances: owners, epochs and migrated states exact; the port's advection
against the JAX package's 1e-12 relative in float64 (as
tests/test_torch_advection_amr.py)."""
import warnings

import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu.models import GameOfLife as JGameOfLife
from dccrg_tpu.parallel import graph as jgraph
from dccrg_tpu.parallel import loadbalance as jlb
from dccrg_tpu_torch.models import Advection, GameOfLife
from dccrg_tpu_torch.parallel import graph as tgraph
from dccrg_tpu_torch.parallel import loadbalance as tlb
from dccrg_tpu_torch.parallel.partition import _hilbert_key, weighted_blocks
from dccrg_tpu_torch.utils.verify import compare_epochs, verify_grid

PKGS = (dccrg_tpu, dccrg_tpu_torch)


def make_grid(pkg, method="RCB", length=(8, 8, 1), n_dev=8, hood=1, max_ref=0,
              periodic=(False, False, False), cell=None):
    cell = cell or (1.0, 1.0, 1.0)
    g = (pkg.Grid().set_initial_length(length).set_neighborhood_length(hood)
         .set_maximum_refinement_level(max_ref).set_periodic(*periodic)
         .set_load_balancing_method(method)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=cell))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev))
    return g.initialize(n_devices=n_dev, device="cpu")


def both(**kw):
    return tuple(make_grid(pkg, **kw) for pkg in PKGS)


def refine_ball(g, center=0.4, radius=0.3, scale=1.0):
    ids = g.get_cells()
    r = np.linalg.norm(g.geometry.get_center(ids) / scale - center, axis=1)
    g.refine_completely_many(ids[r < radius])
    g.stop_refining()
    return g


def same_owners(jg, tg):
    np.testing.assert_array_equal(tg.get_cells(), jg.get_cells())
    np.testing.assert_array_equal(tg.leaves.owner, jg.leaves.owner)


def by_id(g, state, field):
    cells = g.get_cells()
    return cells, g.get_cell_data(state, field, cells)


# ----------------------------------------------------- owners, every method

METHODS = ["RCB", "RIB", "HSFC", "SFC", "HILBERT", "MORTON", "BLOCK", "ZSLAB",
           "GRAPH", "HYPERGRAPH", "NONE"]


@pytest.mark.parametrize("n_dev", [3, 8])
@pytest.mark.parametrize("method", METHODS)
def test_owners_equal_every_method(method, n_dev):
    """A refined, weighted, pinned grid: the port's owners, epoch and
    migrated state equal the JAX package's."""
    jg, tg = both(method=method, length=(6, 6, 24), n_dev=n_dev, max_ref=1,
                  cell=(1 / 6, 1 / 6, 1 / 24))
    cells = None
    for g in (jg, tg):
        refine_ball(g)
        cells = g.get_cells()
        for c in cells[::37]:
            g.set_cell_weight(int(c), 3.0)
        g.pin(int(cells[5]), n_dev - 1)
    vals = np.sin(cells.astype(np.float64))
    states = [g.set_cell_data(g.new_state({"v": ((), np.float64)}), "v", cells, vals)
              for g in (jg, tg)]
    same_owners(jg, tg)
    for g in (jg, tg):
        g.balance_load()
    same_owners(jg, tg)
    compare_epochs(tg.epoch, jg.epoch)
    verify_grid(tg)
    out = tg.remap_state(states[1])
    np.testing.assert_array_equal(tg.get_cell_data(out, "v", cells), vals)
    assert int(tg.get_owner(cells[5])) == n_dev - 1


def test_partitioner_functions_equal():
    """compute_partition, rcb / rib and the graph metrics of the two
    packages on the same inputs (weights, options, adjacency)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(600, 3))
    w = rng.uniform(0.5, 2.0, 600)
    for k in (2, 5, 8):
        np.testing.assert_array_equal(tlb.rcb_partition(centers, k, w),
                                      jlb.rcb_partition(centers, k, w))
        np.testing.assert_array_equal(tlb.rib_partition(centers, k, w),
                                      jlb.rib_partition(centers, k, w))
    jg, tg = both(method="GRAPH", length=(8, 8, 8), max_ref=1, cell=(1 / 8,) * 3)
    for g in (jg, tg):
        refine_ball(g)
    js, jn = jgraph.grid_adjacency(jg)
    ts, tn = tgraph.grid_adjacency(tg)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tn, jn)
    wts = rng.uniform(1, 4, len(tg.get_cells()))
    for method, opts in (("GRAPH", {"IMBALANCE_TOL": 1.05}), ("HYPERGRAPH", {}),
                         ("HYPERGRAPH", {"PHG_CUT_OBJECTIVE": "HYPEREDGES"}),
                         ("BLOCK", {"IMBALANCE_TOL": 1.02}), ("MORTON", {}),
                         ("HSFC", {"imbalance_tol": 1.01}), ("RCB", {"LB_METHOD": "RIB"})):
        t = tlb.compute_partition(method, tg, 8, wts, opts)
        np.testing.assert_array_equal(t, jlb.compute_partition(method, jg, 8, wts, opts))
        assert tgraph.edge_cut(t, ts, tn) == jgraph.edge_cut(t, js, jn)
        assert tgraph.comm_volume(t, ts, tn) == jgraph.comm_volume(t, js, jn)


@pytest.mark.parametrize("case", ["one_level", "two_levels", "nondivisible",
                                  "per_level_options", "global_override"])
def test_hierarchical_owners_equal(case):
    n_dev = 6 if case == "nondivisible" else 8
    jg, tg = both(method="RCB", length=(8, 8, 8), n_dev=n_dev, max_ref=1,
                  cell=(1 / 8,) * 3)
    for g in (jg, tg):
        refine_ball(g)
        if case == "global_override":
            g.set_partitioning_option("LB_METHOD", "GRAPH")
        g.add_partitioning_level(4)
        if case == "two_levels":
            g.add_partitioning_level(2)
        if case == "per_level_options":
            g.add_partitioning_level(1)
            g.add_partitioning_option(0, "LB_METHOD", "GRAPH")
            g.add_partitioning_option(0, "IMBALANCE_TOL", 1.05)
            g.add_partitioning_option(1, "LB_METHOD", "HILBERT")
            g.add_partitioning_option(1, "IMBALANCE_TOL", 1.2)
        if case == "global_override":
            g.add_partitioning_option(0, "LB_METHOD", "HILBERT")
        g.balance_load()
    same_owners(jg, tg)
    compare_epochs(tg.epoch, jg.epoch)
    counts = np.bincount(tg.get_owner(tg.get_cells()), minlength=n_dev)
    assert counts.min() > 0


# ------------------------------------------- the JAX tests' cases, on the port

@pytest.mark.parametrize("method", ["RCB", "HSFC", "BLOCK", "GRAPH"])
def test_balance_produces_even_partition(method):
    jg, tg = both(method=method)
    for g in (jg, tg):
        g.balance_load()
    same_owners(jg, tg)
    counts = np.bincount(tg.get_owner(tg.get_cells()), minlength=8)
    assert counts.sum() == 64 and counts.max() - counts.min() <= 2


def test_rib_beats_rcb_on_oblique_distribution():
    rng = np.random.default_rng(7)
    n = 4000
    t = rng.uniform(-5, 5, n)
    centers = np.stack([t / np.sqrt(2) + rng.normal(0, 0.2, n),
                        t / np.sqrt(2) + rng.normal(0, 0.2, n),
                        rng.uniform(-4, 4, n)], axis=1)
    w = rng.uniform(0.5, 2.0, n)

    def scatter(owner, k):
        s = 0.0
        for p in range(k):
            m = owner == p
            wp, c = w[m], centers[m]
            mu = (wp[:, None] * c).sum(0) / wp.sum()
            s += (wp[:, None] * (c - mu) ** 2).sum()
        return s

    for k in (2, 8):
        rcb, rib = tlb.rcb_partition(centers, k, w), tlb.rib_partition(centers, k, w)
        np.testing.assert_array_equal(rib, jlb.rib_partition(centers, k, w))
        assert scatter(rib, k) < scatter(rcb, k)
        loads = np.bincount(rib, weights=w, minlength=k)
        assert loads.max() <= 1.05 * loads.sum() / k and loads.min() > 0


def test_rib_balances_through_grid():
    jg, tg = both(method="RIB", length=(8, 8, 8))
    for g in (jg, tg):
        g.balance_load()
    same_owners(jg, tg)
    counts = np.bincount(tg.get_owner(tg.get_cells()), minlength=8)
    assert counts.sum() == 512 and counts.max() - counts.min() <= 2
    c = tg.geometry.get_center(tg.get_cells())
    wts = np.where(np.abs(c[:, 0] - c[:, 1]) / np.sqrt(2) < 1.0, 100.0, 1.0)
    assert not np.array_equal(tlb.compute_partition("RIB", tg, 8, wts),
                              tlb.compute_partition("RCB", tg, 8, wts))


def test_none_keeps_partition_and_epoch():
    tg = make_grid(dccrg_tpu_torch, "NONE")
    before, epoch = tg.get_owner(tg.get_cells()), tg.epoch
    state = tg.new_state({"v": ((), np.float64)})
    tg.balance_load()
    np.testing.assert_array_equal(tg.get_owner(tg.get_cells()), before)
    assert tg.epoch is epoch and tg.remap_state(state) is state


def test_weights_skew_partition():
    jg, tg = both(method="BLOCK", length=(16, 1, 1))
    for g in (jg, tg):
        for c in range(1, 5):
            assert g.set_cell_weight(c, 100.0)
        assert not g.set_cell_weight(10**6, 2.0)
        g.balance_load()
    same_owners(jg, tg)
    assert tg.get_cell_weight(1) == 100.0 and tg.get_cell_weight(9) == 1.0
    assert len(set(tg.get_owner(np.arange(1, 5, dtype=np.uint64)).tolist())) >= 3


def test_pinning_overrides_partitioner():
    jg, tg = both(method="RCB")
    for g in (jg, tg):
        assert g.pin(1, 7) and g.pin(64, 0) and not g.pin(2, 8) and not g.pin(10**6)
        g.balance_load()
    same_owners(jg, tg)
    assert int(tg.get_owner(np.uint64(1))) == 7 and int(tg.get_owner(np.uint64(64))) == 0
    for g in (jg, tg):
        assert g.unpin(1) and g.unpin_all_cells()
        g.pin(9)                        # the current owner
        g.balance_load()
    same_owners(jg, tg)
    assert tg.pin_requests == jg.pin_requests


def test_balance_load_preserves_data():
    tg = make_grid(dccrg_tpu_torch, "RCB")
    state = tg.new_state({"v": ((), np.float64), "w": ((3,), np.int32)})
    cells = tg.get_cells()
    vals = np.sin(cells.astype(np.float64))
    state = tg.set_cell_data(state, "v", cells, vals)
    state = tg.set_cell_data(state, "w", cells, np.stack([cells] * 3, 1).astype(np.int32))
    tg.pin(1, 5)
    tg.balance_load()
    state = tg.remap_state(state)
    np.testing.assert_array_equal(tg.get_cell_data(state, "v", cells), vals)
    np.testing.assert_array_equal(tg.get_cell_data(state, "w", cells)[:, 2], cells)


def test_gol_correct_after_balance():
    alive = [54, 55, 56, 12, 13, 22]
    g1 = make_grid(dccrg_tpu_torch, "BLOCK", length=(10, 10, 1))
    gol1 = GameOfLife(g1, allow_dense=False)
    s1 = gol1.run(gol1.new_state(alive_cells=alive), 5)
    jg = make_grid(dccrg_tpu, "RCB", length=(10, 10, 1))
    tg = make_grid(dccrg_tpu_torch, "RCB", length=(10, 10, 1))
    jgol, tgol = JGameOfLife(jg), GameOfLife(tg, allow_dense=False)
    js = jgol.run(jgol.new_state(alive_cells=alive), 2)
    ts = tgol.run(tgol.new_state(alive_cells=alive), 2)
    for g in (jg, tg):
        g.balance_load()
    same_owners(jg, tg)
    js, ts = jg.remap_state(js), tg.remap_state(ts)
    jgol, tgol = JGameOfLife(jg), GameOfLife(tg, allow_dense=False)
    js, ts = jgol.run(js, 3), tgol.run(ts, 3)
    assert set(tgol.alive_cells(ts).tolist()) == set(gol1.alive_cells(s1).tolist()) \
        == set(jgol.alive_cells(js).tolist())


def test_hierarchical_partitioning_groups():
    tg = make_grid(dccrg_tpu_torch, "RCB")
    tg.add_partitioning_level(4)
    tg.balance_load()
    owners = tg.get_owner(tg.get_cells())
    counts = np.bincount(owners, minlength=8)
    assert counts.sum() == 64 and counts.max() - counts.min() <= 4
    centers = tg.geometry.get_center(tg.get_cells())
    full = centers.max(axis=0) - centers.min(axis=0)
    for gi in (0, 1):
        c = centers[owners // 4 == gi]
        assert ((c.max(axis=0) - c.min(axis=0)) < full - 1e-9).any()


def _refined_cube(pkg, method, n=8, n_dev=8):
    g = make_grid(pkg, method, length=(n, n, n), n_dev=n_dev, max_ref=1)
    g.refine_completely_many(np.arange(1, n * n + 1, dtype=np.uint64))
    g.stop_refining()
    return g


def test_graph_and_hypergraph_beat_hilbert():
    tg = _refined_cube(dccrg_tpu_torch, "HILBERT")
    start, nbr = tgraph.grid_adjacency(tg)
    hil = tlb.compute_partition("HILBERT", tg, 8, None)
    gra = tlb.compute_partition("GRAPH", tg, 8, None)
    hyp = tlb.compute_partition("HYPERGRAPH", tg, 8, None)
    assert tgraph.edge_cut(gra, start, nbr) < tgraph.edge_cut(hil, start, nbr)
    assert tgraph.comm_volume(hyp, start, nbr) < tgraph.comm_volume(hil, start, nbr)
    counts = np.bincount(gra, minlength=8)
    assert counts.max() <= 1.1 * counts.sum() / 8 + 1e-9 and counts.min() >= 1


def test_graph_balance_load_end_to_end():
    gh = _refined_cube(dccrg_tpu_torch, "HILBERT")
    gg = _refined_cube(dccrg_tpu_torch, "GRAPH")
    jgg = _refined_cube(dccrg_tpu, "GRAPH")
    for g in (gh, gg, jgg):
        g.balance_load()
    same_owners(jgg, gg)
    np.testing.assert_array_equal(gh.get_cells(), gg.get_cells())
    assert (sum(gg.get_ghost_cell_count(d) for d in range(8))
            <= sum(gh.get_ghost_cell_count(d) for d in range(8)))


def test_imbalance_tol_option_honored():
    jg, tg = both(method="BLOCK", length=(9, 1, 1), n_dev=3)
    w = np.array([4.0, 4, 4, 3, 3, 3, 3, 3, 3])
    plain = tlb.compute_partition("BLOCK", tg, 3, w)
    repaired = tlb.compute_partition("BLOCK", tg, 3, w, {"IMBALANCE_TOL": 1.05})
    assert np.bincount(plain, weights=w, minlength=3).max() == 13.0
    assert np.bincount(repaired, weights=w, minlength=3).max() == 12.0
    seed = tlb.compute_partition("GRAPH", tg, 3, w, {"IMBALANCE_TOL": 1.05})
    assert np.bincount(seed, weights=w, minlength=3).max() == 12.0
    for g in (jg, tg):
        g.set_partitioning_option("IMBALANCE_TOL", 1.05)
        for c, wc in enumerate(w, start=1):
            g.set_cell_weight(c, float(wc))
        g.balance_load()
    same_owners(jg, tg)
    assert np.bincount(tg.get_owner(tg.get_cells()), weights=w, minlength=3).max() == 12.0


def test_imbalance_repair_never_worse_and_nonempty():
    rng = np.random.default_rng(0)
    for _ in range(100):
        n, n_parts = int(rng.integers(6, 40)), int(rng.integers(2, 9))
        w = rng.integers(1, 10, n).astype(float)
        order = np.arange(n)
        plain = weighted_blocks(order, w, n_parts)
        rep = weighted_blocks(order, w, n_parts, 1.0)
        assert (np.bincount(rep, weights=w, minlength=n_parts).max()
                <= np.bincount(plain, weights=w, minlength=n_parts).max())
        ne = weighted_blocks(order, w, n_parts, 1.0, nonempty=True)
        if n >= n_parts:
            assert (np.bincount(ne, minlength=n_parts) > 0).all()


def test_multilevel_and_nondivisible_hierarchies_balance():
    tg = _refined_cube(dccrg_tpu_torch, "RCB")
    tg.add_partitioning_level(4)
    tg.add_partitioning_level(2)
    tg.balance_load()
    owners = tg.get_owner(tg.get_cells())
    n = len(owners)
    for size, groups in ((4, 2), (2, 4), (1, 8)):
        counts = np.bincount(owners // size, minlength=groups)
        assert counts.max() <= 1.25 * n / groups and counts.min() >= 0.75 * n / groups
    g6 = make_grid(dccrg_tpu_torch, "RCB", length=(8, 8, 8), n_dev=6)
    g6.add_partitioning_level(4)
    g6.balance_load()
    counts = np.bincount(g6.get_owner(g6.get_cells()), minlength=6)
    assert counts.min() >= 0.75 * 512 / 6 and counts.max() <= 1.25 * 512 / 6


def test_graph_refines_tiny_parts():
    tg = make_grid(dccrg_tpu_torch, "GRAPH", length=(5, 4, 1))
    start, nbr = tgraph.grid_adjacency(tg)
    hil = tlb.compute_partition("HILBERT", tg, 8, None)
    gra = tlb.compute_partition("GRAPH", tg, 8, None)
    assert tgraph.edge_cut(gra, start, nbr) < tgraph.edge_cut(hil, start, nbr)
    counts = np.bincount(gra, minlength=8)
    assert counts.min() >= 1 and counts.max() <= np.bincount(hil, minlength=8).max()


def test_balance_after_refinement_and_hilbert():
    jg, tg = both(method="HSFC", length=(4, 4, 1), max_ref=1)
    for g in (jg, tg):
        g.refine_completely(1)
        g.refine_completely(16)
        g.stop_refining()
        g.balance_load()
    same_owners(jg, tg)
    counts = np.bincount(tg.get_owner(tg.get_cells()), minlength=8)
    assert counts.max() - counts.min() <= 2
    for nbits in (1, 2, 3):
        n = 1 << nbits
        grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
        key = _hilbert_key(grid, nbits)
        assert len(np.unique(key)) == len(key) == int(key.max()) + 1
        path = grid[np.argsort(key)]
        assert (np.abs(np.diff(path.astype(int), axis=0)).sum(axis=1) == 1).all()
    gh = make_grid(dccrg_tpu_torch, "HILBERT", length=(8, 8, 8), max_ref=1)
    gm = make_grid(dccrg_tpu_torch, "MORTON", length=(8, 8, 8))
    assert (sum(gh.get_ghost_cell_count(d) for d in range(8))
            <= sum(gm.get_ghost_cell_count(d) for d in range(8)))
    gh.refine_completely(1)
    gh.stop_refining()
    gh.balance_load()
    verify_grid(gh)


# ------------------------------------------------------ the staged form

def _staged_pair(pkg, n_dev):
    g = make_grid(pkg, "GRAPH", length=(8, 8, 8), n_dev=n_dev, cell=(1 / 8,) * 3)
    cells = g.get_cells()
    state = g.new_state({"rho": ((), np.float64), "m": ((2,), np.float32)})
    state = g.set_cell_data(state, "rho", cells, np.sin(cells.astype(np.float64)))
    state = g.set_cell_data(state, "m", cells,
                            np.stack([cells, -cells], 1).astype(np.float32))
    return g, state, cells


@pytest.mark.parametrize("n_dev", [4, 8])
def test_staged_balance_equals_one_shot(n_dev):
    """initialize stages the new partition without touching the live grid,
    continue copies chunks on the grid's device, finish commits: owners,
    epoch and every payload row equal the one-shot balance_load +
    remap_state (and the JAX package's staged run)."""
    g1, s1, cells = _staged_pair(dccrg_tpu_torch, n_dev)
    g1.balance_load()
    s1 = g1.remap_state(s1)
    g2, s2, _ = _staged_pair(dccrg_tpu_torch, n_dev)
    old_owner, old_epoch = g2.leaves.owner.copy(), g2.epoch
    g2.initialize_balance_load()
    np.testing.assert_array_equal(g2.leaves.owner, old_owner)
    assert g2.epoch is old_epoch
    chunks = 0
    while g2.continue_balance_load(s2, max_cells=100):
        chunks += 1
    assert chunks >= 5
    out = g2.finish_balance_load()
    assert isinstance(out, dict) and all(v.device == g2.device for v in out.values())
    np.testing.assert_array_equal(g2.leaves.owner, g1.leaves.owner)
    compare_epochs(g2.epoch, g1.epoch)
    for k in s1:
        assert torch.equal(out[k], s1[k]), k
    jg, js, _ = _staged_pair(dccrg_tpu, n_dev)
    jg.initialize_balance_load()
    while jg.continue_balance_load(js, max_cells=100):
        pass
    jout = jg.finish_balance_load()
    same_owners(jg, g2)
    for k in s1:
        np.testing.assert_array_equal(jg.get_cell_data(jout, k, cells),
                                      g2.get_cell_data(out, k, cells))
    s2b = g2.remap_state(s2)
    np.testing.assert_array_equal(g2.get_cell_data(s2b, "rho", cells),
                                  g1.get_cell_data(s1, "rho", cells))


def _staged_unsigned(pkg, n_dev, chunk):
    """A 12x12 board at 30% alive with uint16 / uint32 / uint64 fields of
    every bit, cells 1-29 weighted 4, moved by the staged balance in chunks
    of ``chunk`` cells; returns (grid, migrated state, cells)."""
    g = make_grid(pkg, "RCB", length=(12, 12, 1), n_dev=n_dev)
    cells = g.get_cells()
    rng = np.random.default_rng(3)
    gol = (JGameOfLife if pkg is dccrg_tpu else GameOfLife)(g, allow_dense=False)
    state = gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
    for name, t in (("u16", np.uint16), ("u32", np.uint32), ("u64", np.uint64)):
        vals = rng.integers(0, np.iinfo(t).max, len(cells), dtype=t, endpoint=True)
        more = g.set_cell_data(g.new_state({name: ((), t)}), name, cells, vals)
        state = {**state, **more}
    for c in range(1, 30):
        g.set_cell_weight(c, 4.0)
    g.initialize_balance_load()
    while g.continue_balance_load(state, max_cells=chunk):
        pass
    return g, g.finish_balance_load(state), cells


@pytest.mark.parametrize("chunk", [7, 20])
@pytest.mark.parametrize("n_dev", [4, 8])
def test_staged_balance_moves_unsigned_fields(n_dev, chunk):
    """A Game of Life state (uint32) and uint16 / uint64 fields migrate in
    chunks bitwise as the JAX package's staged balance moves them; the
    board turns on after it as the JAX package's does."""
    tg, ts, cells = _staged_unsigned(dccrg_tpu_torch, n_dev, chunk)
    jg, js, _ = _staged_unsigned(dccrg_tpu, n_dev, chunk)
    same_owners(jg, tg)
    assert not np.array_equal(tg.leaves.owner, np.repeat(np.arange(n_dev), 144 // n_dev))
    for k in js:
        assert ts[k].dtype == getattr(torch, str(np.asarray(js[k]).dtype))
        np.testing.assert_array_equal(tg.get_cell_data(ts, k, cells),
                                      np.asarray(jg.get_cell_data(js, k, cells)))
    tgol, jgol = GameOfLife(tg, allow_dense=False), JGameOfLife(jg, allow_dense=False)
    ts = tgol.run(tg.update_copies_of_remote_neighbors(ts), 3)
    js = jgol.run(jg.update_copies_of_remote_neighbors(js), 3)
    np.testing.assert_array_equal(np.sort(tgol.alive_cells(ts)),
                                  np.sort(np.asarray(jgol.alive_cells(js))))


def test_staged_finish_drains_and_guards():
    g = make_grid(dccrg_tpu_torch, "GRAPH", length=(6, 6, 6), n_dev=4,
                  cell=(1 / 6,) * 3)
    cells = g.get_cells()
    vals = np.cos(cells.astype(np.float64))
    state = g.set_cell_data(g.new_state({"rho": ((), np.float64)}), "rho", cells, vals)
    with pytest.raises(RuntimeError, match="not been called"):
        g.continue_balance_load(state)
    g.initialize_balance_load()
    g.continue_balance_load(state, max_cells=10)
    with pytest.raises(RuntimeError, match="partial"):
        g.finish_balance_load()
    out = g.finish_balance_load(state)
    np.testing.assert_array_equal(g.get_cell_data(out, "rho", cells), vals)
    g.initialize_balance_load()           # already balanced: a no-op stage
    for mutate in (g.balance_load, g.stop_refining,
                   lambda: g.set_cell_weight(1, 2.0),
                   lambda: g.add_neighborhood(3, [(1, 0, 0)])):
        with pytest.raises(RuntimeError, match="in progress"):
            mutate()
    assert g.continue_balance_load(out) is False
    assert g.finish_balance_load(out) is out
    assert g.remap_state(out) is out


# ------------------------------------------- options, levels, reserved names

def _record_partitions(monkeypatch):
    calls = []
    orig = tlb.compute_partition

    def recording(method, grid, n_parts, weights, options=None, adjacency=None):
        calls.append((method.upper(), n_parts,
                      {str(k).upper(): v for k, v in (options or {}).items()}))
        return orig(method, grid, n_parts, weights, options, adjacency)

    monkeypatch.setattr(tlb, "compute_partition", recording)
    return calls


def test_per_level_methods_and_options(monkeypatch):
    tg = make_grid(dccrg_tpu_torch, "RCB", length=(8, 8, 8))
    tg.add_partitioning_level(4)
    tg.add_partitioning_level(1)
    tg.add_partitioning_option(0, "LB_METHOD", "GRAPH")
    tg.add_partitioning_option(0, "IMBALANCE_TOL", 1.05)
    tg.add_partitioning_option(1, "LB_METHOD", "HILBERT")
    tg.add_partitioning_option(1, "IMBALANCE_TOL", 1.2)
    calls = _record_partitions(monkeypatch)
    tg.balance_load()
    assert [(m, n) for m, n, _ in calls] == [("GRAPH", 8), ("HILBERT", 4), ("HILBERT", 4)]
    assert calls[0][2]["IMBALANCE_TOL"] == 1.05
    assert all(c[2]["IMBALANCE_TOL"] == 1.2 for c in calls[1:])
    counts = np.bincount(tg.get_owner(tg.get_cells()), minlength=8)
    assert counts.min() > 0 and counts.max() <= 1.2 * 512 / 8


def test_partitioning_level_defaults(monkeypatch):
    tg = make_grid(dccrg_tpu_torch, "RCB")
    tg.add_partitioning_level(4)
    assert tg.get_partitioning_options(0) == {
        "LB_METHOD": "HYPERGRAPH", "PHG_CUT_OBJECTIVE": "CONNECTIVITY"}
    calls = _record_partitions(monkeypatch)
    tg.balance_load()
    assert calls[0][0] == "HYPERGRAPH" and {c[0] for c in calls[1:]} == {"RCB"}


def test_global_lb_method_override_on_fallthrough(monkeypatch):
    tg = make_grid(dccrg_tpu_torch, "RCB", length=(8, 8, 8))
    tg.set_partitioning_option("LB_METHOD", "GRAPH")
    tg.add_partitioning_level(4)
    tg.add_partitioning_option(0, "LB_METHOD", "HILBERT")
    calls = _record_partitions(monkeypatch)
    tg.balance_load()
    assert [(m, n) for m, n, _ in calls] == [("HILBERT", 8), ("GRAPH", 4), ("GRAPH", 4)]


def test_partitioning_level_and_option_removal():
    tg = make_grid(dccrg_tpu_torch, "RCB")
    tg.add_partitioning_level(4)
    tg.add_partitioning_level(2)
    tg.add_partitioning_option(1, "IMBALANCE_TOL", 1.3)
    tg.remove_partitioning_option(1, "PHG_CUT_OBJECTIVE")
    assert "PHG_CUT_OBJECTIVE" not in tg.get_partitioning_options(1)
    tg.remove_partitioning_option(1, "NOT_THERE")
    tg.remove_partitioning_option(7, "IMBALANCE_TOL")
    tg.remove_partitioning_level(0)
    assert tg._hier_levels == [2]
    assert tg.get_partitioning_options(0)["IMBALANCE_TOL"] == 1.3
    tg.remove_partitioning_level(5)
    assert tg._hier_levels == [2]
    with pytest.raises(ValueError, match="at least 1"):
        tg.add_partitioning_level(0)
    tg.add_partitioning_option(9, "IMBALANCE_TOL", 1.1)
    assert tg.get_partitioning_options(9) == {}


def test_reserved_and_unknown_options():
    tg = make_grid(dccrg_tpu_torch, "RCB")
    tg.add_partitioning_level(4)
    with pytest.raises(ValueError, match="reserved"):
        tg.set_partitioning_option("RETURN_LISTS", "ALL")
    with pytest.raises(ValueError, match="reserved"):
        tg.add_partitioning_option(0, "AUTO_MIGRATE", "1")
    with pytest.warns(UserWarning, match="SOME_BOGUS_KNOB"):
        tg.set_partitioning_option("SOME_BOGUS_KNOB", "7")
    with pytest.warns(UserWarning, match="OTHER_BOGUS_KNOB"):
        tg.add_partitioning_option(0, "OTHER_BOGUS_KNOB", "x")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tg.set_partitioning_option("RCB_RECTILINEAR_BLOCKS", "1")
        tg.balance_load()
    assert tlb.RESERVED_OPTIONS == jlb.RESERVED_OPTIONS


# ----------------------------------------- a model across a balance

@pytest.mark.parametrize("staged", [False, True])
def test_advection_across_balance_bitwise(staged):
    """Gather-path advection, 6 steps, balance (HSFC, refined cells weighted
    2), remap (or staged migration), ghost refresh, 6 steps: bitwise equal
    by cell id to 12 steps without the balance, in both packages; the port
    equal to the JAX package at 1e-12.  The refresh is needed in both:
    remap_state fills owned rows only, and the step reads ghost rows before
    its own exchange."""
    results = {}
    for pkg, Adv in ((dccrg_tpu, JAdvection), (dccrg_tpu_torch, Advection)):
        outs = []
        for balance in (False, True):
            g = make_grid(pkg, "HSFC", length=(8, 8, 8), max_ref=1, hood=0,
                          periodic=(True, True, True), cell=(1 / 8,) * 3)
            refine_ball(g, center=0.35, radius=0.3)
            adv = Adv(g, allow_dense=False) if pkg is dccrg_tpu_torch else Adv(g)
            s = adv.initialize_state()
            dt = 0.4 * adv.max_time_step(s)
            for _ in range(6):
                s = adv.step(s, dt)
            if balance:
                for c in g.get_cells()[g.mapping.get_refinement_level(g.get_cells()) == 1]:
                    g.set_cell_weight(int(c), 2.0)
                if staged and pkg is dccrg_tpu_torch:
                    g.initialize_balance_load()
                    while g.continue_balance_load(s, max_cells=300):
                        pass
                    s = g.finish_balance_load()
                else:
                    g.balance_load()
                    s = g.remap_state(s)
                s = g.update_copies_of_remote_neighbors(s)
                adv = Adv(g, allow_dense=False) if pkg is dccrg_tpu_torch else Adv(g)
            for _ in range(6):
                s = adv.step(s, dt)
            outs.append((g, s))
        (g0, s0), (g1, s1) = outs
        assert not np.array_equal(g0.leaves.owner, g1.leaves.owner)
        c0, v0 = by_id(g0, s0, "density")
        c1, v1 = by_id(g1, s1, "density")
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(v1, v0)
        results[pkg] = (g1, v1)
    same_owners(results[dccrg_tpu][0], results[dccrg_tpu_torch][0])
    np.testing.assert_allclose(results[dccrg_tpu_torch][1], results[dccrg_tpu][1],
                               rtol=1e-12, atol=0)
