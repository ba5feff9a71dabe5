"""Split-phase halo (communication/computation overlap) in the port, on the
CPU — tests/test_overlap.py mirrored, against the JAX package's GameOfLife
where the two can be compared: start the ghost transfer, compute the inner
cells, wait, compute the outer cells (reference dccrg.hpp:5010-5367,
examples/game_of_life.cpp:124-138).

The JAX test that reads the overlap off the step's dataflow graph has no
eager-torch counterpart; in its place, the handle's payloads are poisoned
with NaN before the wait, and the inner rows must still equal the blocking
step's: the interior reads no payload.  Tolerance: none (exact).
"""
import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import GameOfLife as JGameOfLife
from dccrg_tpu_torch import GameOfLife
from dccrg_tpu_torch.parallel.stencil import compact_rows


def make_grid(pkg=dccrg_tpu_torch, length=(10, 10, 1), n_dev=8, max_ref=0):
    g = (pkg.Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(1).set_load_balancing_method("RCB"))
    return (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev)) if pkg is dccrg_tpu
            else g.initialize(n_devices=n_dev, device="cpu"))


GLIDER = [35, 36, 37, 27, 16]


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_split_phase_api_matches_blocking_exchange(n_dev):
    """start + wait(handle) leaves ghost rows exactly as the blocking refresh
    does."""
    g = make_grid(n_dev=n_dev)
    state = g.new_state({"v": ((), np.float64)})
    cells = g.get_cells()
    state = g.set_cell_data(state, "v", cells, np.sin(cells.astype(np.float64)))
    blocking = g.update_copies_of_remote_neighbors(state)
    handle = g.start_remote_neighbor_copy_updates(state)
    merged = g.wait_remote_neighbor_copy_updates(state, handle)
    assert torch.equal(blocking["v"], merged["v"])
    assert not torch.equal(state["v"], merged["v"]) or n_dev == 1


def test_inner_compute_unaffected_by_transfer():
    """Inner cells (no remote neighbor) gather only local rows, so their
    results equal the blocking step's."""
    g = make_grid()
    gol_b, gol_o = GameOfLife(g, allow_dense=False), GameOfLife(g, overlap=True)
    state = gol_b.new_state(alive_cells=GLIDER)
    sb, so = gol_b.step(state), gol_o.step(state)
    inner = torch.from_numpy(g.epoch.hoods[None].inner_mask)
    for k in ("is_alive", "live_neighbor_count"):
        assert torch.equal(sb[k][inner], so[k][inner])


@pytest.mark.parametrize("n_dev", [1, 8])
def test_overlap_step_identical_physics(n_dev):
    g, jg = make_grid(n_dev=n_dev), make_grid(dccrg_tpu, n_dev=n_dev)
    gol_b, gol_o = GameOfLife(g, allow_dense=False), GameOfLife(g, overlap=True)
    jo = JGameOfLife(jg, overlap=True)
    sb, so = gol_b.new_state(alive_cells=GLIDER), gol_o.new_state(alive_cells=GLIDER)
    sj = jo.new_state(alive_cells=GLIDER)
    local = torch.from_numpy(g.epoch.local_mask)
    for _ in range(8):
        sb, so, sj = gol_b.step(sb), gol_o.step(so), jo.step(sj)
        alive = set(gol_o.alive_cells(so).tolist())
        assert alive == set(gol_b.alive_cells(sb).tolist())
        assert alive == set(jo.alive_cells(sj).tolist())
        # all local rows identical, counts included
        for k in ("is_alive", "live_neighbor_count"):
            assert torch.equal(sb[k][local], so[k][local])
    # run() takes the split turn too
    assert torch.equal(gol_o.run(so, 3)["is_alive"], gol_b.run(sb, 3)["is_alive"])


def test_overlap_on_refined_grid():
    """The inner/outer split respects AMR neighbor structure too."""
    grids = []
    for pkg in (dccrg_tpu_torch, dccrg_tpu):
        g = make_grid(pkg, length=(8, 8, 1), max_ref=1)
        g.refine_completely(1)
        g.refine_completely(28)
        g.stop_refining()
        grids.append(g)
    g, jg = grids
    gol_b, gol_o = GameOfLife(g), GameOfLife(g, overlap=True)
    jo = JGameOfLife(jg, overlap=True)
    cells = g.get_cells()
    alive0 = cells[np.random.default_rng(3).random(len(cells)) < 0.4]
    sb, so = gol_b.new_state(alive_cells=alive0), gol_o.new_state(alive_cells=alive0)
    sj = jo.new_state(alive_cells=alive0)
    for _ in range(5):
        sb, so, sj = gol_b.step(sb), gol_o.step(so), jo.step(sj)
    alive = set(gol_o.alive_cells(so).tolist())
    assert alive == set(gol_b.alive_cells(sb).tolist()) == set(jo.alive_cells(sj).tolist())


def test_overlap_covers_every_local_cell():
    """The compacted inner and outer row sets partition the local rows; the
    pad lanes are the scratch row."""
    g = make_grid(length=(6, 6, 6))
    gol = GameOfLife(g, overlap=True)
    hood = g.epoch.hoods[None]
    scratch = g.epoch.R - 1
    (ri, *_), (ro, *_) = gol._sides
    for d in range(g.n_devices):
        inner = set(np.flatnonzero(hood.inner_mask[d]).tolist())
        outer = set(np.flatnonzero(hood.outer_mask[d]).tolist())
        local = set(np.flatnonzero(g.epoch.local_mask[d]).tolist())
        assert inner | outer == local and not inner & outer
        assert set(ri[d].tolist()) - {scratch} == inner
        assert set(ro[d].tolist()) - {scratch} == outer
    rows = compact_rows(hood.inner_mask, scratch)
    for d in range(g.n_devices):
        assert set(rows[d].tolist()) - {scratch} == set(np.flatnonzero(hood.inner_mask[d]).tolist())


def test_stale_split_phase_convention_raises():
    """The pre-handle calling convention (the start() result where a state
    belongs) fails loudly instead of exchanging garbage."""
    g = make_grid()
    state = g.new_state({"v": ((), np.float64)})
    handle = g.start_remote_neighbor_copy_updates(state)
    with pytest.raises(TypeError, match="HaloHandle"):
        g.wait_remote_neighbor_copy_updates(handle)          # old pattern
    with pytest.raises(TypeError, match="HaloHandle"):
        g.wait_remote_neighbor_copy_updates(state, state)    # swapped args
    with pytest.raises(TypeError, match="HaloHandle"):
        g.start_remote_neighbor_copy_updates(handle)
    with pytest.raises(TypeError, match="HaloHandle"):
        g.halo().finish(handle, handle)


def _refined(n_dev):
    g = (dccrg_tpu_torch.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(dccrg_tpu_torch.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 8,) * 3)
         .initialize(n_devices=n_dev, device="cpu"))
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
    g.stop_refining()
    return g


def _poison_payloads(monkeypatch, ex):
    """Make ``ex.finish`` see every payload as NaN (the interior ran
    before it)."""
    real = ex.finish

    def finish(state, handle):
        for p in handle.payload.values():
            p.fill_(float("nan"))
        return real(state, handle)

    monkeypatch.setattr(ex, "finish", finish)


@pytest.mark.parametrize("model", ["advection", "vlasov"])
def test_interior_reads_no_payload(monkeypatch, model):
    """Payloads poisoned with NaN before the wait: the split step's inner
    rows still equal the blocking step's, its outer rows do not (two slots:
    eight slots of 8^3 are one plane each and have no inner cell)."""
    g = _refined(2)
    if model == "advection":
        eager = dccrg_tpu_torch.Advection(g, allow_dense=False)
        split = dccrg_tpu_torch.Advection(g, allow_dense=False, overlap=True)
        state = eager.initialize_state()
        dt = 0.4 * eager.max_time_step(state)
        key = "density"
    else:
        eager = dccrg_tpu_torch.Vlasov(g, nv=2, dtype=np.float64)
        split = dccrg_tpu_torch.Vlasov(g, nv=2, dtype=np.float64, overlap=True)
        state = eager.initialize_state()
        dt = 0.4 * eager.max_time_step()
        key = "f"
    want = eager.step(state, dt)[key]
    _poison_payloads(monkeypatch, split._exchange)
    got = split.step(state, dt)[key]
    hood = g.epoch.hoods[None]
    inner, outer = (torch.from_numpy(m) for m in (hood.inner_mask, hood.outer_mask))
    assert inner.any() and outer.any()
    assert torch.equal(got[inner], want[inner])
    assert torch.isnan(got[outer]).any()
