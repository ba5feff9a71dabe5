"""The port's multi-controller runs on the CPU: real OS processes, one
controller each, on a gloo group (``dccrg_tpu_torch.parallel.mesh``),
2 controllers x 4 slots and the reference suite's odd shape, 3 x 2.

Each controller runs ``tests/torch_multiproc_worker.py``: the JAX
package's multi-controller scenarios 1-5, 7 and 9 (``tests/
multiproc_worker.py``: blinker, per-controller AMR requests, ghost
bit-identity with three fields, per-slot halo telemetry, pins, checkpoint
fan-in and reload, point-to-point ``some_reduce``, enforced agreement) and
the gather advection with per-controller adaptation and balance.  Every
controller must report the same result, equal to the port's one-controller
run of the same scenarios and to the JAX package's single-controller run
in this process (8 CPU devices), to the tolerances of
``tests/test_multiprocess.py``.  The worker also holds two repairs:
per-controller unrefines of one sibling family commit one parent (C2),
and the staged balance migrates unsigned fields (C3).  Scenarios 6 (flat
Poisson) and 8 (particles), with Poisson's other operator spaces, the
particles' remap and the refined advection run's flat and boxed forms, are
``tests/test_torch_models_spmd.py``; the dense slab ring's cases are
``tests/test_torch_dense_ring.py``.
"""
import hashlib
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multiproc_worker.py")
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402


def _hash(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result, nproc, D)."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per
    wd = str(tmp_path_factory.mktemp(f"mp{nproc}"))
    results = mesh.launch([sys.executable, WORKER, str(D), wd], nproc,
                          timeout_s=120)
    one = W.scenarios(mesh.SINGLE, nproc, D, wd)
    return results, one, nproc, D


def test_controllers_agree(runs):
    results = runs[0]
    for other in results[1:]:
        assert other == results[0]


def test_equals_one_controller(runs):
    """Bitwise: alive sets, leaf ids, owners, ghost rows, telemetry sums,
    the checkpoint file's bytes, the advection density."""
    results, one, nproc, D = runs
    got = dict(results[0])
    assert got.pop("agreement") == {"neighborhood": "raised",
                                    "initialize": "raised"}
    clique = got["some_reduce"].pop("clique")
    assert clique == sum(10 ** p for p in range(nproc))
    assert got == one


def test_pins_honored_across_controllers(runs):
    res = runs[0][0]
    assert res["pins"]["first_owner"] == res["n_devices"] - 1
    assert res["pins"]["last_owner"] == 0
    assert res["ghost"]["verify"] == "ok"


def _jax_grid(length, D, max_ref=0):
    from dccrg_tpu import Grid, make_mesh

    return (Grid().set_initial_length(length)
            .set_maximum_refinement_level(max_ref).set_neighborhood_length(1)
            .set_load_balancing_method("RCB")
            .initialize(mesh=make_mesh(n_devices=D)))


def test_matches_jax_single_controller(runs, tmp_path):
    """The JAX package's single-controller run of scenarios 1, 2, 3b, 4, 5
    and 7 on D CPU devices."""
    from dccrg_tpu.io.checkpoint import save_grid_data
    from dccrg_tpu.models import GameOfLife
    from dccrg_tpu.utils.collectives import some_reduce

    res, nproc, D = runs[0][0], runs[2], runs[3]
    grid = _jax_grid((10, 10, 1), D)
    gol = GameOfLife(grid)
    state = gol.new_state(alive_cells=[54, 55, 56])
    for turn in range(4):
        state = gol.step(state)
        assert res["blinker"][turn] == sorted(int(c) for c in gol.alive_cells(state))
    counts = np.asarray([grid.get_local_cell_count(d) for d in range(D)], np.uint64)
    assert res["some_reduce"]["device0"] == int(some_reduce(grid, counts, 0))

    g2 = _jax_grid((4, 4, 2), D, max_ref=2)
    spec = {"rho": ((), np.float64)}
    st = g2.new_state(spec)
    cells = g2.get_cells()
    st = g2.set_cell_data(st, "rho", cells, np.arange(1.0, len(cells) + 1))
    for c in range(3, 3 + nproc):
        assert g2.refine_completely(c)
    g2.stop_refining()
    st = g2.remap_state(st, policy={"rho": {"refine": "inherit"}})
    ids = np.sort(g2.leaves.cells)
    assert res["amr"]["n_leaves"] == len(ids)
    assert res["amr"]["ids_hash"] == _hash(ids)
    assert res["amr"]["mass1"] == pytest.approx(
        float((np.asarray(st["rho"]) * g2.epoch.local_mask).sum()))
    pc = g2.epoch.hoods[None].pair_counts
    assert res["telemetry"]["halo_send_cells"] == pc.sum(axis=1).tolist()
    assert res["telemetry"]["halo_recv_cells"] == pc.sum(axis=0).tolist()
    assert res["telemetry"]["halo_bytes_moved"] == int(pc.sum()) * 8

    assert g2.pin(int(ids[0]), D - 1)
    assert g2.pin(int(ids[-1]), 0)
    g2.balance_load()
    st = g2.remap_state(st)
    assert res["pins"]["owners_hash"] == _hash(np.asarray(g2.leaves.owner, np.int64))
    assert res["pins"]["mass2"] == pytest.approx(
        float((np.asarray(st["rho"]) * g2.epoch.local_mask).sum()))
    path = str(tmp_path / "jax.dc")
    save_grid_data(g2, st, path, spec, user_header=b"mp-test")
    with open(path, "rb") as f:
        assert res["ckpt"]["file_hash"] == _hash(np.frombuffer(f.read(), np.uint8))


def test_unrefine_families_commit_one_parent(runs):
    """C2: controllers that queue different children of one family (and
    the same child of another) commit one parent a family: 32 leaves, the
    one controller's leaves, owners and "mean" / "sum" parents, and the
    JAX package's single-controller run with one child queued a family."""
    from dccrg_tpu.utils.verify import verify_grid

    res, nproc, D = runs[0][0], runs[2], runs[3]
    got = res["unrefine_families"]
    assert got["n_leaves"] == 32
    g = _jax_grid((4, 4, 2), D, max_ref=1)
    for cell, _ in W.C2_FAMILIES:
        assert g.refine_completely(cell)
    g.stop_refining()
    cells = g.get_cells()
    spec = {"rho": ((), np.float64), "q": ((), np.float64)}
    st = g.new_state(spec)
    st = g.set_cell_data(st, "rho", cells, np.sin(cells.astype(np.float64)))
    st = g.set_cell_data(st, "q", cells, np.cos(3.0 * cells.astype(np.float64)))
    for cell, child in W.C2_FAMILIES:
        kids = g.mapping.get_all_children(np.asarray([cell], np.uint64))[0]
        assert g.unrefine_completely(int(kids[child(0)]))
    g.stop_refining()
    st = g.remap_state(st, policy={"rho": {"unrefine": "mean"},
                                   "q": {"unrefine": "sum"}})
    verify_grid(g)
    ids = g.get_cells()
    want = {"ids": _hash(ids), "owner": _hash(np.asarray(g.leaves.owner, np.int64)),
            "rho": _hash(np.asarray(g.get_cell_data(st, "rho", ids))),
            "q": _hash(np.asarray(g.get_cell_data(st, "q", ids))),
            "n_leaves": int(len(ids))}
    assert got == want


def test_staged_unsigned_fields_match_jax(runs):
    """C3: the staged balance in chunks of 20 cells moves a Game of Life
    state and uint16 / uint32 / uint64 fields across controllers bitwise
    as the JAX package's staged balance does on one; the board turns on
    after it as the JAX package's does."""
    from dccrg_tpu.models import GameOfLife

    res, D = runs[0][0], runs[3]
    got = res["staged_unsigned"]
    g = _jax_grid((12, 12, 1), D)
    cells = g.get_cells()
    rng = np.random.default_rng(3)
    gol = GameOfLife(g, allow_dense=False)
    st = gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
    extra = {k: rng.integers(0, np.iinfo(t).max, len(cells), dtype=t, endpoint=True)
             for k, t in W.C3_FIELDS.items()}
    more = g.new_state({k: ((), t) for k, t in W.C3_FIELDS.items()})
    for k, v in extra.items():
        more = g.set_cell_data(more, k, cells, v)
    st = {**st, **more}
    for c in range(1, 30):
        g.set_cell_weight(c, 4.0)
    g.initialize_balance_load()
    while g.continue_balance_load(st, max_cells=20):
        pass
    st = g.finish_balance_load(st)
    want = {"owner": _hash(np.asarray(g.leaves.owner, np.int64))}
    for k in st:
        want[k] = _hash(np.asarray(g.get_cell_data(st, k, cells)))
    assert want["u64"] == _hash(extra["u64"])
    gol = GameOfLife(g, allow_dense=False)
    st = gol.run(g.update_copies_of_remote_neighbors(st), 2)
    want["alive"] = _hash(np.sort(np.asarray(gol.alive_cells(st))))
    assert got == want
