"""The checkpoint lineage and ``rescale`` (ROADMAP D9) across controllers on
the CPU: real OS processes, one controller each, on a gloo group.

Each controller runs ``tests/torch_multiproc_worker.py``'s lineage case on
the gather Advection (f64, a refined periodic 6^3 grid): two commits and
``latest_valid``; a commit whose file is torn on the writer (controller 0),
which every controller must refuse with the same ``CheckpointError``; a
torn newest generation, which every controller must skip to the same
earlier one and salvage alike; ``rescale`` from 8 slots to 4 (2 x 4 -> 2 x
2) and from 6 to 12 (3 x 2 -> 3 x 4), and two steps after it.  Then a run
killed by ``sigkill.post_commit`` on controller 1 right after its second
commit, relaunched from ``latest_valid``.  Every controller must report the
same result, bitwise equal to the port's one controller on the same slots
(the killed run: to the uninterrupted one).

That one controller is held against the JAX package: its rescale from 8
slots to 4 against the JAX ``rescale``'s leaves, owners and fields (the
fields at ``tests/test_torch_elastic.py``'s 1e-11).  The JAX package's tests
run on 8 virtual CPU devices, so its ``rescale`` cannot land on 12: the 6 ->
12 re-landing is held against the JAX package's leaves and fields at the
same point and its partitioner's RCB owners on 12 parts, which its loader's
``balance_load`` would compute.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402

#: (controllers, slots a controller, the rescale's slot count)
LAYOUTS = [(2, 4, 4), (3, 2, 12)]


@pytest.fixture(scope="module", params=LAYOUTS, ids=["2x4_to_2x2", "3x2_to_3x4"])
def lineage_runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result, nproc, target)."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per, target = request.param
    D = nproc * per

    def run(wd):
        return [W.launch("lineage", nproc, D, wd, target),
                W.lineage_case(mesh.SINGLE, D, target, wd)]

    got = W.shared_run(request, tmp_path_factory, f"lineage_spmd_{nproc}x{per}", run)
    return got[0], got[1], nproc, target


def _shared(rec):
    return {k: v for k, v in rec.items() if k != "local_slots"}


def test_controllers_agree_and_hold_their_slots(lineage_runs):
    results, one, nproc, target = lineage_runs
    per = target // nproc
    for rank, r in enumerate(results):
        assert _shared(r) == _shared(results[0])
        assert r["local_slots"] == [rank * per, (rank + 1) * per]
    assert one["local_slots"] == [0, target]


@pytest.mark.parametrize("part", ["commit", "rejected", "torn", "salvage", "rescale",
                                  "after"])
def test_lineage_equals_one_controller(lineage_runs, part):
    """Bitwise: the generations and headers, the rejection, the skip, the
    re-landed leaves, owners and fields by cell id, two steps after."""
    results, one = lineage_runs[0], lineage_runs[1]
    assert results[0][part] == one[part]


def test_lineage_outcomes(lineage_runs):
    """Generations 1 and 2 committed and generation 2 resumed; the torn
    commit refused (section ``lineage``) without a generation; generation 3
    torn after its commit and skipped back to 2, and salvaged with the
    cells its lost half held; the rescale commits 4."""
    results, _, nproc, target = lineage_runs
    r = results[0]
    assert r["commit"] == [1, 2, 2, "4"]
    assert r["rejected"] == "lineage"
    assert r["torn"] == [3, 2, "4"]
    assert r["salvage"][:2] == [3, "4b"] and r["salvage"][2] > 0
    re = r["rescale"]
    assert (re["generation"], re["after"]) == (4, target)
    assert re["direction"] == ("down" if target < re["before"] else "up")


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)], ids=["2proc_x4slots",
                                                              "3proc_x2slots"])
def killed_runs(request, tmp_path_factory):
    """The run killed on controller 1 after its second commit (the launch
    fails), its relaunch, and the uninterrupted one-controller run."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per

    def run(wd):
        try:
            W.launch("kill", nproc, D, wd)
            killed = "completed"
        except RuntimeError as e:
            killed = str(e).splitlines()[0]
        files = sorted(os.listdir(os.path.join(wd, "killed")))
        return [killed, files, W.launch("resume", nproc, D, wd),
                W.lineage_run(mesh.SINGLE, D, wd, "one")]

    return W.shared_run(request, tmp_path_factory, f"lineage_kill_{nproc}x{per}", run)


def test_killed_controller_leaves_a_whole_generation(killed_runs):
    killed, files = killed_runs[0], killed_runs[1]
    assert killed == "controller 1 exited with -9"
    assert files == ["MANIFEST.json", "gen-000001.dc", "gen-000002.dc"]


def test_resumed_run_equals_uninterrupted(killed_runs):
    """The density by cell id bitwise; the mass, a sum over the slot rows
    of a layout the re-landing repartitioned, to rounding."""
    resumed, one = killed_runs[2], killed_runs[3]
    for r in resumed:
        assert r["resumed_gen"] == 2
        assert r["density"] == one["density"]
        assert r["mass"] == pytest.approx(one["mass"], rel=1e-13)


def test_rescale_slot_count_must_divide_over_controllers(tmp_path):
    """A slot count the controllers do not divide raises before anything is
    committed, naming both numbers."""
    from dccrg_tpu_torch import Grid
    from dccrg_tpu_torch.parallel.mesh import Controllers
    from dccrg_tpu_torch.resilience import rescale

    ctl = Controllers(rank=0, size=2, backend="gloo", device=torch.device("cpu"))
    g = (Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(0)
         .initialize(n_devices=2, device="cpu", controllers=ctl))
    with pytest.raises(ValueError, match="3 slots do not divide over 2 controllers"):
        rescale(g, {}, {}, 3, directory=str(tmp_path))
    assert not os.listdir(tmp_path)


# ------------------------------------- one controller against the JAX package

def _jax_lineage_state(D):
    """The JAX package's run of ``lineage_setup`` to the rescale point (two
    and two gather steps): (grid, model, state)."""
    import dccrg_tpu
    from dccrg_tpu.models import Advection as JAdvection

    g = (dccrg_tpu.Grid().set_initial_length((6, 6, 6)).set_maximum_refinement_level(1)
         .set_neighborhood_length(0).set_load_balancing_method("RCB")
         .set_periodic(True, True, True)
         .set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 6,) * 3)
         .initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)))
    g.refine_completely_many(g.get_cells()[:70:7])
    g.stop_refining()
    adv = JAdvection(g, allow_dense=False)
    s = adv.initialize_state()
    dt = 0.3 * adv.max_time_step(s)
    for _ in range(4):
        s = adv.step(s, dt)
    return g, adv, s


def _port_rescaled(D, target, wd):
    """The port's one controller through ``lineage_setup``, four steps and
    ``rescale`` to ``target``: the re-landed grid and state."""
    from dccrg_tpu_torch.parallel import mesh
    from dccrg_tpu_torch.resilience import rescale

    g, adv, s, dt = W.lineage_setup(mesh.SINGLE, D)
    s = adv.run(s, 4, dt)
    return rescale(g, s, W.LINEAGE_SPEC, target, directory=wd)


def _fields_close(pg, ps, jg, js, ids):
    for f in W.LINEAGE_SPEC:
        want = np.asarray(jg.get_cell_data(js, f, ids), np.float64)
        np.testing.assert_allclose(pg.get_cell_data(ps, f, ids), want, rtol=1e-11,
                                   atol=1e-11 * np.abs(want).max())


def test_rescale_8_to_4_matches_jax(tmp_path):
    from dccrg_tpu.resilience import rescale as jrescale

    r = _port_rescaled(8, 4, str(tmp_path / "port"))
    jg, _, js = _jax_lineage_state(8)
    jr = jrescale(jg, js, W.LINEAGE_SPEC, 4, directory=str(tmp_path / "jax"))
    ids = r.grid.get_cells()
    np.testing.assert_array_equal(ids, jr.grid.get_cells())
    np.testing.assert_array_equal(r.grid.leaves.owner, jr.grid.leaves.owner)
    assert (r.n_devices_after, r.direction) == (jr.n_devices_after, jr.direction)
    _fields_close(r.grid, r.state, jr.grid, jr.state, ids)


def test_rescale_6_to_12_matches_jax_leaves_owners_fields(tmp_path):
    from dccrg_tpu.parallel.loadbalance import compute_partition

    r = _port_rescaled(6, 12, str(tmp_path))
    jg, _, js = _jax_lineage_state(6)
    ids = r.grid.get_cells()
    np.testing.assert_array_equal(ids, jg.get_cells())
    np.testing.assert_array_equal(r.grid.leaves.owner,
                                  compute_partition("RCB", jg, 12, None))
    assert r.n_devices_after == 12
    _fields_close(r.grid, r.state, jg, js, ids)
