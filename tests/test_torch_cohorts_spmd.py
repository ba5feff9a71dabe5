"""Cohorts (ROADMAP D7) across controllers on the CPU: real OS processes,
one controller each, on a gloo group, 2 controllers x 4 slots and 3 x 2.

Each controller runs ``tests/torch_multiproc_worker.py``'s cohort cases
through ``Ensemble`` with the solo-replay oracle on, over member stacks of
its own slots: the dense slab ring of member stacks (B2, B3, the plain f64
step, B7 in its explicit-edge mode: the twins on the CPU), the split-phase
Advection and Game of Life cohorts (``MemberExchange`` on member tables,
B9's twin), the exchange-amortized wide step, and a deadline ``Ensemble`` of
eight scenarios in two cohorts whose deadlines each controller reads off
its own clock (controller 0 decides the ticks).  Every member must retire
bitwise equal to its solo run on the same controller, every controller must
report the same members, and they must equal the port's one controller on
the same slots bitwise.  One member-batched step crosses the transport once
for all W members: W times a solo step's bytes, in one grouped pack and
one merge (B9's twin twice) on the split cohorts.  The member ring's
planes equal one controller's roll, all W members in one batch of two
messages.

That one controller is held against the JAX package's cohorts at
``tests/test_torch_ensemble.py``'s tolerances: the plain f64 dense cohort
to 1e-12, the Game of Life split cohort exactly.
"""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402

#: the members of the one-cohort cases (``cohort_case``'s W)
MEMBERS = 4
#: the per-controller fields of a case's record (bytes a controller sends)
PER_CONTROLLER = ("bytes_first_step", "solo_step_bytes")


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def cohort_runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result)."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per

    def run(wd):
        return [W.launch("cohorts", nproc, D, wd),
                W.cohort_scenarios(mesh.SINGLE, nproc, D)]

    return W.shared_run(request, tmp_path_factory, f"cohorts_spmd_{nproc}x{per}", run)


def _shared(rec):
    if not isinstance(rec, dict):
        return rec
    return {k: v for k, v in rec.items() if k not in PER_CONTROLLER}


def test_controllers_agree(cohort_runs):
    results = cohort_runs[0]
    for other in results[1:]:
        assert {k: _shared(v) for k, v in other.items()} == \
            {k: _shared(v) for k, v in results[0].items()}


@pytest.mark.parametrize("case", sorted(W.COHORT_CASES))
def test_members_equal_one_controller(cohort_runs, case):
    """Every member's result bitwise (every slot), the form, no oracle
    mismatch."""
    results, one = cohort_runs
    assert _shared(results[0][case]) == _shared(one[case])
    assert one[case]["mismatches"] == 0


def test_member_ring_equals_one_controller(cohort_runs):
    results, one = cohort_runs
    assert results[0]["ring"] == one["ring"]


#: the cases whose cohort crosses the transport: (B9 twin calls of one
#: member-batched step: two for the split cohorts' pack and merge, none on
#: the dense ring)
CROSSING = {"dense_blocked": 0, "dense_plane": 0, "dense_plain": 0, "dense_vlasov": 0,
            "split": 2, "gol_overlap": 2}


@pytest.mark.parametrize("case", sorted(CROSSING))
def test_one_crossing_carries_every_member(cohort_runs, case):
    """One member-batched step sends exactly W solo steps' bytes, in the
    same number of B9 launches as one member's step."""
    results, one = cohort_runs
    assert one[case]["bytes_first_step"] == 0
    for r in results:
        rec = r[case]
        assert rec["solo_step_bytes"] > 0
        assert rec["bytes_first_step"] == MEMBERS * rec["solo_step_bytes"]
        assert rec["twins_first_step"] == CROSSING[case]


def test_forms_engage(cohort_runs):
    r = cohort_runs[0][0]
    assert r["dense_blocked"]["form"][0] == "blocked_direct"
    assert r["dense_plane"]["form"] == ["plane"]
    assert r["dense_plain"]["form"] == ["xla"]
    assert r["dense_vlasov"]["form"] > 0
    assert r["split"]["kind"] == "advection.split"
    assert r["gol_overlap"]["kind"] == "gol.overlap"
    assert r["wide"]["wide"] and r["wide"]["budget"] >= 2
    assert r["deadline"]["cohorts"] == 2 and len(r["deadline"]["members"]) == 8


# ------------------------------------- one controller against the JAX package

def _jax_grid(D, length, hood, periodic, cell=None):
    import dccrg_tpu

    g = (dccrg_tpu.Grid().set_initial_length(length).set_neighborhood_length(hood)
         .set_load_balancing_method("RCB").set_periodic(*periodic))
    if cell is not None:
        g = g.set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=cell)
    return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))


@pytest.mark.parametrize("D", [8, 6])
def test_one_controller_dense_cohort_matches_jax(D):
    """The plain f64 dense cohort of ``cohort_case`` (one member) against
    the JAX package's dense cohort on the same grid to 1e-12."""
    import dccrg_tpu.serve as JS
    from dccrg_tpu.models import Advection as JAdvection
    from dccrg_tpu_torch.parallel import mesh
    from dccrg_tpu_torch.serve import Ensemble

    adv, s0, dt = W.adv_setup(mesh.SINGLE, D, "plain", True)
    ens = Ensemble()
    t = ens.submit(adv, s0, steps=5, dt=dt)
    ens.run()
    nz = W.ADV_FORMS["plain"][0](D)
    jg = _jax_grid(D, (6, 5, nz), 0, (True,) * 3, (1 / 6, 1 / 5, 1 / nz))
    ja = JAdvection(jg)
    assert ja.dense is not None
    cells = adv.grid.get_cells()
    js = ja.initialize_state()
    js = ja.set_cell_data(js, "vz", cells, adv.get_cell_data(s0, "vz", cells))
    jens = JS.Ensemble()
    jt = jens.submit(ja, js, steps=5, dt=dt)
    jens.run()
    want = np.asarray(ja.get_cell_data(jt.result, "density", cells))
    np.testing.assert_allclose(adv.get_cell_data(t.result, "density", cells), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("D", [8, 6])
def test_one_controller_gol_split_cohort_matches_jax(monkeypatch, D):
    """The Game of Life split-phase cohort of ``cohort_case`` (one member)
    against the JAX package's, exactly."""
    import dccrg_tpu.serve as JS
    from dccrg_tpu.models import GameOfLife as JGameOfLife
    from dccrg_tpu_torch.parallel import mesh
    from dccrg_tpu_torch.serve import Ensemble

    g, _, gol, s0, _ = W.split_models(mesh.SINGLE, D, "gol")
    ens = Ensemble(steps_per_dispatch=3)
    t = ens.submit(gol, s0, steps=7)
    ens.run()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jg = _jax_grid(D, (12, 12, 1), 1, (False,) * 3)
    jgol = JGameOfLife(jg, overlap=True)
    cells = g.get_cells()
    alive = cells[g.get_cell_data(s0, "is_alive", cells) > 0]
    jens = JS.Ensemble(steps_per_dispatch=3)
    jt = jens.submit(jgol, jgol.new_state(alive_cells=alive), steps=7)
    jens.run()
    for name in W.SPLIT_FIELDS["gol"]:
        np.testing.assert_array_equal(g.get_cell_data(t.result, name, cells),
                                      np.asarray(jg.get_cell_data(jt.result, name, cells)))
