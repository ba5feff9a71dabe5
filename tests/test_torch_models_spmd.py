"""Poisson (ROADMAP D4), particles (D5) and the refined advection run's
flat and boxed forms (D2) across controllers on the CPU: real OS
processes, one controller each, on a gloo group, 2 controllers x 4 slots
and 3 x 2.

Each controller runs ``tests/torch_multiproc_worker.py``'s model cases:
the JAX package's multi-controller scenario 6 (the flat voxel BiCG on an
n = D periodic grid, 25 iterations) and scenario 8 (120 particles on a
refined 4x4xD grid, ``run(5)``); Poisson's flat, rolled and gather operator
spaces on a refined grid; the flat operator's A·v and Aᵀ·v with an open and
a periodic z and on three levels; particles through a refinement and an
HSFC ``balance_load`` with ``remap`` (the device re-bucket, and the host
one on a stretched geometry) and ``particles_of``; the ``sharded`` and
``ml`` flat forms and the boxed passes.  Every controller must report the
same result, bitwise equal to the port's one controller on the same slots;
the flat forms' ring bytes are two planes an exchange.

That one controller is held against the JAX package's single-controller
run in this process: scenario 6 at ``tests/test_multiprocess.py``'s
tolerance (rtol 1e-7, atol 1e-10) up to the null space its noise moves
along (see the test), and with a seeded rhs whole; scenario 8 cell by cell as
``tests/test_torch_particles.py::assert_same`` compares the device
re-bucket (float64, bitwise).  The BiCG dots add one partial a slot in slot
order: a multi-slot solve is held against the JAX package at
``tests/test_torch_poisson.py``'s solve tolerance (rtol 1e-10, atol 1e-12,
iterations within 1), and one slot keeps its single sum, bit for bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multiproc_worker.py")
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402


def _launch(nproc, D, wd):
    from dccrg_tpu_torch.parallel import mesh

    results = mesh.launch([sys.executable, WORKER, str(D), wd, "models"], nproc,
                          timeout_s=120)
    return results, W.model_scenarios(mesh.SINGLE, nproc, D)


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def model_runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result, nproc, D).  Under
    xdist the first worker to ask launches the controllers and the others
    read its results (a file lock in the run's shared temporary root), so
    one run starts each layout's processes once."""
    import json

    from filelock import FileLock

    nproc, per = request.param
    D = nproc * per
    if not hasattr(request.config, "workerinput"):
        results, one = _launch(nproc, D, str(tmp_path_factory.mktemp(f"models{nproc}")))
        return results, one, nproc, D
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"models_spmd_{nproc}x{per}.json"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            results, one = json.loads(path.read_text())
        else:
            wd = root / f"models_spmd_{nproc}x{per}"
            wd.mkdir(exist_ok=True)
            results, one = _launch(nproc, D, str(wd))
            path.write_text(json.dumps([results, one]))
    return results, one, nproc, D


def test_controllers_agree(model_runs):
    results = model_runs[0]
    for other in results[1:]:
        assert other == results[0]


@pytest.mark.parametrize("case", sorted(W.MODEL_CASES))
def test_case_equals_one_controller(model_runs, case):
    """Bitwise: the solution by cell id, the iterations and residuals, the
    voxel slabs of A·v and Aᵀ·v, every cell's particle count and
    coordinates, the lost count, the owners after the balance, the density
    by cell id and the mass."""
    results, one = model_runs[0], model_runs[1]
    got, want = dict(results[0][case]), dict(one[case])
    assert want.pop("run_bytes", 0) == 0
    got.pop("run_bytes", None)
    assert got == want


#: the flat forms' ring: (exchanges in a 6-step run: the vz planes once and
#: the density planes each step, bytes of one plane: 8 x 8 f32 voxels for
#: the two-level form, 16 x 16 f64 for three levels)
RING_BYTES = {"adv_sharded_periodic": (7, 8 * 8 * 4), "adv_sharded_open": (7, 8 * 8 * 4),
              "adv_ml": (7, 16 * 16 * 8)}


@pytest.mark.parametrize("case", sorted(RING_BYTES))
def test_flat_forms_ride_the_ring(model_runs, case):
    n, plane = RING_BYTES[case]
    for r in model_runs[0]:
        assert r[case]["run_bytes"] == 2 * n * plane
    for r in model_runs[0]:
        assert r["adv_boxed"]["run_bytes"] > 0


def test_forms_engage(model_runs):
    """The operator spaces and flat kinds each case asked for, on every
    controller: scenario 6's flat operator over all D slots (the JAX
    worker's assertion), the rolled and gather spaces, the ``sharded`` and
    ``ml`` forms; the particle count conserved."""
    results, _, _, D = model_runs
    for res in results:
        assert res["poisson_s6"]["space"] == "flat"
        assert res["poisson_s6"]["n_devices"] == D
        assert res["poisson_s6"]["iterations"] == 25
        for space in ("flat", "rolled", "gather"):
            assert res[f"poisson_{space}"]["space"] == space
            assert res[f"poisson_{space}"]["iterations"] == 30
        assert res["adv_ml"]["kind"] == "ml"
        for case in ("adv_sharded_periodic", "adv_sharded_open", "adv_boxed"):
            assert res[case]["kind"] == "sharded"
        assert (res["particles_s8"]["count"], res["particles_s8"]["lost"]) == (120, 0)
        for case in ("particles_adapt", "particles_host"):
            assert res[case]["count"] + res[case]["lost"] == 150


# ------------------------------------- one controller against the JAX package

def _jgrid(D, length, max_ref=0, hood=0, periodic=(True,) * 3, cell=None):
    import dccrg_tpu

    g = (dccrg_tpu.Grid().set_initial_length(length)
         .set_maximum_refinement_level(max_ref).set_neighborhood_length(hood)
         .set_periodic(*periodic))
    if cell is not None:
        g = g.set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=cell)
    return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))


def _jax_s6(D, rhs_of):
    """The JAX package's scenario-6 solve on D devices, the rhs a function
    of the cell centres: (grid, cells, solution, residual, iterations)."""
    from dccrg_tpu.models import Poisson as JPoisson

    jg = _jgrid(D, (D, D, D), cell=(1.0 / D,) * 3)
    cells = np.sort(jg.leaves.cells)
    jp = JPoisson(jg)
    assert jp._flat is not None
    js = jp.initialize_state(rhs_of(jg.geometry.get_center(cells)))
    jo, jr, ji = jp.solve(js, max_iterations=25, stop_residual=0.0,
                          stop_after_residual_increase=float("inf"))
    return cells, np.asarray(jg.get_cell_data(jo, "solution", cells)), jr, ji


@pytest.mark.parametrize("D", [8, 6])
def test_scenario6_matches_jax(D):
    """The JAX worker's scenario 6 on one controller of D slots (the run
    the controllers equal bitwise) against the JAX package's flat sharded
    solve.  Its rhs, sin(2 pi x) cos(2 pi y), is an eigenvector of the
    uniform operator: BiCG converges in one iteration and the other 24 run
    on rounding noise (residuals ~1e-16), which moves the solution along
    the periodic operator's null space, the constant, by an amount that
    depends on the order of every rounding (a few 1e-3 at D = 8; the JAX
    package's own processes share XLA's order).  So the solution is held
    to the tolerance without its constant, and the residuals as noise."""
    from dccrg_tpu_torch.parallel import mesh

    p, out, res, it = W.poisson_s6(mesh.SINGLE, D)
    assert p.operator_space == "flat" and p._flat_tables["n_devices"] == D
    cells, jsol, jr, ji = _jax_s6(
        D, lambda c: np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1]))
    assert it == ji == 25
    sol = p.grid.get_cell_data(out, "solution", cells)
    np.testing.assert_allclose(sol - sol.mean(), jsol - jsol.mean(),
                               rtol=1e-7, atol=1e-10)
    assert max(res, jr) < 1e-14


@pytest.mark.parametrize("D", [8, 6])
def test_scenario6_grid_seeded_rhs_matches_jax(D):
    """Scenario 6's grid, solver and 25 iterations with a seeded random rhs
    (no eigenvector): the whole solution at ``tests/test_multiprocess.py``'s
    tolerance, the residual at its rel 1e-6."""
    from dccrg_tpu_torch import Poisson
    from dccrg_tpu_torch.parallel import mesh

    g = W._grid(mesh.SINGLE, D, (D, D, D), hood=0, periodic=(True,) * 3,
                cell=(1.0 / D,) * 3)
    cells = np.sort(g.get_cells())
    rhs = np.random.default_rng(0).standard_normal(len(cells))
    p = Poisson(g)
    assert p.operator_space == "flat"
    out, res, it = p.solve(p.initialize_state(rhs), max_iterations=25,
                           stop_residual=0.0, stop_after_residual_increase=float("inf"))
    _, jsol, jr, ji = _jax_s6(D, lambda c: rhs)
    assert it == ji
    np.testing.assert_allclose(g.get_cell_data(out, "solution", cells), jsol,
                               rtol=1e-7, atol=1e-10)
    assert res == pytest.approx(jr, rel=1e-6)


@pytest.mark.parametrize("D", [8, 6])
def test_scenario8_matches_jax(D):
    """The JAX worker's scenario 8 (float64) on one controller of D slots
    against the JAX package's: every cell's count and coordinates
    bitwise, the lost count 0."""
    from dccrg_tpu.models.particles import Particles as JParticles
    from dccrg_tpu_torch.parallel import mesh

    pc, s = W.particles_s8(mesh.SINGLE, D)
    jg = _jgrid(D, (4, 4, D), max_ref=1, hood=1, cell=(0.25, 0.25, 1.0 / D))
    assert jg.refine_completely(int(jg.get_cells()[0]))
    jg.stop_refining()
    jm = JParticles(jg, max_particles_per_cell=64, dtype=np.float64)
    js = jm.new_state(np.random.default_rng(42).uniform(0.0, 1.0, size=(120, 3)))
    js = jm.run(js, 5, velocity=(0.03, 0.02, 0.11), dt=0.5)
    cells = pc.grid.get_cells()
    np.testing.assert_array_equal(cells, jg.get_cells())
    cnt, xyz = W._per_cell(pc, s)
    jpos = jg.leaves.position(cells)
    jd, jr = jg.leaves.owner[jpos], jg.epoch.row_of[jpos]
    jcnt = np.asarray(js["number_of_particles"])[jd, jr]
    jxyz = np.asarray(js["particles"])[jd, jr].copy()
    jxyz[np.arange(jm.P)[None, :] >= jcnt[:, None]] = 0.0
    np.testing.assert_array_equal(cnt, jcnt)
    assert xyz.dtype == jxyz.dtype == np.float64
    np.testing.assert_array_equal(xyz, jxyz)
    assert pc.count(s) == 120 and pc.lost(s) == 0 == int(np.asarray(js["overflow"]))


# ------------------------------------------------------ the BiCG dot order

def _poisson_pair(D, space):
    """The port's and the JAX package's Poisson on the refined 4x4x24 grid
    of D slots in ``space``, with equal states."""
    import dccrg_tpu
    from dccrg_tpu.models import Poisson as JPoisson
    from dccrg_tpu_torch import Poisson
    from dccrg_tpu_torch.convert import rows_state_from_numpy
    from dccrg_tpu_torch.parallel import mesh

    kw = dict(allow_flat=space == "flat", allow_rolled=space == "rolled")
    pg = W.refined_poisson_grid(mesh.SINGLE, D)
    jg = (dccrg_tpu.Grid().set_initial_length((4, 4, 24)).set_maximum_refinement_level(1)
          .set_neighborhood_length(0).set_load_balancing_method("BLOCK")
          .set_periodic(True, True, True)
          .set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(0.25, 0.25, 1 / 24))
          .initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)))
    ids = jg.get_cells()
    jg.refine_completely_many(ids[np.linalg.norm(jg.geometry.get_center(ids) - 0.5,
                                                 axis=1) < 0.2])
    jg.stop_refining()
    np.testing.assert_array_equal(jg.get_cells(), pg.get_cells())
    jp, pp = JPoisson(jg, **kw), Poisson(pg, **kw)
    assert pp.operator_space == space
    js = jp.initialize_state(W._rhs(jg))
    ps = rows_state_from_numpy(pg, {k: np.asarray(v) for k, v in js.items()},
                               jg.epoch.cell_ids)
    return jp, js, pp, ps


@pytest.mark.parametrize("space", ["flat", "rolled", "gather"])
def test_slot_ordered_dot_matches_jax(space):
    """A four-slot solve, its dots a partial a slot added in slot order,
    against the JAX package's solve (its dots one reduction)."""
    jp, js, pp, ps = _poisson_pair(4, space)
    jo, jr, ji = jp.solve(js, max_iterations=200, stop_residual=1e-10)
    po, pr, pi = pp.solve(ps, max_iterations=200, stop_residual=1e-10)
    cells = pp.grid.get_cells()
    assert abs(pi - ji) <= 1
    np.testing.assert_allclose(pp.grid.get_cell_data(po, "solution", cells),
                               np.asarray(jp.grid.get_cell_data(jo, "solution", cells)),
                               rtol=1e-10, atol=1e-12)
    assert pr == pytest.approx(jr, rel=1e-6)


@pytest.mark.parametrize("space", ["flat", "gather"])
def test_one_slot_dot_keeps_its_single_sum(space):
    """One slot: the solve's dots are the single masked sum, bit for bit
    (``bicg_loop`` with that sum as its dot), in the torch loop; and
    float32 on one slot still takes the whole-solve kernel's path."""
    from dccrg_tpu_torch import Poisson
    from dccrg_tpu_torch.ops.poisson_kernel import bicg_loop
    from dccrg_tpu_torch.parallel import mesh

    g = W.refined_poisson_grid(mesh.SINGLE, 1)
    p = Poisson(g, allow_flat=space == "flat")
    assert p.operator_space == space and p._solve_fast is None
    s = p.initialize_state(W._rhs(g))
    out, res, it = p.solve(s, max_iterations=40, stop_residual=0.0,
                           stop_after_residual_increase=float("inf"))
    fwd, rev, lift, project, solve_mask, dot_mask = p._operator_space()
    zero = torch.zeros((), dtype=torch.float64)
    f64 = lambda v: torch.tensor(float(v), dtype=torch.float64)
    bx, bres, bit = bicg_loop(fwd, rev, torch.where(solve_mask, lift(s["rhs"]), zero),
                              lift(s["solution"]), solve_mask,
                              lambda a, b: torch.where(dot_mask, a * b, zero).sum(),
                              40, f64(0.0), f64(float("inf")))
    assert bit == it and float(bres) == res
    want = torch.where(p.tables.local_mask, project(bx), zero)
    assert torch.equal(out["solution"], want)
    assert Poisson(g, dtype=np.float32)._solve_fast is not None
