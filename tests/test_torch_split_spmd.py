"""The split-phase steps (ROADMAP D6) across controllers on the CPU: real
OS processes, one controller each, on a gloo group, 2 controllers x 4
slots and 3 x 2.

Each controller runs ``tests/torch_multiproc_worker.py``'s split cases on
B9's twin (``DCCRG_HALO_BACKEND=pallas``): Advection (f64), Vlasov (f32
with a periodic z, f64 with an open one) on a refined grid, and Game of
Life on a 12 x 12 board, ``overlap=True``.  Every split step must equal
the blocking gather step on the same controller bitwise, every controller
must report the same result, and that result must equal the port's one
controller on the same slots bitwise; a split step is two B9 launches
(the pack with the post, the merge after the wait) a controller.

That one controller is held against the JAX package's split step
(``overlap=True``, its collective backend) at the tolerances of
``tests/test_torch_halo_backends.py``: Advection to 1e-12 (f64), Vlasov
within 4 ULP (f32) or 1e-12 (f64), Game of Life exactly.
"""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def split_runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result)."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per

    def run(wd):
        return [W.launch("split", nproc, D, wd),
                W.split_scenarios(mesh.SINGLE, nproc, D)]

    return W.shared_run(request, tmp_path_factory, f"split_spmd_{nproc}x{per}", run)


def test_controllers_agree(split_runs):
    results = split_runs[0]
    for other in results[1:]:
        assert other == results[0]


@pytest.mark.parametrize("case", sorted(W.SPLIT_CASES))
def test_split_equals_one_controller(split_runs, case):
    """Bitwise by cell id; two B9 launches a split step; inner rows exist
    on the layout (the split is not all outer)."""
    results, one = split_runs
    assert results[0][case] == one[case]
    assert one[case]["twins_per_step"] == 2 and one[case]["inner"]


# ------------------------------------- one controller against the JAX package

def _jax_models(monkeypatch, D, kind, dtype, periodic):
    """The JAX package's grid and split model built as
    ``torch_multiproc_worker.split_models`` builds the port's."""
    import dccrg_tpu
    from dccrg_tpu.models import Advection as JAdvection
    from dccrg_tpu.models import GameOfLife as JGameOfLife
    from dccrg_tpu.models import Vlasov as JVlasov

    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    mesh = dccrg_tpu.make_mesh(n_devices=D)
    if kind == "gol":
        g = (dccrg_tpu.Grid().set_initial_length((12, 12, 1)).set_neighborhood_length(1)
             .set_load_balancing_method("RCB").set_periodic(False, False, False)
             .initialize(mesh=mesh))
        return g, JGameOfLife(g, overlap=True)
    length = (8, 8, 12)
    pz = True if kind == "advection" else periodic
    g = (dccrg_tpu.Grid().set_initial_length(length).set_maximum_refinement_level(1)
         .set_neighborhood_length(0).set_load_balancing_method("RCB")
         .set_periodic(True, True, pz)
         .set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n for n in length))
         .initialize(mesh=mesh))
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5,
                                                axis=1) < 0.3])
    g.stop_refining()
    if kind == "advection":
        return g, JAdvection(g, dtype=np.float64, allow_dense=False, overlap=True)
    return g, JVlasov(g, nv=2, dtype=dtype, overlap=True)


SPLIT_JAX = {"advection": ("advection", np.float64, True),
             "vlasov_f32_periodic": ("vlasov", np.float32, True),
             "vlasov_f64_open": ("vlasov", np.float64, False),
             "gol": ("gol", None, None)}


@pytest.mark.parametrize("D", [8, 6])
@pytest.mark.parametrize("case", sorted(SPLIT_JAX))
def test_one_controller_split_matches_jax(monkeypatch, case, D):
    from dccrg_tpu_torch.parallel import mesh

    kind, dtype, periodic = SPLIT_JAX[case]
    jg, jm = _jax_models(monkeypatch, D, kind, dtype, periodic)
    g, _, pm, s, dt = W.split_models(mesh.SINGLE, D, kind, dtype or np.float64,
                                     bool(periodic))
    ids = g.get_cells()
    np.testing.assert_array_equal(ids, jg.get_cells())
    np.testing.assert_array_equal(g.leaves.owner, jg.leaves.owner)
    if kind == "gol":
        alive = ids[g.get_cell_data(s, "is_alive", ids) > 0]
        js = jm.new_state(alive_cells=alive)
    else:
        js = jm.initialize_state()
    for _ in range(3):
        if kind == "gol":
            s, js = pm.step(s), jm.step(js)
        else:
            s, js = pm.step(s, dt), jm.step(js, dt)
        for name in W.SPLIT_FIELDS[kind]:
            got = g.get_cell_data(s, name, ids)
            want = np.asarray(jg.get_cell_data(js, name, ids))
            if kind == "gol":
                np.testing.assert_array_equal(got, want)
            elif dtype == np.float32:
                np.testing.assert_array_max_ulp(got, want.astype(np.float32), maxulp=4)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12,
                                           atol=1e-12 * np.abs(want).max())
