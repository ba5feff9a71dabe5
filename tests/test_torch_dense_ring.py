"""The dense slab ring across controllers (``parallel/dense.py::HaloExtend``
in its controller form) on the CPU: real OS processes, one controller
each, on a gloo group, 2 controllers x 4 slots and 3 x 2.

Each controller runs ``tests/torch_multiproc_worker.py``'s dense cases:
dense advection through kernel B2's twin (``blocked_direct``), kernel B3's
(``plane``) and the plain f64 step, each on a periodic and an open z; the
dense 2-D board on an open and a periodic y; dense Vlasov through kernel
B7's twin in its explicit-edge mode (f32, open z) and the plain f64 step;
Vlasov's gather step on a refined 8^3 grid; and ``adapt_grid`` from a
dense grid.  Every controller must report the same result, bitwise equal
to the port's one controller on the same slots; the ring's bytes are its
planes, two an exchange.  That one controller is held against the JAX
package's single-controller run in this process (8 CPU devices) to the
tolerances of ``tests/test_torch_advection.py`` (f64 rtol 1e-13, f32
rtol 2e-7 a step, 1e-6 a run) and ``tests/test_torch_vlasov.py`` (f64 rtol
1e-12, f32 within 4 ULP a step), the board and the leaves exactly.
"""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multiproc_worker.py")
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def dense_runs(request, tmp_path_factory):
    """(controllers' results, the one-controller result, nproc, D)."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per
    wd = str(tmp_path_factory.mktemp(f"dense{nproc}"))
    results = mesh.launch([sys.executable, WORKER, str(D), wd, "dense"], nproc,
                          timeout_s=120)
    one = W.dense_scenarios(mesh.SINGLE, nproc, D)
    return results, one, nproc, D


def test_controllers_agree(dense_runs):
    results = dense_runs[0]
    for other in results[1:]:
        assert other == results[0]


def test_ring_planes_equal_one_controller(dense_runs):
    results, one = dense_runs[0], dense_runs[1]
    assert results[0]["ring"] == one["ring"]


@pytest.mark.parametrize("case", sorted(W.DENSE_CASES))
def test_case_equals_one_controller(dense_runs, case):
    """Bitwise: every density / phase-space hash after each step and run,
    the refinement indicator, the alive set, the leaves and owners after
    ``adapt_grid``; the masses and CFL limits as floats, exactly."""
    results, one = dense_runs[0], dense_runs[1]
    got, want = dict(results[0][case]), dict(one[case])
    assert want.pop("run_bytes", 0) == 0
    got.pop("run_bytes", None)
    assert got == want


#: the ring bytes a controller sends in the case's run: (exchanges, bytes
#: of one plane)
RING_BYTES = {
    # B2: the vz planes once a run, the density planes each of 6 steps
    "adv_blocked_periodic": (7, 6 * 5 * 4), "adv_blocked_open": (7, 6 * 5 * 4),
    # B3 and the plain step: density and vz each of 6 steps
    "adv_plane_periodic": (12, 6 * 5 * 4), "adv_plane_open": (12, 6 * 5 * 4),
    "adv_plain_periodic": (12, 6 * 5 * 8), "adv_plain_open": (12, 6 * 5 * 8),
    # the board: one row exchange a turn, 12 turns of 10 float32 cells
    "board_open": (12, 10 * 4), "board_periodic": (12, 10 * 4),
    # Vlasov: one plane exchange each of 5 steps, 4x4 cells x 8 bins
    "vlasov_f32_open": (5, 16 * 8 * 4), "vlasov_f64_periodic": (5, 16 * 8 * 8),
}


@pytest.mark.parametrize("case", sorted(RING_BYTES))
def test_ring_bytes_are_two_planes_an_exchange(dense_runs, case):
    n, plane = RING_BYTES[case]
    for r in dense_runs[0]:
        assert r[case]["run_bytes"] == 2 * n * plane


def test_dense_forms_engage(dense_runs):
    results, _, _, D = dense_runs
    res = results[0]
    for form, (_, _, kinds) in W.ADV_FORMS.items():
        for z in ("periodic", "open"):
            assert tuple(res[f"adv_{form}_{z}"]["kind"]) == kinds[D]
    assert res["vlasov_f32_open"]["fused_block"] > 0 and res["vlasov_f32_open"]["dense"]
    assert res["vlasov_f64_periodic"]["fused_block"] == 0
    assert not res["vlasov_gather"]["dense"]
    assert res["adapt_from_dense"]["new_cells"] > 0


@pytest.mark.parametrize("per", [1, 3])
def test_ring_same_peer_order_two_controllers(per, tmp_path):
    """P = 2: both ring messages of a controller go to one peer, so the
    k-th send must meet the peer's k-th receive (sends up then down,
    receives below then above); the worker asserts each plane against
    one controller's roll of the whole stack, for 1 and 3 slots each."""
    from dccrg_tpu_torch.parallel import mesh

    D = 2 * per
    got = mesh.launch([sys.executable, WORKER, str(D), str(tmp_path), "ring"], 2,
                      timeout_s=60)
    assert got[0] == got[1] == {"ring": W.ring_check(mesh.SINGLE, D)}


# ------------------------------------- one controller against the JAX package

def _jgrid(D, length, max_ref=0, hood=1, periodic=(False,) * 3, cell=None):
    import dccrg_tpu

    g = (dccrg_tpu.Grid().set_initial_length(length)
         .set_maximum_refinement_level(max_ref).set_neighborhood_length(hood)
         .set_load_balancing_method("RCB").set_periodic(*periodic))
    if cell is not None:
        g = g.set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=cell)
    return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D))


def _np(state, name):
    return np.asarray(state[name])


@pytest.mark.parametrize("form", ["blocked", "plane", "plain"])
@pytest.mark.parametrize("periodic_z", [True, False], ids=["periodic", "open"])
def test_one_controller_advection_matches_jax(form, periodic_z):
    from dccrg_tpu.models import Advection as JAdvection
    from dccrg_tpu_torch.convert import state_from_numpy
    from dccrg_tpu_torch.parallel import mesh

    D = 8
    pa, ps, dt = W.adv_setup(mesh.SINGLE, D, form, periodic_z)
    nz_of, dtype, kinds = W.ADV_FORMS[form]
    nz = nz_of(D)
    jg = _jgrid(D, (6, 5, nz), hood=0, periodic=(True, True, periodic_z),
                cell=(1 / 6, 1 / 5, 1 / nz))
    ja = JAdvection(jg, dtype=dtype,
                    use_pallas="interpret" if dtype == np.float32 else True)
    js = ja.initialize_state()
    cells = jg.get_cells()
    vz = 0.15 + 0.3 * np.sin(2 * np.pi * jg.geometry.get_center(cells)[:, 2])
    js = ja.set_cell_data(js, "vz", cells, vz.astype(dtype))
    assert pa.dense_kind == ja.dense_kind == kinds[D]
    for k in ("density", "vx", "vy", "vz"):
        np.testing.assert_array_equal(ps[k].numpy(), _np(js, k))
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    dt = dtype(dt)
    if dtype == np.float32:
        j = js
        for _ in range(4):
            p = pa.step(state_from_numpy(pa, {k: _np(j, k) for k in j}), dt)
            j = ja.step(j, dt)
            np.testing.assert_allclose(p["density"].numpy(), _np(j, "density"),
                                       rtol=2e-7, atol=1e-9)
        tol = dict(rtol=1e-6, atol=1e-9)
    else:
        tol = dict(rtol=1e-13, atol=1e-16)
    j, p = ja.run(js, 5, dt), pa.run(ps, 5, dt)
    np.testing.assert_allclose(p["density"].numpy(), _np(j, "density"), **tol)


@pytest.mark.parametrize("D", [8, 6])
@pytest.mark.parametrize("periodic_y", [False, True], ids=["open", "periodic"])
def test_one_controller_board_matches_jax(D, periodic_y):
    from dccrg_tpu.models import GameOfLife as JGameOfLife
    from dccrg_tpu_torch.parallel import mesh

    gol, s = W.board_setup(mesh.SINGLE, D, periodic_y)
    jg = _jgrid(D, (10, 24, 1), periodic=(False, periodic_y, False))
    jl = JGameOfLife(jg)
    js = jl.new_state(alive_cells=gol.alive_cells(s))
    for turns in (1, 11):
        s, js = gol.run(s, turns), jl.run(js, turns)
        np.testing.assert_array_equal(np.sort(gol.alive_cells(s)),
                                      np.sort(jl.alive_cells(js)))


def _vlasov_pair(D, dtype, periodic_z, refine=False):
    from dccrg_tpu.models.vlasov import Vlasov as JVlasov
    from dccrg_tpu_torch.parallel import mesh

    pv, ps, dt = W.vlasov_setup(mesh.SINGLE, D, dtype, periodic_z, refine)
    if refine:
        jg = _jgrid(D, (8, 8, 8), max_ref=1, hood=0,
                    periodic=(True, True, periodic_z), cell=(1 / 8,) * 3)
        ids = jg.get_cells()
        jg.refine_completely_many(ids[np.linalg.norm(jg.geometry.get_center(ids) - 0.5,
                                                     axis=1) < 0.3])
        jg.stop_refining()
    else:
        jg = _jgrid(D, (4, 4, 48), hood=0, periodic=(True, True, periodic_z),
                    cell=(1 / 4, 1 / 4, 1 / 48))
    jv = JVlasov(jg, nv=2, dtype=dtype, use_pallas=False)
    return pv, ps, dt, jv, jv.initialize_state()


def test_one_controller_vlasov_f32_matches_jax():
    """Kernel B7's twin (f32, open z): each of three steps from the JAX
    state within 4 ULP of the JAX package's step."""
    from dccrg_tpu_torch.convert import vlasov_state_from_numpy

    from test_torch_vlasov_kernel import assert_within_4ulp

    pv, ps, dt, jv, js = _vlasov_pair(8, np.float32, False)
    assert pv._fused_block > 0
    np.testing.assert_array_equal(ps["f"].numpy(), _np(js, "f"))
    for _ in range(3):
        p = pv.step(vlasov_state_from_numpy(pv, _np(js, "f")), dt)
        js = jv.step(js, dt)
        assert_within_4ulp(p["f"].numpy(), _np(js, "f"))


@pytest.mark.parametrize("refine", [False, True], ids=["dense_f64", "gather_f64"])
def test_one_controller_vlasov_f64_matches_jax(refine):
    pv, ps, dt, jv, js = _vlasov_pair(8, np.float64, not refine, refine=refine)
    assert (pv.info is None) == refine
    g, jg = pv.grid, jv.grid
    ids = np.sort(g.get_cells())
    f = (lambda gr, s: np.asarray(gr.get_cell_data(s, "f", ids))) if refine else \
        (lambda gr, s: np.asarray(s["f"]))
    np.testing.assert_array_equal(f(g, ps), f(jg, js))
    ps, js = pv.run(ps, 5, dt), jv.run(js, 5, dt)
    np.testing.assert_allclose(f(g, ps), f(jg, js), rtol=1e-12, atol=1e-15)
    assert pv.total_mass(ps) == pytest.approx(jv.total_mass(js), rel=1e-12)


def test_one_controller_adapt_from_dense_matches_jax():
    from dccrg_tpu.models import Advection as JAdvection
    from dccrg_tpu_torch.parallel import mesh

    pa, ps, dt = W.adapt_setup(mesh.SINGLE, 8)
    jg = _jgrid(8, (6, 6, 24), max_ref=1, hood=0, periodic=(True,) * 3,
                cell=(1 / 6, 1 / 6, 1 / 24))
    ja = JAdvection(jg)
    js = ja.initialize_state()
    for _ in range(3):
        ps, js = pa.step(ps, dt), ja.step(js, dt)
    ps, js = pa.check_for_adaptation(ps), ja.check_for_adaptation(js)
    pa, ps, pnew, _ = pa.adapt_grid(ps)
    ja, js, jnew, _ = ja.adapt_grid(js)
    np.testing.assert_array_equal(np.sort(pnew), np.sort(jnew))
    for _ in range(3):
        ps, js = pa.step(ps, dt), ja.step(js, dt)
    g, jg = pa.grid, ja.grid
    ids = g.get_cells()
    np.testing.assert_array_equal(ids, jg.get_cells())
    np.testing.assert_array_equal(g.leaves.owner, jg.leaves.owner)
    np.testing.assert_allclose(g.get_cell_data(ps, "density", ids),
                               np.asarray(jg.get_cell_data(js, "density", ids)),
                               rtol=1e-13, atol=1e-16)
