"""The port's Vlasov (on the CPU) against the JAX package's, from identical
inputs: the dense split path in float64 and float32 (the step kernel's
twin), the general unsplit path on a refined grid by cell id, and the
physics both packages' tests hold (mass, outflow, device count).

Tolerances are the JAX package's own (tests/test_vlasov.py): float64
rtol=1e-12, atol=1e-15; float32 one step within 4 ULP (XLA-CPU may contract
a multiply-add the port rounds in two); mass rel=1e-12 in float64.
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models.vlasov import Vlasov as JVlasov
from dccrg_tpu_torch.convert import rows_state_from_numpy, vlasov_state_from_numpy
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts

from test_torch_vlasov_kernel import assert_within_4ulp


def _grid(pkg, n=8, nz=8, D=1, periodic=(True, True, True), refine=False):
    cell = (1.0 / 6,) * 3 if refine else (1.0 / n, 1.0 / n, 1.0 / nz)
    g = (
        pkg.Grid()
        .set_initial_length((6, 6, 6) if refine else (n, n, nz))
        .set_neighborhood_length(0)
        .set_periodic(*periodic)
        .set_maximum_refinement_level(1 if refine else 0)
        .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=cell)
    )
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    if refine:
        # tests/test_vlasov.py::_refined_grid: a ball around the centre
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        for cid in ids[r < 0.3]:
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def _f(g, vl, state):
    """f by cell id ``[N, B]`` (general layout) or the dense array."""
    if vl.info is None:
        ids = np.sort(g.get_cells())
        return np.asarray(g.get_cell_data(state, "f", ids), np.float64)
    return np.asarray(state["f"], np.float64)


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, False),
                                      (False, False, False)],
                         ids=["periodic", "part_open", "open"])
@pytest.mark.parametrize("D", [1, 2])
def test_dense_f64_matches_jax(D, periodic):
    jg, pg = _grid(dccrg_tpu, D=D, periodic=periodic), _grid(dccrg_tpu_torch, D=D, periodic=periodic)
    jv = JVlasov(jg, nv=3, dtype=np.float64)
    pv = dccrg_tpu_torch.Vlasov(pg, nv=3, dtype=np.float64)
    assert pv.info is not None and pv._fused_block == 0
    assert pv.max_time_step() == jv.max_time_step()
    js, ps = jv.initialize_state(), pv.initialize_state()
    np.testing.assert_array_equal(_f(pg, pv, ps), _f(jg, jv, js))
    dt = 0.3 * jv.max_time_step()
    js, ps = jv.run(js, 10, dt), pv.run(ps, 10, dt)
    np.testing.assert_allclose(_f(pg, pv, ps), _f(jg, jv, js), rtol=1e-12, atol=1e-15)
    assert pv.total_mass(ps) == pytest.approx(jv.total_mass(js), rel=1e-12)


@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)],
                         ids=["periodic", "open_xz"])
@pytest.mark.parametrize("D,nz", [(1, 8), (2, 32)])
def test_dense_f32_step_matches_jax(D, nz, periodic):
    """One float32 step through the fused step (the kernel's twin here)
    against the JAX package's XLA body and its Pallas kernel."""
    kw = dict(nz=nz, D=D, periodic=periodic)
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    pv = dccrg_tpu_torch.Vlasov(pg, nv=4, dtype=np.float32)
    assert pv._fused_block == dccrg_tpu.ops.vlasov_kernel.pick_vlasov_block(
        nz // D, 8, 8, 64) > 0
    ps = pv.initialize_state()
    dt = np.float32(0.4 * pv.max_time_step())
    reset_counts()
    out = pv.step(ps, dt)
    assert PLAIN_CALLS["vlasov_step"] == 1
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    for use_pallas in (False, "interpret"):
        jv = JVlasov(jg, nv=4, dtype=np.float32, use_pallas=use_pallas)
        js = jv.initialize_state()
        np.testing.assert_array_equal(_f(pg, pv, ps), _f(jg, jv, js))
        assert_within_4ulp(np.asarray(out["f"]), np.asarray(jv.step(js, dt)["f"]))


def test_dense_f32_plain_body_equals_fused_twin():
    """With the kernel switched off the float32 step is the plain XLA body,
    which computes the same values as the fused step's twin."""
    g = _grid(dccrg_tpu_torch, nz=16, D=2, periodic=(True, False, False))
    fused = dccrg_tpu_torch.Vlasov(g, nv=4, dtype=np.float32)
    plain = dccrg_tpu_torch.Vlasov(g, nv=4, dtype=np.float32, use_kernels=False)
    assert fused._fused_block > 0 and plain._fused_block == 0
    s = fused.initialize_state()
    dt = 0.4 * fused.max_time_step()
    a, b = fused.run(s, 3, dt)["f"], plain.run(s, 3, dt)["f"]
    assert bool((a == b).all())


def test_dense_state_from_jax_numpy():
    """A JAX dense state after a few steps enters the port from numpy
    (convert.vlasov_state_from_numpy) and both go on in lockstep."""
    jg, pg = _grid(dccrg_tpu, D=2), _grid(dccrg_tpu_torch, D=2)
    jv = JVlasov(jg, nv=3, dtype=np.float64)
    pv = dccrg_tpu_torch.Vlasov(pg, nv=3, dtype=np.float64)
    dt = 0.3 * jv.max_time_step()
    js = jv.run(jv.initialize_state(), 4, dt)
    ps = vlasov_state_from_numpy(pv, np.asarray(js["f"]))
    js, ps = jv.run(js, 4, dt), pv.run(ps, 4, dt)
    np.testing.assert_allclose(_f(pg, pv, ps), _f(jg, jv, js), rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="expected shape"):
        vlasov_state_from_numpy(pv, np.zeros((1, 8, 8, 8, 27)))


@pytest.mark.parametrize("periodic", [(True, True, True), (False, False, False)],
                         ids=["periodic", "open"])
@pytest.mark.parametrize("D", [1, 3])
def test_general_refined_f64_matches_jax(D, periodic):
    kw = dict(D=D, periodic=periodic, refine=True)
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    jv = JVlasov(jg, nv=3, dtype=np.float64)
    pv = dccrg_tpu_torch.Vlasov(pg, nv=3, dtype=np.float64)
    assert jv.info is None and pv.info is None
    assert pv.max_time_step() == jv.max_time_step()
    js, ps = jv.initialize_state(), pv.initialize_state()
    np.testing.assert_array_equal(_f(pg, pv, ps), _f(jg, jv, js))
    dt = 0.5 * jv.max_time_step()
    js, ps = jv.run(js, 5, dt), pv.run(ps, 5, dt)
    np.testing.assert_allclose(_f(pg, pv, ps), _f(jg, jv, js), rtol=1e-12, atol=1e-15)
    assert pv.total_mass(ps) == pytest.approx(jv.total_mass(js), rel=1e-12)
    # the JAX state carried over by cell id runs on in lockstep
    host = {k: np.asarray(v) for k, v in js.items()}
    ps2 = rows_state_from_numpy(pg, host, jg.epoch.cell_ids)
    js, ps2 = jv.run(js, 2, dt), pv.run(ps2, 2, dt)
    np.testing.assert_allclose(_f(pg, pv, ps2), _f(jg, jv, js), rtol=1e-12, atol=1e-15)


def test_mass_conserved_on_both_layouts():
    for refine in (False, True):
        g = _grid(dccrg_tpu_torch, D=2, refine=refine)
        vl = dccrg_tpu_torch.Vlasov(g, nv=4, dtype=np.float64)
        s = vl.initialize_state()
        m0 = vl.total_mass(s)
        s = vl.run(s, 12, 0.3 * vl.max_time_step())
        assert vl.total_mass(s) == pytest.approx(m0, rel=1e-12), refine
        assert (np.asarray(s["f"]) >= -1e-12).all()


def test_open_boundaries_outflow_on_both_layouts():
    """Open boundaries are vacuum inflow / free outflow on both layouts:
    mass leaves the box monotonically and f stays non-negative."""
    for refine in (False, True):
        g = _grid(dccrg_tpu_torch, periodic=(False, False, False), refine=refine)
        vl = dccrg_tpu_torch.Vlasov(g, nv=3, dtype=np.float64)
        s = vl.initialize_state()
        dt = 0.5 * vl.max_time_step()
        masses = [vl.total_mass(s)]
        for _ in range(4):
            s = vl.run(s, 5, dt)
            masses.append(vl.total_mass(s))
        assert all(m1 < m0 for m0, m1 in zip(masses, masses[1:])), (refine, masses)
        assert (np.asarray(s["f"]) >= -1e-12).all()


@pytest.mark.parametrize("refine", [False, True], ids=["dense", "refined"])
def test_device_count_invariance(refine):
    res = []
    for D in (1, 2):
        g = _grid(dccrg_tpu_torch, D=D, periodic=(True, False, False), refine=refine)
        vl = dccrg_tpu_torch.Vlasov(g, nv=3, dtype=np.float64)
        s = vl.run(vl.initialize_state(), 6, 0.3 * vl.max_time_step())
        f = _f(g, vl, s)
        res.append(f.reshape(-1, vl.B) if vl.info is None else
                   f.reshape(8, 8, 8, vl.B))
    np.testing.assert_allclose(res[0], res[1], rtol=1e-12, atol=1e-15)


def test_unported_forms_raise():
    """The cohort forms the JAX package has are ported (no form raises
    any more): the dense step in cohort form, with no wide step on the
    dense layout (tests/test_torch_wide_halo.py holds the engaged
    forms)."""
    g = _grid(dccrg_tpu_torch)
    vl = dccrg_tpu_torch.Vlasov(g)
    assert vl._wide_spec() is None
    spec = vl.batch_step_spec()
    assert spec.kind == ("vlasov.dense" if vl.info is not None else "vlasov")
