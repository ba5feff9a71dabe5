"""The flat AMR layer of the port against the JAX package's
``ops/flat_amr.py``: host tables exactly, face weights exactly, and the two
whole-run kernels' plain twins (the port's CPU path) against the Pallas
kernels in interpret mode, on the same seeded numpy inputs.

Tolerance for the twins: ``4 * steps`` float32 ulps of ``max|V|`` (one
step: 4 ulps).  Every op rounds on its own in the twins; XLA-CPU may
contract a multiply-add in interpret mode, which moves a result by about an
ulp a chained step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.ops import flat_amr as jf
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts
from dccrg_tpu_torch.ops import flat_amr as tf

EPS32 = float(np.finfo(np.float32).eps)


def _grid(pkg, D, levels, n=8, periodic=(True, True, True),
          cell=(1 / 8, 1 / 8, 1 / 8)):
    """The JAX tests' grids: one ball refined once per level (8^3 at
    0.28 around 0.45 for two levels, test_advection_flat.py; radii 0.3
    and 0.15 around 0.5 for three, test_advection_flat_ml.py)."""
    g = (
        pkg.Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(0)
        .set_periodic(*periodic)
        .set_maximum_refinement_level(levels)
        .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=cell)
    )
    g = (g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=D)) if pkg is dccrg_tpu
         else g.initialize(n_devices=D, device="cpu"))
    if levels == 1:
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.45, axis=1)
        for cid in ids[r < 0.28]:
            g.refine_completely(int(cid))
        g.stop_refining()
        return g
    for rad in (0.3, 0.15):
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        lv = g.mapping.get_refinement_level(ids)
        for cid in ids[(r < rad) & (lv == lv.max())]:
            g.refine_completely(int(cid))
        g.stop_refining()
    return g


def _pair(D, levels, **kw):
    return _grid(dccrg_tpu, D, levels, **kw), _grid(dccrg_tpu_torch, D, levels, **kw)


def _assert_tables_equal(got, want, keys):
    for k in keys:
        g, w = got[k], want[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True)])
def test_two_level_tables_match_jax(periodic):
    ref, port = _pair(1, 1, periodic=periodic)
    want, got = jf.build_flat_amr_tables(ref), tf.build_flat_amr_tables(port)
    assert got is not None and want is not None
    _assert_tables_equal(got, want, (
        "shape", "vox_level", "n_devices", "leaf_idx", "leaf_level",
        "leaf_fine", "rows", "wb_rows", "wb_valid", "area_f", "periodic"))
    assert (got["vol_f"], got["vol_c"]) == (want["vol_f"], want["vol_c"])
    n = int(np.prod(got["shape"]))
    assert tf.flat_amr_fits(n) == jf.flat_amr_fits(n)


def test_voxel_layout_multi_device_matches_jax():
    """The slab-sharded layout (rows / write-back per device) at D = 2."""
    ref, port = _pair(2, 1)
    want = jf.flat_voxel_layout(ref, allow_multi_device=True)
    got = tf.flat_voxel_layout(port, allow_multi_device=True)
    assert want is not None
    _assert_tables_equal(got, want, ("shape", "leaf_idx", "leaf_level",
                                     "leaf_fine", "rows", "wb_rows", "wb_valid"))
    assert tf.build_flat_amr_tables(port) is None   # one device only


ML_KEYS = ("shape", "vl", "n_devices", "rows", "wb_rows", "wb_valid", "lev",
           "lidx", "updf", "pool", "caps", "cap_origin", "cap_active", "area_f",
           "periodic", "n_vox")


@pytest.mark.parametrize("D", [1, 8])
def test_multi_level_tables_match_jax(D):
    cell = (0.1, 0.07, 0.13)
    ref, port = _pair(D, 2, cell=cell)
    want, got = jf.build_flat_ml_tables(ref), tf.build_flat_ml_tables(port)
    assert want is not None and got is not None
    _assert_tables_equal(got, want, ML_KEYS)
    assert tf.flat_ml_kernel_fits(got["n_vox"], got["vl"]) == \
        jf.flat_ml_kernel_fits(want["n_vox"], want["vl"])
    # the two-level builder declines a three-level grid, in both packages
    assert tf.build_flat_amr_tables(port) is None
    assert jf.build_flat_amr_tables(ref) is None


def _velocities(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 0.5, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("periodic", [(True, True, True), (False, True, False)])
def test_flat_weights_match_jax(periodic):
    ref, port = _pair(1, 1, periodic=periodic)
    t = tf.build_flat_amr_tables(port)
    vel = _velocities(t["shape"], 1)
    want = jf.compute_flat_weights(jf.build_flat_amr_tables(ref),
                                   *(jnp.asarray(v) for v in vel))
    got = tf.compute_flat_weights(t, *(torch.from_numpy(v) for v in vel))
    for (gp, gn), (wp, wn) in zip(got, want):
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


@pytest.mark.parametrize("periodic", [(True, True, True), (False, False, True)])
def test_flat_ml_weights_match_jax(periodic):
    ref, port = _pair(1, 2, periodic=periodic, cell=(0.1, 0.07, 0.13))
    t = tf.build_flat_ml_tables(port)
    vel = _velocities(t["shape"], 2)
    want = jf.compute_flat_ml_weights(jf.build_flat_ml_tables(ref),
                                      *(jnp.asarray(v) for v in vel))
    got = tf.compute_flat_ml_weights(t, *(torch.from_numpy(v) for v in vel))
    for (gp, gn), (wp, wn) in zip(got, want):
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


def _random_run_inputs(shape, seed):
    """V and six weights as tools/flat_kernel_bench.py builds them (small
    CFL-scale weights), signed so both flux sides carry."""
    rng = np.random.default_rng(seed)
    V = rng.random(shape).astype(np.float32)
    w = [(rng.random(shape) * 2e-3 - 1e-3).astype(np.float32) for _ in range(6)]
    return V, w


def _tol(V, steps):
    return 4 * EPS32 * float(np.abs(V).max()) * max(steps, 1)


@pytest.mark.parametrize("steps", [1, 7, 8])
def test_flat_amr_plain_matches_pallas(steps):
    """B5's twin against ``make_flat_amr_run(..., interpret=True)``, coarse
    blocks on one octant as tools/flat_kernel_bench.py lays them out."""
    shape = (8, 12, 16)
    V, w = _random_run_inputs(shape, steps)
    fine = np.zeros(shape, bool)
    fine[:4, :6, :8] = True
    updf = (fine / 1.0).astype(np.float32)
    updc = ((~fine) / 8.0).astype(np.float32)
    dt = np.float32(0.9)
    kern = jf.make_flat_amr_run(*shape, interpret=True)
    want = np.asarray(kern(*(jnp.asarray(a) for a in (V, *w, updf, updc)), dt, steps))
    got = tf.flat_amr_run_plain(*(torch.from_numpy(a) for a in (V, *w, updf, updc)),
                                float(dt), steps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(V, steps))
    assert np.abs(got - V).max() > 0        # the run moved something


@pytest.mark.parametrize("steps", [1, 7, 8])
def test_flat_ml_plain_matches_pallas(steps):
    """B6's twin against ``make_flat_ml_run_pallas(..., interpret=True)`` on
    the 3-level ball grid's own masks, random V and weights."""
    t = tf.build_flat_ml_tables(_grid(dccrg_tpu_torch, 1, 2, cell=(0.1, 0.07, 0.13)))
    shape = t["shape"]
    V, w = _random_run_inputs(shape, 10 + steps)
    # weights carry the swept volume: scale them to the finest voxel's
    # volume, as CFL-sized face velocities times face areas do
    vol_f = float(t["area_f"][0]) * 0.1 / 4
    w = [(x * vol_f).astype(np.float32) for x in w]
    updf = t["updf"][0].astype(np.float32)
    pool = t["pool"][0].astype(np.float32)
    caps = [c[0].astype(np.float32) for c in t["cap_origin"]]
    dt = np.float32(0.9)
    kern = jf.make_flat_ml_run_pallas(*shape, t["vl"], t["cap_active"], interpret=True)
    want = np.asarray(kern(*(jnp.asarray(a) for a in (V, *w, updf, pool)),
                           [jnp.asarray(c) for c in caps], dt, steps))
    got = tf.flat_ml_run_plain(*(torch.from_numpy(a) for a in (V, *w, updf, pool)),
                               [torch.from_numpy(c) for c in caps], float(dt), steps,
                               cap_active=t["cap_active"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(V, steps))
    assert np.abs(got - V).max() > 0


def test_cpu_wrappers_take_the_twins():
    """On CPU tensors both wrappers compute with their twins (equal results)
    and count no kernel launch."""
    reset_counts()
    shape = (4, 4, 4)
    V, w = _random_run_inputs(shape, 3)
    fine = np.zeros(shape, bool)
    fine[:2] = True
    args = [torch.from_numpy(a) for a in (V, *w, (fine / 1.0).astype(np.float32),
                                          ((~fine) / 8.0).astype(np.float32))]
    a = tf.flat_amr_run(*args, 0.5, 3)
    b = tf.flat_amr_run_plain(*args, 0.5, 3)
    assert torch.equal(a, b)
    ml = [torch.from_numpy(x) for x in (V, *w)]
    ones = torch.ones(shape)
    c = tf.flat_ml_run(*ml, ones, torch.zeros(shape), [], 0.5, 2, cap_active=[False])
    assert torch.equal(c, tf.flat_ml_run_plain(*ml, ones, torch.zeros(shape), [], 0.5, 2,
                                               cap_active=[False]))
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    assert PLAIN_CALLS["flat_amr_run"] == 2 and PLAIN_CALLS["flat_ml_run"] == 2
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tf.flat_amr_run(*args[:-1], torch.empty(shape, device="meta"), 0.5, 1)
