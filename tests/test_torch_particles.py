"""The port's particle model against the JAX package's (tests/test_particles.py
mirrored), in float64 on both sides: the same seeded positions, velocities
and steps on uniform, refined and balanced grids at 1 to 8 slots, on the
device and the host re-bucket.  Each cell's count and its particles'
coordinates, in slot order, are compared bitwise; the overflow counts
exactly.  One exception: under a per-cell velocity field XLA-CPU fuses the
JAX push's multiply-add into one rounding, where the port (like the JAX
package under a global velocity) rounds the product and the sum apart, so
the fuzz test's coordinates are held to 1e-15 absolute, five ULP of the
unit domain's coordinates (counts still exact)."""
import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models.particles import Particles as JParticles
from dccrg_tpu_torch.models.particles import Particles
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts

F64 = np.float64


def make_grid(pkg, length=(8, 8, 1), periodic=(True, True, False), max_ref=0, n_dev=1):
    n = np.asarray(length)
    g = (pkg.Grid().set_initial_length(length).set_maximum_refinement_level(max_ref)
         .set_neighborhood_length(1).set_periodic(*periodic)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=tuple(1.0 / n)))
    if pkg is dccrg_tpu:
        return g.initialize(mesh=dccrg_tpu.make_mesh(n_devices=n_dev))
    return g.initialize(n_devices=n_dev, device="cpu")


def both(P=64, host=False, prep=None, **kw):
    """(JAX model, port model) on equal grids; ``prep(g)`` mutates each grid
    first; ``host`` forces the host re-bucket on both."""
    out = []
    for pkg, Model in ((dccrg_tpu, JParticles), (dccrg_tpu_torch, Particles)):
        g = make_grid(pkg, **kw)
        if prep is not None:
            prep(g)
        m = Model(g, max_particles_per_cell=P, dtype=F64)
        if host:
            m._dev_rebucket = None
        out.append(m)
    return out


def per_cell(m, state):
    """(cells, count per cell, [N, P, 3] coordinates with unused slots 0)."""
    g = m.grid
    cells = g.get_cells()
    pos = g.leaves.position(cells)
    d, r = g.leaves.owner[pos], g.epoch.row_of[pos]
    cnt = np.asarray(state["number_of_particles"])[d, r]
    xyz = np.asarray(state["particles"])[d, r].copy()
    xyz[np.arange(m.P)[None, :] >= cnt[:, None]] = 0.0
    return cells, cnt, xyz


def assert_same(jm, js, tm, ts, atol=0.0):
    jc, jn, jx = per_cell(jm, js)
    tc, tn, tx = per_cell(tm, ts)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    assert tx.dtype == jx.dtype == np.float64
    if atol:
        np.testing.assert_allclose(tx, jx, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(tx, jx)
    if "overflow" in js or "overflow" in ts:
        assert int(ts["overflow"]) == int(np.asarray(js["overflow"]))


@pytest.mark.parametrize("n_dev", [1, 8])
def test_bucketing(n_dev):
    jm, tm = both(n_dev=n_dev)
    pts = np.array([[0.05, 0.05, 0.5], [0.55, 0.55, 0.5], [0.95, 0.05, 0.5]])
    js, ts = jm.new_state(pts), tm.new_state(pts)
    assert_same(jm, js, tm, ts)
    assert tm.count(ts) == 3
    for pt in pts:
        cell = int(tm.grid.get_existing_cell(pt[None])[0])
        assert any(np.array_equal(row, pt) for row in tm.particles_of(ts, cell))


def test_drift_and_handoff():
    jm, tm = both()
    js = jm.new_state(np.array([[0.05, 0.5, 0.5]]))
    ts = tm.new_state(np.array([[0.05, 0.5, 0.5]]))
    for _ in range(20):
        js = jm.step(js, velocity=(0.1, 0.0, 0.0), dt=1.0)
        ts = tm.step(ts, velocity=(0.1, 0.0, 0.0), dt=1.0)
        assert tm.count(ts) == 1
        assert_same(jm, js, tm, ts)
    pos = tm.positions(ts)[0]
    assert pos[0] == pytest.approx((0.05 + 2.0) % 1.0, abs=1e-12)
    assert len(tm.particles_of(ts, int(tm.grid.get_existing_cell(pos[None])[0]))) == 1


def test_migration_across_devices():
    jm, tm = both(n_dev=8)
    rng = np.random.default_rng(4)
    pts = np.column_stack([rng.random(50), rng.random(50), np.full(50, 0.5)])
    js, ts = jm.new_state(pts), tm.new_state(pts)
    for _ in range(10):
        js = jm.step(js, velocity=(0.07, 0.013, 0.0), dt=1.0)
        ts = tm.step(ts, velocity=(0.07, 0.013, 0.0), dt=1.0)
        assert tm.count(ts) == 50
    assert_same(jm, js, tm, ts)
    final = tm.positions(ts)
    assert len(set(tm.grid.get_owner(tm.grid.get_existing_cell(final)).tolist())) > 1
    np.testing.assert_allclose(np.sort(final[:, 0]), np.sort((pts[:, 0] + 0.7) % 1.0),
                               atol=1e-12)


def test_remap_after_balance_and_refine():
    jm, tm = both(length=(4, 4, 1), max_ref=1, n_dev=4)
    pts = np.array([[0.1, 0.1, 0.5], [0.6, 0.6, 0.5], [0.9, 0.9, 0.5]])
    js, ts = jm.new_state(pts), tm.new_state(pts)
    for m in (jm, tm):
        m.grid.refine_completely(1)
        m.grid.stop_refining()
    js, ts = jm.remap(js), tm.remap(ts)
    assert_same(jm, js, tm, ts)
    c = int(tm.grid.get_existing_cell(np.array([[0.1, 0.1, 0.5]]))[0])
    assert tm.grid.get_refinement_level(c) == 1 and len(tm.particles_of(ts, c)) == 1
    for m in (jm, tm):
        m.grid.balance_load()
    np.testing.assert_array_equal(tm.grid.leaves.owner, jm.grid.leaves.owner)
    js, ts = jm.remap(js), tm.remap(ts)
    assert_same(jm, js, tm, ts)
    np.testing.assert_allclose(np.sort(tm.positions(ts), axis=0), np.sort(pts, axis=0))


def test_capacity_guard():
    tm = Particles(make_grid(dccrg_tpu_torch, length=(2, 2, 1)), max_particles_per_cell=4)
    with pytest.raises(ValueError, match="capacity"):
        tm.new_state(np.tile(np.array([[0.1, 0.1, 0.5]]), (5, 1)))
    with pytest.raises(ValueError, match="outside"):
        tm.new_state(np.array([[0.1, 0.1, 1.5]]))


def test_nonperiodic_escape_drops_on_device_path():
    jm, tm = both(periodic=(False, False, False))
    assert tm._dev_rebucket is not None
    js = jm.new_state(np.array([[0.95, 0.5, 0.5]]))
    ts = tm.new_state(np.array([[0.95, 0.5, 0.5]]))
    for _ in range(3):
        js = jm.step(js, velocity=(0.1, 0.0, 0.0), dt=1.0)
        ts = tm.step(ts, velocity=(0.1, 0.0, 0.0), dt=1.0)
    assert tm.count(ts) == 0 and int(ts["overflow"]) == 1
    assert_same(jm, js, tm, ts)


def test_nonperiodic_escape_raises_on_host_path():
    tm = Particles(make_grid(dccrg_tpu_torch, periodic=(False, False, False)), dtype=F64)
    tm._dev_rebucket = None
    ts = tm.new_state(np.array([[0.95, 0.5, 0.5]]))
    with pytest.raises(ValueError, match="non-periodic"):
        for _ in range(3):
            ts = tm.step(ts, velocity=(0.1, 0.0, 0.0), dt=1.0)


def test_per_cell_velocity_field():
    jm, tm = both(n_dev=8)
    fn = lambda c: np.where(c[:, :1] < 0.5, np.array([[0.1, 0.0, 0.0]]),
                            np.array([[0.0, 0.1, 0.0]]))
    jv, tv = jm.velocity_field(fn), tm.velocity_field(fn)
    np.testing.assert_array_equal(tv, jv)
    pts = np.array([[0.1, 0.3, 0.5], [0.8, 0.3, 0.5]])
    js = jm.step(jm.new_state(pts), velocity=jv, dt=1.0)
    ts = tm.step(tm.new_state(pts), velocity=tv, dt=1.0)
    assert_same(jm, js, tm, ts)
    got = tm.positions(ts)
    got = got[np.argsort(got[:, 0])]
    np.testing.assert_allclose(got[0], [0.2, 0.3, 0.5], atol=1e-12)
    np.testing.assert_allclose(got[1], [0.8, 0.4, 0.5], atol=1e-12)


def test_scatter_matches_loop_reference():
    jm, tm = both(P=8, n_dev=8)
    rng = np.random.default_rng(7)
    pts = np.column_stack([rng.random(200), rng.random(200), np.full(200, 0.5)])
    js, ts = jm.new_state(pts), tm.new_state(pts)
    assert_same(jm, js, tm, ts)
    g = tm.grid
    lpos = g.leaves.position(g.get_existing_cell(pts))
    exp_pos = np.zeros(tuple(ts["particles"].shape))
    exp_cnt = np.zeros(tuple(ts["number_of_particles"].shape), np.int32)
    for d, r, pt in zip(g.leaves.owner[lpos], g.epoch.row_of[lpos], pts):
        exp_pos[d, r, exp_cnt[d, r]] = pt
        exp_cnt[d, r] += 1
    np.testing.assert_array_equal(ts["number_of_particles"].numpy(), exp_cnt)
    np.testing.assert_array_equal(ts["particles"].numpy(), exp_pos)


@pytest.mark.parametrize("seed", [2, 7])
def test_fuzz_particles_random_grids(seed):
    """A seeded random grid (perhaps refined), slot count and population:
    pushes with migration, an AMR commit and a balance in between, on both
    packages in lockstep."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6, 8]))
    n_dev = int(rng.choice([1, 2, 4, 8]))
    refine = rng.random() < 0.5
    picks = rng.random(64)

    def prep(g):
        if refine:
            ids = g.get_cells()
            g.refine_completely_many(ids[picks[ids % 64] < 0.2])
            g.stop_refining()

    jm, tm = both(P=256, prep=prep, length=(n, n, n), periodic=(True, True, True),
                  max_ref=1, n_dev=n_dev)
    npart = int(rng.integers(200, 1500))
    pts = rng.random((npart, 3))
    js, ts = jm.new_state(pts), tm.new_state(pts)
    fn = lambda c: 0.2 * (c - 0.5)
    for _ in range(4):
        js = jm.step(js, velocity=jm.velocity_field(fn), dt=0.1)
        ts = tm.step(ts, velocity=tm.velocity_field(fn), dt=0.1)
        assert tm.count(ts) == npart
    assert_same(jm, js, tm, ts, atol=1e-15)
    g = tm.grid
    ids = g.get_cells()
    for cell in ids[:: max(1, len(ids) // 30)]:
        p = tm.particles_of(ts, int(cell))
        if len(p):
            lo = g.geometry.get_min(np.asarray([cell], np.uint64))[0]
            hi = g.geometry.get_max(np.asarray([cell], np.uint64))[0]
            assert ((p >= lo - 1e-12) & (p <= hi + 1e-12)).all()
    for m in (jm, tm):
        for cid in ids[[1, len(ids) // 2, -2]]:
            m.grid.refine_completely(int(cid))
        m.grid.stop_refining()
    js, ts = jm.remap(js), tm.remap(ts)
    for m in (jm, tm):
        m.grid.balance_load()
    js, ts = jm.remap(js), tm.remap(ts)
    js = jm.step(js, velocity=jm.velocity_field(fn), dt=0.1)
    ts = tm.step(ts, velocity=tm.velocity_field(fn), dt=0.1)
    assert tm.count(ts) == npart
    assert_same(jm, js, tm, ts, atol=1e-15)


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_rebucket_uniform_matches_jax(n_dev, host):
    """25 steps on a uniform periodic grid through run(): the device path
    (or the host path) equal to the JAX package's, and both paths to each
    other."""
    jm, tm = both(P=32, host=host, length=(8, 8, 4), periodic=(True, True, True),
                  n_dev=n_dev)
    assert (tm._dev_rebucket is None) == host
    pts = np.random.default_rng(7).uniform(0, 1, size=(500, 3))
    js = jm.run(jm.new_state(pts), 25, velocity=(0.09, -0.04, 0.13), dt=0.5)
    ts = tm.run(tm.new_state(pts), 25, velocity=(0.09, -0.04, 0.13), dt=0.5)
    assert tm.count(ts) == 500
    assert_same(jm, js, tm, ts)
    if not host:
        assert int(ts["overflow"]) == 0 and ts["overflow"].dtype == torch.int32


def test_device_rebucket_overflow_counter():
    tm = Particles(make_grid(dccrg_tpu_torch, (4, 4, 4), (True,) * 3),
                   max_particles_per_cell=2, dtype=F64)
    with pytest.raises(ValueError):
        tm.new_state(np.full((5, 3), 0.6))
    jm, tm = both(P=2, length=(4, 1, 1), periodic=(True, True, True))
    spread = np.column_stack([np.array([0.05, 0.3, 0.55, 0.8, 0.1, 0.35]),
                              np.full(6, 0.5), np.full(6, 0.5)])
    fn = lambda c: np.column_stack([0.5 - c[:, 0], np.zeros(len(c)), np.zeros(len(c))])
    js = jm.run(jm.new_state(spread), 8, velocity=jm.velocity_field(fn), dt=1.0)
    ts = tm.run(tm.new_state(spread), 8, velocity=tm.velocity_field(fn), dt=1.0)
    dropped = int(ts["overflow"])
    assert dropped > 0 and tm.count(ts) + dropped == 6
    assert_same(jm, js, tm, ts)


def test_device_rebucket_counts_beyond_halo_loss():
    jm, tm = both(P=8, length=(4, 4, 4), periodic=(True, True, True), n_dev=4)
    pts = np.array([[0.5, 0.5, 0.125]])
    js = jm.run(jm.new_state(pts), 1, velocity=(0.0, 0.0, 0.5), dt=1.0)
    ts = tm.run(tm.new_state(pts), 1, velocity=(0.0, 0.0, 0.5), dt=1.0)
    assert tm.count(ts) == 0 and int(ts["overflow"]) == 1
    assert_same(jm, js, tm, ts)


def _refined_prep(g):
    for c in (1, 2, 7, 12):
        g.refine_completely(c)
    g.stop_refining()
    g.refine_completely(int(g.mapping.get_all_children(np.uint64(1))[0]))
    g.stop_refining()


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_rebucket_on_refined_grid_matches_jax(n_dev, host):
    jm, tm = both(P=64, host=host, prep=_refined_prep, length=(4, 4, 2),
                  periodic=(True, True, True), max_ref=2, n_dev=n_dev)
    assert (tm._dev_rebucket is None) == host
    pts = np.random.default_rng(11).uniform(0, 1, size=(300, 3))
    js = jm.run(jm.new_state(pts), 10, velocity=(0.05, -0.03, 0.04), dt=0.5)
    ts = tm.run(tm.new_state(pts), 10, velocity=(0.05, -0.03, 0.04), dt=0.5)
    assert tm.count(ts) == 300
    assert_same(jm, js, tm, ts)


@pytest.mark.parametrize("host", [False, True])
def test_rebucket_after_balance_load_matches_jax(monkeypatch, host):
    """Scattered post-balance ownership stays on the device path; the two
    exchanges a step go through the halo schedule (B9's twin on the CPU
    under DCCRG_HALO_BACKEND=pallas), two launches a step."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    jm, _ = both(P=32, length=(8, 8, 2), periodic=(True, True, True), n_dev=4)
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    _, tm = both(P=32, length=(8, 8, 2), periodic=(True, True, True), n_dev=4)
    pts = np.random.default_rng(23).uniform(0, 1, size=(200, 3))
    js = jm.run(jm.new_state(pts), 5, velocity=(0.07, 0.05, 0.0), dt=0.5)
    ts = tm.run(tm.new_state(pts), 5, velocity=(0.07, 0.05, 0.0), dt=0.5)
    for m in (jm, tm):
        for cell in m.grid.get_cells()[::3]:
            m.grid.pin(int(cell), int(cell) % 4)
        m.grid.balance_load()
    js, ts = jm.remap(js), tm.remap(ts)
    assert tm._dev_rebucket is not None
    if host:
        jm._dev_rebucket = tm._dev_rebucket = None
    reset_counts()
    js = jm.run(js, 10, velocity=(0.07, 0.05, 0.0), dt=0.5)
    ts = tm.run(ts, 10, velocity=(0.07, 0.05, 0.0), dt=0.5)
    assert PLAIN_CALLS["ring_copy"] == 20 and LAUNCHES["ring_copy"] == 0
    assert tm.count(ts) == 200
    assert_same(jm, js, tm, ts)


def test_exact_upper_edge_matches_host():
    for periodic in ((True, True, True), (False, False, False)):
        jm, tm = both(length=(4, 4, 4), periodic=periodic)
        assert tm._dev_rebucket is not None
        pt = np.array([[1.0, 0.5, 0.5]])
        ts = tm.new_state(pt)
        host_cell = int(tm.grid.get_existing_cell(pt)[0])
        js, ts = jm.rebucket(jm.new_state(pt)), tm.rebucket(ts)
        assert tm.count(ts) == 1 and int(ts["overflow"]) == 0, periodic
        got = tm.particles_of(ts, host_cell)
        assert len(got) == 1 and np.array_equal(got[0], pt[0]), periodic
        assert_same(jm, js, tm, ts)


def test_float32_default_and_device():
    """The port's default coordinate dtype is float32 (the bench's), on the
    grid's device; a float32 run stays float32."""
    g = make_grid(dccrg_tpu_torch, (4, 4, 4), (True,) * 3)
    m = Particles(g)
    s = m.run(m.new_state(np.random.default_rng(0).random((50, 3))), 3,
              velocity=(0.1, 0.2, 0.05), dt=0.5)
    assert s["particles"].dtype == torch.float32 and s["particles"].device == g.device
    assert m.count(s) == 50 and int(s["overflow"]) == 0
