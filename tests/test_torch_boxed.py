"""The port's boxed per-level advection (``parallel/boxed.py``,
``models/boxed_advection.py``) against the JAX package's, on the CPU
(tests/test_advection_boxed.py mirrored), and the run dispatch between the
boxed passes and the flat forms.

Each case runs the same seeded inputs through both packages' boxed runs
and compares by cell id, and holds the port's boxed run against its own
gather step as the JAX test does, at that test's tolerances: f64 rtol 1e-12
/ atol 1e-13 and mass 1e-12 (test_advection_boxed.py:54-55); repeated runs
1e-13 / 1e-15; 1 against 4 slots 1e-14 / 1e-16; f32 3e-6 / 1e-7 (the
periodic-seam cases) and 5e-6 of the peak (the fuzz cases).
"""
import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu_torch.convert import rows_state_from_numpy
from dccrg_tpu_torch.models import advection as port_advection


def _kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def _grid(pkg, n=8, maxref=1, periodic=(True, True, True), n_devices=1,
          refine_center=(0.3, 0.5, 0.5), radii=(0.25,), hood=0, dist=None):
    """test_advection_boxed.py::_grid for either package (``dist`` measures
    the distance to the center, default Euclidean)."""
    g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(hood)
         .set_periodic(*periodic).set_maximum_refinement_level(maxref)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(**_kw(pkg, n_devices)))
    dist = dist or (lambda c, p: np.linalg.norm(c - p, axis=1))
    for r_ref in radii:
        ids = g.get_cells()
        r = dist(g.geometry.get_center(ids), np.asarray(refine_center))
        g.refine_completely_many(ids[r < r_ref])
        g.stop_refining()
    return g


def _periodic_dist(c, p):
    d = np.abs(c - p)
    return np.linalg.norm(np.minimum(d, 1 - d), axis=1)


def _both(dtype=np.float64, **kw):
    """(JAX grid, model; port grid, model) on the same grid, the JAX model
    on its general path (no flat form), the port's with kernels off."""
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    np.testing.assert_array_equal(jg.get_cells(), pg.get_cells())
    ja = JAdvection(jg, dtype=dtype, allow_dense=False, use_pallas=False)
    pa = dccrg_tpu_torch.Advection(pg, dtype=dtype, allow_dense=False, use_kernels=False)
    return jg, ja, pg, pa


def _carry(jg, js, pg):
    return rows_state_from_numpy(pg, {k: np.asarray(v) for k, v in js.items()},
                                 jg.epoch.cell_ids)


def _rho(g, adv, s, ids=None):
    ids = g.get_cells() if ids is None else ids
    return np.asarray(adv.get_cell_data(s, "density", ids), np.float64)


def _compare(steps=8, velocity=None, **kw):
    """test_advection_boxed.py::_compare: the port's boxed run against the
    JAX package's boxed run and against its own gather steps (f64)."""
    jg, ja, pg, pa = _both(**kw)
    assert pa.boxed is not None and ja.boxed is not None
    js = ja.initialize_state()
    if velocity is not None:
        cells = jg.get_cells()
        c = jg.geometry.get_center(cells)
        for name, fn in velocity.items():
            js = jg.set_cell_data(js, name, cells, fn(c))
        js = ja._exchange(js)
    ps = _carry(jg, js, pg)
    dt = np.float64(0.4 * ja.max_time_step(js))
    assert pa.max_time_step(ps) == ja.max_time_step(js)
    want = ja._boxed_run(js, steps, dt)
    got = pa._boxed_run(ps, steps, dt)
    np.testing.assert_allclose(_rho(pg, pa, got), _rho(jg, ja, want), rtol=1e-12, atol=1e-13)
    flat = ps
    for _ in range(steps):
        flat = pa.step(flat, dt)
    np.testing.assert_allclose(_rho(pg, pa, got), _rho(pg, pa, flat), rtol=1e-12, atol=1e-13)
    assert pa.total_mass(got) == pytest.approx(pa.total_mass(ps), rel=1e-12)
    return ja, pa


_CASES = {
    "refined_periodic": dict(),
    "wrap_corner": dict(refine_center=(0.0, 0.0, 0.0), radii=(0.3,), steps=12),
    "wrap_high_edge": dict(refine_center=(1.0, 1.0, 1.0), radii=(0.3,), steps=12),
    "refined_nonperiodic": dict(periodic=(False, False, False)),
    "two_levels": dict(maxref=2, radii=(0.3, 0.15)),
    "uniform_single_level": dict(n=6, radii=()),
    "multi_device_2": dict(n_devices=2),
    "multi_device_4": dict(n_devices=4),
    "multi_device_8": dict(n_devices=8),
    "multi_device_wrap_corner": dict(n_devices=4, refine_center=(0.0, 0.0, 0.0),
                                     radii=(0.3,), steps=12),
    "multi_device_two_levels": dict(maxref=2, n_devices=2, radii=(0.3, 0.15)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_boxed_matches_jax_and_gather(case):
    kw = dict(_CASES[case])
    ja, pa = _compare(**kw)
    nd = kw.get("n_devices", 1)
    assert pa.boxed.n_devices == nd
    assert sorted(pa.boxed.boxes) == sorted(ja.boxed.boxes)
    assert (sorted((p.fine_level, p.coarse_level) for p in pa.boxed.pairs)
            == sorted((p.fine_level, p.coarse_level) for p in ja.boxed.pairs))
    if case == "two_levels":
        assert sorted(pa.boxed.boxes) == [0, 1, 2] and len(pa.boxed.pairs) == 2
    if case == "uniform_single_level":
        assert list(pa.boxed.boxes) == [0] and not pa.boxed.pairs


def test_boxed_matches_full_3d_velocity():
    """A fully 3-D velocity field exercises the z axis (axis map, z areas,
    z face masks, z cross-level faces)."""
    _compare(velocity={
        "vx": lambda c: np.sin(2 * np.pi * c[:, 2]) + 0.1,
        "vy": lambda c: np.cos(2 * np.pi * c[:, 0]) - 0.2,
        "vz": lambda c: np.sin(2 * np.pi * c[:, 1]) + 0.3,
    })


def test_boxed_run_equals_repeated_boxed_runs():
    g = _grid(dccrg_tpu_torch)
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False)
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)
    once = adv._boxed_run(state, 6, dt)
    twice = adv._boxed_run(adv._boxed_run(state, 3, dt), 3, dt)
    np.testing.assert_allclose(once["density"].numpy(), twice["density"].numpy(),
                               rtol=1e-13, atol=1e-15)


def test_boxed_multi_device_matches_single_device():
    outs = []
    for nd in (1, 4):
        g = _grid(dccrg_tpu_torch, n_devices=nd)
        adv = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False)
        assert adv.boxed is not None
        out = adv._boxed_run(adv.initialize_state(), 10, 0.02)
        outs.append(_rho(g, adv, out, np.sort(g.get_cells())))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-14, atol=1e-16)


@pytest.mark.parametrize("pkg", [dccrg_tpu_torch, dccrg_tpu], ids=["port", "jax"])
def test_boxed_disabled_non_slab_partition(pkg):
    """An RCB repartition has no boxed layout; ZSLAB restores it — in both
    packages alike."""
    g = (pkg.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_load_balancing_method("RCB")
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 8,) * 3)
         .initialize(**_kw(pkg, 2)))
    ids = g.get_cells()
    g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids)
                                                - np.array([0.3, 0.5, 0.5]), axis=1) < 0.25])
    g.stop_refining()
    g.balance_load()
    Adv = dccrg_tpu_torch.Advection if pkg is dccrg_tpu_torch else JAdvection
    assert Adv(g, dtype=np.float64, allow_dense=False).boxed is None
    g._lb_method = "ZSLAB"
    g.balance_load()
    adv = Adv(g, dtype=np.float64, allow_dense=False)
    assert adv.boxed is not None and adv.boxed.n_devices == 2


def test_boxed_disabled_stretched_geometry():
    n = 6
    g = (dccrg_tpu_torch.Grid().set_initial_length((n, n, n))
         .set_neighborhood_length(0).set_periodic(True, True, True)
         .set_geometry(dccrg_tpu_torch.StretchedCartesianGeometry,
                       coordinates=[np.linspace(0.0, 1.0, n + 1) ** 1.3] * 3)
         .initialize(device="cpu"))
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False)
    assert adv.boxed is None and adv._boxed_run is None


def test_run_without_flat_form_takes_gather_step():
    """Where no flat form qualifies (f64 on two levels and one slot) ``run``
    is the gather step, bit for bit, and builds no boxed layout (the JAX
    package runs its boxed passes there)."""
    g = _grid(dccrg_tpu_torch)
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False)
    assert adv._flat_run is None and not adv._prefer_boxed
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)
    want = state
    for _ in range(5):
        want = adv.step(want, dt)
    np.testing.assert_array_equal(adv.run(state, 5, dt)["density"].numpy(),
                                  want["density"].numpy())
    assert adv._boxed is port_advection._UNBUILT and adv._boxed_fn is None


def _seam_case(n_dev):
    """The corner ball crossing every periodic boundary, f32, random
    density and vz: the port's boxed run against its gather steps and the
    JAX package's boxed run."""
    kw = dict(radii=(0.28,), refine_center=(0.0, 0.0, 0.0), n_devices=n_dev,
              dist=_periodic_dist)
    jg, ja, pg, pa = _both(np.float32, **kw)
    assert pa.boxed is not None
    ids = jg.get_cells()
    rng = np.random.default_rng(0)
    cen = jg.geometry.get_center(ids)
    js = ja.initialize_state()
    js = ja.set_cell_data(js, "density", ids, rng.uniform(1, 2, len(ids)).astype(np.float32))
    js = ja.set_cell_data(js, "vz", ids, (0.3 * np.sin(2 * np.pi * cen[:, 2])).astype(np.float32))
    js = jg.update_copies_of_remote_neighbors(js)
    ps = _carry(jg, js, pg)
    dt = np.float32(0.3 * ja.max_time_step(js))
    b = pa._boxed_run(ps, 3, dt)
    st = ps
    for _ in range(3):
        st = pa.step(st, dt)
    np.testing.assert_allclose(_rho(pg, pa, b), _rho(pg, pa, st), rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(_rho(pg, pa, b), _rho(jg, ja, ja._boxed_run(js, 3, dt)),
                               rtol=3e-6, atol=1e-7)


def test_boxed_refinement_across_periodic_seam():
    _seam_case(1)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_boxed_slab_refinement_across_periodic_seam(n_dev):
    _seam_case(n_dev)


def _fuzz_grid(seed, maxref, fracs):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6, 8] if maxref == 1 else [4, 6]))
    n_dev = int(rng.choice([1, 2, 4]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    gs = []
    for pkg in (dccrg_tpu, dccrg_tpu_torch):
        r = np.random.default_rng(seed + 1000)
        g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
             .set_periodic(*periodic).set_maximum_refinement_level(maxref)
             .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(1.0 / n,) * 3)
             .initialize(**_kw(pkg, n_dev)))
        for frac in fracs:
            ids = g.get_cells()
            g.refine_completely_many(r.choice(ids, size=max(1, int(frac * len(ids))),
                                              replace=False))
            g.stop_refining()
        gs.append(g)
    np.testing.assert_array_equal(gs[0].get_cells(), gs[1].get_cells())
    return gs, n_dev, rng


def _fuzz_state(jg, ja, rng):
    ids = jg.get_cells()
    s0 = ja.initialize_state()
    s0 = ja.set_cell_data(s0, "density", ids, rng.uniform(1, 2, len(ids)).astype(np.float32))
    for f in ("vx", "vy", "vz"):
        s0 = ja.set_cell_data(s0, f, ids, rng.uniform(-0.3, 0.3, len(ids)).astype(np.float32))
    return jg.update_copies_of_remote_neighbors(s0)


@pytest.mark.parametrize("seed,maxref,fracs", [
    (1, 1, (0.3,)), (4, 1, (0.3,)), (7, 1, (0.3,)), (11, 1, (0.3,)),
    (0, 2, (0.3, 0.2)), (5, 2, (0.3, 0.2)),
])
def test_fuzz_paths_agree(seed, maxref, fracs):
    """Random refined grids (random periodicity, slot count, velocities,
    scattered refinement; test_fuzz_paths_agree and
    test_fuzz_three_level_boxed): the port's boxed run and flat form match
    its gather steps and the JAX package's boxed run, f32, 5e-6 of the
    peak."""
    (jg, pg), n_dev, rng = _fuzz_grid(seed, maxref, fracs)
    ids = jg.get_cells()
    if jg.mapping.get_refinement_level(ids).max() < maxref:
        pytest.skip("refinement did not reach the top level")
    ja = JAdvection(jg, dtype=np.float32, use_pallas=False)
    pa = dccrg_tpu_torch.Advection(pg, dtype=np.float32, use_kernels=False)
    flat = dccrg_tpu_torch.Advection(pg, dtype=np.float32, allow_boxed=False)
    js = _fuzz_state(jg, ja, rng)
    ps = _carry(jg, js, pg)
    dt = np.float32(0.3 * ja.max_time_step(js))
    st = ps
    for _ in range(3):
        st = pa.step(st, dt)
    ref = _rho(pg, pa, st)
    scale = np.abs(ref).max()
    assert (pa.boxed is None) == (ja.boxed is None)
    if pa._boxed_run is not None:
        rb = _rho(pg, pa, pa._boxed_run(ps, 3, dt))
        assert np.abs(rb - ref).max() / scale < 5e-6
        rj = _rho(jg, ja, ja._boxed_run(js, 3, dt))
        assert np.abs(rb - rj).max() / scale < 5e-6
    if flat._flat_run is not None:
        ra = _rho(pg, flat, flat.run(ps, 3, dt))
        assert np.abs(ra - ref).max() / scale < 5e-6


def test_boxed_at_hood1_matches_gather_step():
    """The boxed layout classifies faces through the same first-entry rule
    as the face tables, so at neighborhood length 1 (where the JAX package
    builds no boxed layout) it equals the port's repaired gather step."""
    g = _grid(dccrg_tpu_torch, maxref=2, radii=(0.3, 0.15), hood=1)
    adv = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False,
                                    use_kernels=False)
    assert adv._boxed_run is not None and len(adv.boxed.pairs) == 2
    s = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(s)
    st = s
    for _ in range(6):
        st = adv.step(st, dt)
    b = adv._boxed_run(s, 6, dt)
    np.testing.assert_allclose(_rho(g, adv, b), _rho(g, adv, st), rtol=1e-12, atol=1e-13)
    assert adv.total_mass(b) == pytest.approx(adv.total_mass(s), rel=1e-12)


# ------------------------------------------------------------- dispatch


_DISPATCH = [
    # (grid kwargs, dtype)
    (dict(refine_center=(0.45, 0.45, 0.45), radii=(0.28,)), np.float32),
    (dict(refine_center=(0.45, 0.45, 0.45), radii=(0.28,)), np.float64),
    (dict(maxref=2, radii=(0.3, 0.15)), np.float32),
    (dict(maxref=2, radii=(0.3, 0.15)), np.float64),
    (dict(maxref=2, radii=(0.45, 0.2)), np.float64),
    (dict(n_devices=2), np.float32),
    (dict(n_devices=4), np.float64),
    (dict(maxref=2, radii=(0.3, 0.15), n_devices=2), np.float32),
    (dict(n=6, radii=()), np.float64),
    (dict(n=8, radii=(0.1,), refine_center=(0.0, 0.0, 0.0)), np.float32),
]


@pytest.mark.parametrize("edges", ["card", "jax"])
@pytest.mark.parametrize("i", range(len(_DISPATCH)))
def test_dispatch_matches_jax(monkeypatch, i, edges):
    """For a given grid, dtype and slot count the port picks the JAX
    package's flat form (``ml_pallas`` / ``ml`` / ``sharded`` / ``pallas``,
    the JAX labels without interpret mode's suffix) and its boxed-or-flat
    choice under the same edge constants: the port's (measured on the
    card) and the JAX package's defaults (2.0, 2.0, 1.5).  The JAX package
    keeps the flat preference in interpret mode, so its choice is
    recomputed from its own voxel count and boxed volume with the edges
    under test; its ``ml`` form computes the choice itself (with its
    defaults)."""
    if edges == "jax":
        monkeypatch.setattr(port_advection, "FLAT_BOXED_EDGE", 2.0)
        monkeypatch.setattr(port_advection, "ML_BOXED_EDGE",
                            {"ml_pallas": 2.0, "ml": 1.5})
    kw, dtype = _DISPATCH[i]
    jg, pg = _grid(dccrg_tpu, **kw), _grid(dccrg_tpu_torch, **kw)
    nd = kw.get("n_devices", 1)
    use = "interpret" if (nd == 1 and dtype == np.float32) else True
    ja = JAdvection(jg, dtype=dtype, allow_dense=False, use_pallas=use)
    pa = dccrg_tpu_torch.Advection(pg, dtype=dtype, allow_dense=False)
    jkind = ja._flat_kind and ja._flat_kind.replace("_interpret", "")
    assert pa._flat_kind == jkind
    assert (pa.boxed is None) == (ja.boxed is None)
    if pa._flat_kind is not None:
        assert pa._flat_n_vox == ja._flat_n_vox
    want = False
    if jkind in ("pallas", "ml", "ml_pallas") and ja.boxed is not None:
        vol = sum(int(np.prod(b.shape)) for b in ja.boxed.boxes.values())
        edge = (port_advection.FLAT_BOXED_EDGE if jkind == "pallas"
                else port_advection.ML_BOXED_EDGE[jkind])
        want = ja._flat_n_vox > edge * vol
        if jkind == "ml" and edges == "jax":
            assert ja._prefer_boxed == want
    assert pa._prefer_boxed == want
