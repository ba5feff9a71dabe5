"""The differential soak battery: randomized cross-checks of every fast path
and subsystem of the port against its oracle (the general gather path, the
invariant checker, or lockstep round trips) — the nine randomized
subsystems of the JAX package's soak harness, ported as plain functions.

    python -m dccrg_tpu_torch.resilience.soak paths --seeds 0 25 --device cuda
    python -m dccrg_tpu_torch.resilience.soak all --seeds 0 10 --device cpu

Each ``one_<name>(seed, device)`` builds its case from
``np.random.default_rng(seed)`` with the JAX body's calls in the JAX body's
order, so a seed builds the same grid, slot count, periodicity, refined
cells, roles and turns in both packages, and asserts the body's oracles at
the body's tolerances.  It returns the body's per-seed tag: the value the
JAX body prints beside the seed (``paths`` and ``three_level`` count tags
in a histogram instead).  On top of the body's checks each seed asserts the
dispatch it drives on the port: the flat kernels B5 (``"pallas"``) and B6
(``"ml_pallas"``) on one slot, the ``sharded`` and ``ml`` forms above one,
B4 (``GameOfLife.fused``) on one slot, B7 (``Vlasov._fused_block`` > 0) and
B8 (``Poisson._solve_fast``) where the grid qualifies.

Which dtype: the JAX bodies ``paths``, ``three_level`` and ``gol`` run with
x64 off (float32 advection, uint32 life), the others with it on, so the
port's models here name float64 wherever those bodies rely on x64
(``Particles(..., dtype=np.float64)``, the f64 Vlasov AMR oracle, the f64
Poisson and checkpointed advection).

``gol`` ports the JAX body's ``one2`` only: the body's first ``one`` is dead
code (its own comment: "turns differ per variant! FIX").  ``amr`` keeps its
own copy of the stress test's ``make_grid``, ``total_mass`` and ``SPEC``
(``tests/test_stress.py`` builds JAX grids).
"""
from __future__ import annotations

import collections
import os
import tempfile

import numpy as np

#: the subsystems, in the JAX harness's order
NAMES = ("paths", "three_level", "amr", "checkpoint", "particles", "gol",
         "hoods", "vlasov", "poisson")

#: the marker each subsystem prints after its seeds (``paths`` and
#: ``three_level`` print ``OK {tag: count}``)
MARKERS = {"amr": "AMR_FUZZ_OK", "checkpoint": "CKPT_FUZZ_OK",
           "particles": "PIC_FUZZ_OK", "gol": "GOL_FUZZ_OK",
           "hoods": "HOOD_FUZZ_OK", "vlasov": "VLASOV_FUZZ_OK",
           "poisson": "POISSON_FUZZ_OK"}

#: the kernels a subsystem's seed range must launch on the card: B5 / B6 /
#: B4 / B7 / B8 where one slot qualifies, B9 (``ring_copy``) on every
#: subsystem with multi-slot seeds
REQUIRED = {"paths": ("flat_amr_run", "ring_copy"),
            "three_level": ("flat_ml_run", "ring_copy"),
            "amr": ("ring_copy",), "checkpoint": ("ring_copy",),
            "particles": ("ring_copy",), "gol": ("gol_run", "ring_copy"),
            "hoods": ("ring_copy",), "vlasov": ("vlasov_step", "ring_copy"),
            "poisson": ("bicg_solve", "ring_copy")}


def _cartesian(n, hood, periodic, max_lvl, n_dev, device):
    """The bodies' cube: n^3 unit-domain Cartesian cells."""
    from .. import CartesianGeometry, Grid

    return (Grid().set_initial_length((n, n, n)).set_neighborhood_length(hood)
            .set_periodic(*periodic).set_maximum_refinement_level(max_lvl)
            .set_geometry(CartesianGeometry, start=(0., 0., 0.),
                          level_0_cell_length=(1. / n,) * 3)
            .initialize(n_devices=n_dev, device=device))


def _advection_state(adv, g, ids, rng):
    """float32 density in [1, 2) and velocities in [-0.3, 0.3), the
    ghosts refreshed (``paths`` / ``three_level``)."""
    s0 = adv.initialize_state()
    s0 = adv.set_cell_data(s0, "density", ids,
                           rng.uniform(1, 2, len(ids)).astype(np.float32))
    for f in ("vx", "vy", "vz"):
        s0 = adv.set_cell_data(s0, f, ids,
                               rng.uniform(-0.3, 0.3, len(ids)).astype(np.float32))
    return g.update_copies_of_remote_neighbors(s0)


# ------------------------------------------------------------------ paths


def one_paths(seed, device):
    """Boxed and flat AMR paths against the general gather path on random
    refined grids (random periodicity, slot counts, velocities, refined
    cells), 5e-6 relative.  The flat form is driven itself
    (``_flat_run``), not through ``run``'s cost rule."""
    from .. import Advection

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6, 8]))
    n_dev = int(rng.choice([1, 2, 4]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    g = _cartesian(n, 0, periodic, 1, n_dev, device)
    ids = g.get_cells()
    k = max(1, int(0.3 * len(ids)))
    for cid in rng.choice(ids, size=k, replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    ids = g.get_cells()
    lvls = g.mapping.get_refinement_level(ids)
    if lvls.max() == 0:
        return "uniform"
    adv = Advection(g, dtype=np.float32, use_kernels=False)  # boxed or general
    flat = Advection(g, dtype=np.float32)
    s0 = _advection_state(adv, g, ids, rng)
    dt = np.float32(0.3 * adv.max_time_step(s0))
    st = s0
    for _ in range(3):
        st = adv.step(st, dt)
    ref = np.asarray(adv.get_cell_data(st, "density", ids), np.float64)
    scale = np.abs(ref).max()
    tags = []
    if adv._boxed_run is not None:
        b = adv._boxed_run(s0, 3, dt)
        rb = np.asarray(adv.get_cell_data(b, "density", ids), np.float64)
        err = np.abs(rb - ref).max() / scale
        assert err < 5e-6, (seed, "BOXED", n, n_dev, periodic, err)
        tags.append("boxed")
    if flat._flat_run is not None:
        want = "pallas" if n_dev == 1 else "sharded"
        assert flat._flat_kind == want, (seed, "flat form", flat._flat_kind, want)
        a = flat._flat_run.run(s0, 3, dt)
        ra = np.asarray(flat.get_cell_data(a, "density", ids), np.float64)
        err = np.abs(ra - ref).max() / scale
        assert err < 5e-6, (seed, "FLAT", n, n_dev, periodic, err)
        tags.append("flat")
    return "+".join(tags) or "general-only"


# ------------------------------------------------------------ three_level


def one_three_level(seed, device):
    """Three leaf levels: the boxed passes and the multi-level flat form
    (B6 on one slot, the ``ml`` pyramid above one) against the general
    step, 5e-6 relative."""
    from .. import Advection

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6]))
    n_dev = int(rng.choice([1, 2, 4]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    g = _cartesian(n, 0, periodic, 2, n_dev, device)
    for frac in (0.3, 0.2):
        ids = g.get_cells()
        for cid in rng.choice(ids, size=max(1, int(frac * len(ids))), replace=False):
            g.refine_completely(int(cid))
        g.stop_refining()
    ids = g.get_cells()
    lv = g.mapping.get_refinement_level(ids)
    if lv.max() < 2:
        return "shallow"
    adv = Advection(g, dtype=np.float32, use_kernels=False)
    if adv._boxed_run is None:
        return "no-boxed"
    s0 = _advection_state(adv, g, ids, rng)
    dt = np.float32(0.3 * adv.max_time_step(s0))
    st = s0
    for _ in range(3):
        st = adv.step(st, dt)
    ref = np.asarray(adv.get_cell_data(st, "density", ids), np.float64)
    b = adv._boxed_run(s0, 3, dt)
    rb = np.asarray(adv.get_cell_data(b, "density", ids), np.float64)
    err = np.abs(rb - ref).max() / np.abs(ref).max()
    assert err < 5e-6, (seed, n, n_dev, periodic, err)
    # the multi-level flat form (when the layout qualifies): same state,
    # same oracle.  The JAX package's CPU run takes its "ml" form; the
    # port's one-slot run takes kernel B6 ("ml_pallas"), the same tag
    adv_ml = Advection(g, dtype=np.float32)
    if adv_ml._flat_kind in ("ml", "ml_pallas"):
        if n_dev == 1:
            assert adv_ml._flat_kind == "ml_pallas", (seed, adv_ml._flat_kind)
        m = adv_ml._flat_run.run(s0, 3, dt)
        rm = np.asarray(adv_ml.get_cell_data(m, "density", ids), np.float64)
        errm = np.abs(rm - ref).max() / np.abs(ref).max()
        assert errm < 5e-6, (seed, "ml", n, n_dev, periodic, errm)
        return "3lvl-ml-ok"
    return "3lvl-ok"


# -------------------------------------------------------------------- amr

#: the stress test's payload (``tests/test_stress.py``)
SPEC = {"density": ((), np.float64)}


def make_grid(n=8, max_lvl=2, n_dev=8, method="RCB", device=None):
    """The stress test's grid: n^3, neighbourhood length 1, periodic in x
    and z, ``method`` load balancing."""
    from .. import CartesianGeometry, Grid

    return (Grid().set_initial_length((n, n, n)).set_neighborhood_length(1)
            .set_periodic(True, False, True).set_maximum_refinement_level(max_lvl)
            .set_load_balancing_method(method)
            .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(1.0 / n,) * 3)
            .initialize(n_devices=n_dev, device=device))


def total_mass(grid, state):
    """Sum over leaves of density x cell volume relative to a level-0
    cell."""
    ids = grid.get_cells()
    rho = grid.get_cell_data(state, "density", ids)
    lvl = grid.mapping.get_refinement_level(ids)
    return float(np.sum(rho * (1.0 / 8.0) ** lvl))


def one_amr(seed, device):
    """Five rounds of 15 random refine / unrefine / dont_* requests, a
    balance every second round: ``verify_grid``, ``verify_user_data`` and
    the level-weighted mass (1e-12) after every commit and balance."""
    from ..utils.verify import verify_grid, verify_user_data

    rng = np.random.default_rng(seed)
    method = str(rng.choice(["RCB", "HILBERT", "GRAPH", "MORTON"]))
    g = make_grid(n=int(rng.choice([4, 6, 8])), max_lvl=2,
                  n_dev=int(rng.choice([2, 4, 8])), method=method, device=device)
    state = g.new_state(SPEC, fill=0.0)
    ids = g.get_cells()
    state = g.set_cell_data(state, "density", ids, rng.uniform(1, 2, len(ids)))
    m = total_mass(g, state)
    for ri in range(5):
        ids = g.get_cells()
        for cid in rng.choice(ids, size=min(15, len(ids)), replace=False):
            op = rng.integers(4)
            if op == 0:
                g.refine_completely(int(cid))
            elif op == 1:
                g.unrefine_completely(int(cid))
            elif op == 2:
                g.dont_refine(int(cid))
            else:
                g.dont_unrefine(int(cid))
        g.stop_refining()
        state = g.remap_state(state)
        verify_grid(g)
        verify_user_data(g, state, SPEC)
        mm = total_mass(g, state)
        assert abs(mm - m) / abs(m) < 1e-12, (seed, ri, mm, m)
        if ri % 2 == 1:
            g.balance_load()
            state = g.remap_state(state)
            verify_grid(g)
            mm = total_mass(g, state)
            assert abs(mm - m) / abs(m) < 1e-12, (seed, ri, "lb", mm, m)
    return method


# ------------------------------------------------------------- checkpoint


def one_checkpoint(seed, device):
    """Save a random refined f64 advection state on 1/2/4 slots, reload it
    on 1/3/8: structure and every field bitwise, then two lockstep steps
    at rtol 1e-13."""
    from .. import Advection, Grid

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6]))
    nd_a = int(rng.choice([1, 2, 4]))
    nd_b = int(rng.choice([1, 3, 8]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    max_lvl = int(rng.choice([1, 2]))
    g = _cartesian(n, 0, periodic, max_lvl, nd_a, device)
    for _ in range(max_lvl):
        ids = g.get_cells()
        for cid in rng.choice(ids, size=max(1, len(ids) // 5), replace=False):
            g.refine_completely(int(cid))
        g.stop_refining()
    ids = g.get_cells()
    adv = Advection(g)
    s = adv.initialize_state()
    s = adv.set_cell_data(s, "density", ids, rng.uniform(1, 2, len(ids)))
    for f in ("vx", "vy", "vz"):
        s = adv.set_cell_data(s, f, ids, rng.uniform(-0.2, 0.2, len(ids)))
    s = g.update_copies_of_remote_neighbors(s)
    spec = {k: adv.spec[k] for k in ("density", "vx", "vy", "vz")}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.dc")
        g.save_grid_data(s, path, spec)
        g2, s2, _ = Grid.load_grid_data(path, spec, n_devices=nd_b, device=device)
    assert np.array_equal(g2.get_cells(), ids), (seed, "structure")
    for f in spec:
        np.testing.assert_array_equal(
            g2.get_cell_data(s2, f, ids), g.get_cell_data(s, f, ids),
            err_msg=f"{seed} field {f}")
    # lockstep advection
    adv2 = Advection(g2)
    full2 = adv2.initialize_state()
    for f in spec:
        full2 = adv2.set_cell_data(full2, f, ids, g2.get_cell_data(s2, f, ids))
    full2 = g2.update_copies_of_remote_neighbors(full2)
    dt = 0.3 * adv.max_time_step(s)
    a, b = s, full2
    for _ in range(2):
        a = adv.step(a, dt)
        b = adv2.step(b, dt)
    np.testing.assert_allclose(
        np.asarray(adv.get_cell_data(a, "density", ids)),
        np.asarray(adv2.get_cell_data(b, "density", ids)),
        rtol=1e-13, atol=0, err_msg=str(seed))
    return (nd_a, nd_b, max_lvl)


# -------------------------------------------------------------- particles


def one_particles(seed, device):
    """Particle count through pushes, the device re-bucket against the
    host path (sorted positions equal), every particle inside its cell,
    and the count through refinement, ``remap`` and a balance."""
    from .. import Particles

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6, 8]))
    n_dev = int(rng.choice([1, 2, 4, 8]))
    maxref = int(rng.choice([1, 2]))   # up to 3 leaf levels
    g = _cartesian(n, 1, (True, True, True), maxref, n_dev, device)
    if rng.random() < 0.7:
        for _round in range(maxref):
            ids = g.get_cells()
            for cid in rng.choice(ids, size=len(ids) // 6 + 1, replace=False):
                g.refine_completely(int(cid))
            g.stop_refining()
    npart = int(rng.integers(200, 1500))
    m = Particles(g, max_particles_per_cell=256, dtype=np.float64)
    # uniform Cartesian fully-periodic grids, refined or not, qualify for
    # the device re-bucket
    assert m._dev_rebucket is not None, (seed, "device path gated off")
    state = m.new_state(rng.random((npart, 3)))
    assert m.count(state) == npart
    vel = m.velocity_field(lambda c: 0.2 * (c - 0.5))
    for turn in range(4):
        state = m.step(state, velocity=vel, dt=0.1)
        assert m.count(state) == npart, (seed, turn)
    # device-vs-host differential on this (possibly refined) grid
    mh = Particles(g, max_particles_per_cell=256, dtype=np.float64)
    mh._dev_rebucket = None
    sh = mh.new_state(m.positions(state))
    state = m.run(state, 2, velocity=(0.03, -0.02, 0.01), dt=0.5)
    for _ in range(2):
        sh = mh.step(sh, velocity=(0.03, -0.02, 0.01), dt=0.5)
    np.testing.assert_array_equal(np.sort(m.positions(state), axis=0),
                                  np.sort(mh.positions(sh), axis=0))
    assert m.count(state) == npart, (seed, "post-differential")
    # bucket validity: every particle inside its cell
    ids = g.get_cells()
    for cell in rng.choice(ids, size=min(30, len(ids)), replace=False):
        pts = m.particles_of(state, int(cell))
        if len(pts):
            lo = g.geometry.get_min(np.asarray([cell], np.uint64))[0]
            hi = g.geometry.get_max(np.asarray([cell], np.uint64))[0]
            assert ((pts >= lo - 1e-12) & (pts <= hi + 1e-12)).all(), (seed, cell)
    # survive AMR + balance
    for cid in rng.choice(ids, size=3, replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    state = m.remap(state)
    assert m.count(state) == npart, (seed, "remap-amr")
    g.balance_load()
    state = m.remap(state)
    vel = m.velocity_field(lambda c: 0.2 * (c - 0.5))
    state = m.step(state, velocity=vel, dt=0.1)
    assert m.count(state) == npart, (seed, "post-lb")
    return n_dev


# -------------------------------------------------------------------- gol


def one_gol(seed, device):
    """The four Game of Life variants from one random board for the same
    turns: dense, fused (B4 on one slot) and overlap against the general
    step, alive sets equal (the JAX body's ``one2``)."""
    from .. import GameOfLife, Grid

    rng = np.random.default_rng(seed)
    nx = int(rng.choice([6, 10, 12, 16]))
    ny = int(rng.choice([6, 10, 12, 16]))
    n_dev = int(rng.choice([1, 2, 4]))
    if ny % n_dev:
        n_dev = 1
    periodic = (bool(rng.integers(0, 2)), bool(rng.integers(0, 2)), False)
    turns = int(rng.integers(3, 20))
    g = (Grid().set_initial_length((nx, ny, 1)).set_maximum_refinement_level(0)
         .set_neighborhood_length(1).set_periodic(*periodic)
         .initialize(n_devices=n_dev, device=device))
    cells = g.get_cells()
    alive0 = cells[rng.random(len(cells)) < rng.uniform(0.2, 0.5)]
    results = {}
    for name, kw in (("general", dict(allow_dense=False)),
                     ("dense", dict(use_kernels=False)),
                     ("fused", dict()),
                     ("overlap", dict(overlap=True))):
        m = GameOfLife(g, **kw)
        if name == "fused" and n_dev == 1:
            assert m.fused, (seed, "B4 not engaged on one slot")
        s = m.run(m.new_state(alive_cells=alive0), turns)
        results[name] = set(m.alive_cells(s).tolist())
    ref = results.pop("general")
    for name, got in results.items():
        assert got == ref, (seed, name, len(got ^ ref))
    return (nx, ny, n_dev, periodic, turns)


# ------------------------------------------------------------------ hoods


def one_hoods(seed, device):
    """Three random user neighbourhoods within the length-2 default:
    ``verify_grid`` after refinement, each hood's covered ghosts bitwise
    equal to their owners after its exchange, then removal and a
    balance."""
    from ..utils.collectives import fetch
    from ..utils.verify import verify_grid

    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6]))
    n_dev = int(rng.choice([1, 2, 4, 8]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    g = _cartesian(n, 2, periodic, 1, n_dev, device)
    # random sub-neighborhoods within the default length-2 hood
    all_offs = [(dx, dy, dz) for dx in range(-2, 3) for dy in range(-2, 3)
                for dz in range(-2, 3) if (dx, dy, dz) != (0, 0, 0)]
    hoods = []
    for hid in range(1, 4):
        k = int(rng.integers(1, 10))
        offs = [all_offs[i] for i in rng.choice(len(all_offs), k, replace=False)]
        assert g.add_neighborhood(hid, offs)
        hoods.append(hid)
    # refine and verify all hood state stays consistent
    ids = g.get_cells()
    for cid in rng.choice(ids, size=max(1, len(ids) // 4), replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    verify_grid(g)
    # per-hood ghost identity, compared on the host
    spec = {"q": ((), np.float64)}
    state = g.new_state(spec)
    ids = g.get_cells()
    state = g.set_cell_data(state, "q", ids, rng.uniform(0, 1, len(ids)))
    for hid in [None] + hoods:
        st = g.update_copies_of_remote_neighbors(state, hid)
        ep = g.epoch
        arr = fetch(st["q"])
        h = ep.hoods[hid]
        recv = fetch(h.recv_rows)
        owner, row_of = fetch(ep.leaves.owner), fetch(ep.row_of)
        for d in range(g.n_devices):
            gp = ep.ghost_pos[d]
            # only ghosts this hood's schedule covers
            rows = ep.rows_on_device(d, gp)
            scr = ep.R - 1
            rr = recv[d].reshape(-1)
            covered = np.isin(rows, rr[rr != scr])
            if covered.any():
                own = arr[owner[gp[covered]], row_of[gp[covered]]]
                got = arr[d, rows[covered]]
                np.testing.assert_array_equal(got, own, err_msg=f"{seed} hood {hid} dev {d}")
    # removal keeps things consistent
    g.remove_neighborhood(hoods[0])
    verify_grid(g)
    g.balance_load()
    verify_grid(g)
    return n_dev


# ----------------------------------------------------------------- vlasov


def one_vlasov(seed, device):
    """Mass over 6 float32 steps (1e-5 periodic; open z only loses), the
    step kernel B7 bitwise equal to the plain step, and on even seeds one
    velocity bin of the refined (general, f64) step against the advection
    gather step with that bin's velocity, 1e-11."""
    from .. import Advection, Vlasov
    from ..utils.collectives import fetch

    rng = np.random.default_rng(seed)
    n = int(rng.choice([8, 16]))
    n_dev = int(rng.choice([1, 2, 4]))
    periodic = (True, True, bool(rng.integers(0, 2)))
    g = _cartesian(n, 0, periodic, 0, n_dev, device)
    v = Vlasov(g, nv=4, dtype=np.float32, use_kernels=False)
    s0 = v.initialize_state()
    m0 = v.total_mass(s0)
    dt = np.float32(0.4 * v.max_time_step())
    state = v.run(s0, 6, dt)
    m1 = v.total_mass(state)
    if all(periodic):
        assert abs(m1 - m0) / m0 < 1e-5, (seed, m0, m1)
    else:
        assert m1 <= m0 * (1 + 1e-5), (seed, m0, m1)  # open z only loses
    assert np.isfinite(fetch(state["f"])).all(), seed
    # the step kernel must be bit-identical to the plain split step
    vf = Vlasov(g, nv=4, dtype=np.float32)
    assert vf._fused_block > 0, seed
    sf = vf.run(s0, 6, dt)
    a32 = fetch(sf["f"]).astype(np.float32)
    b32 = fetch(state["f"]).astype(np.float32)
    assert np.array_equal(a32, b32), (
        seed, "B7 vs the plain step", int((a32 != b32).sum()),
        float(np.abs(a32 - b32).max()))
    # general/AMR path on a randomly refined grid: every bin's unsplit
    # update must equal the advection general step with that bin's
    # constant velocity.  Fully periodic: the advection oracle's open
    # boundaries are zero-flux walls while Vlasov's are outflow
    if seed % 2 == 0:
        na = 4
        ga = _cartesian(na, 0, (True, True, True), 1, n_dev, device)
        ids0 = ga.get_cells()
        for cid in rng.choice(ids0, size=max(1, len(ids0) // 5), replace=False):
            ga.refine_completely(int(cid))
        ga.stop_refining()
        va = Vlasov(ga, nv=2, dtype=np.float64)
        assert va.info is None, seed
        sa = va.initialize_state()
        dta = 0.4 * va.max_time_step()
        oa = va.run(sa, 3, dta)
        ids = np.sort(ga.leaves.cells)
        f0 = np.asarray(ga.get_cell_data(sa, "f", ids), np.float64)
        fT = np.asarray(ga.get_cell_data(oa, "f", ids), np.float64)
        adv = Advection(ga, dtype=np.float64, use_kernels=False, allow_boxed=False)
        b = int(rng.integers(0, va.B))
        st = adv.initialize_state()
        st = adv.set_cell_data(st, "density", ids, f0[:, b])
        for d3, nm in enumerate(("vx", "vy", "vz")):
            st = adv.set_cell_data(st, nm, ids, np.full(len(ids), va.v_bins[b, d3]))
        st = ga.update_copies_of_remote_neighbors(st)
        for _ in range(3):
            st = adv.step(st, dta)
        want = np.asarray(ga.get_cell_data(st, "density", ids), np.float64)
        errb = np.abs(fT[:, b] - want).max() / max(np.abs(want).max(), 1e-30)
        assert errb < 1e-11, (seed, b, errb)
    return periodic, n_dev


# ---------------------------------------------------------------- poisson


def poisson_case(seed, device):
    """The ``poisson`` body's grid, rhs, roles and first draws: ``(g,
    cells, rhs, kw, n_dev, mode, rng)`` with ``rng`` positioned where the
    body builds its models."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6, 8]))
    n_dev = int(rng.choice([1, 2, 4]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    maxref = int(rng.integers(0, 3))   # 0-2: up to 3 leaf levels
    g = _cartesian(n, 0, periodic, maxref, n_dev, device)
    for _round in range(maxref):
        ids = g.get_cells()
        k = max(1, int(0.2 * len(ids)))
        for cid in rng.choice(ids, size=k, replace=False):
            g.refine_completely(int(cid))
        g.stop_refining()
    cells = g.get_cells()
    rhs = rng.standard_normal(len(cells))
    kw = {}
    mode = rng.integers(0, 3)
    if mode == 1:          # skip a random subset
        kw["skip_cells"] = rng.choice(cells, size=len(cells) // 8 + 1, replace=False)
    elif mode == 2:        # explicit solve set with boundary remainder
        sel = rng.random(len(cells)) < 0.7
        if not sel.any():
            sel[0] = True
        kw["solve_cells"] = cells[sel]
    return g, cells, rhs, kw, n_dev, mode, rng


def one_poisson(seed, device):
    """The flat operator against the gather tables (A·v and Aᵀ·v 1e-10),
    the rolled operator against the gather (1e-10 on real rows), the
    restarted solves (flat residual within 10x the gather's, solutions
    1e-7 when both converge), and the float32 whole-solve kernel B8
    against the float32 flat solve without it (iterations within 1,
    solution 1e-4 of scale)."""
    from .. import Poisson
    from ..utils.collectives import fetch

    g, cells, rhs, kw, n_dev, mode, rng = poisson_case(seed, device)
    pf = Poisson(g, **kw)
    pg = Poisson(g, allow_flat=False, allow_rolled=False, **kw)  # raw oracle
    # the rolled operator (any slot count) must be the gather operator
    # entry for entry on random vectors over the real rows; checked before
    # the flat early return (flat-refusing grids are its audience)
    prl = Poisson(g, allow_flat=False, allow_rolled=True, **kw)
    if prl._rolled is not None:
        mfo, mro = pg._mult_tables()
        local = fetch(pg.tables.local_mask)
        vro = rng.standard_normal(len(cells))
        sR = g.new_state(pg.spec)
        xR = g.set_cell_data(sR, "solution", cells, vro)["solution"]
        for mult, rolled in ((mfo, prl._rolled[0]), (mro, prl._rolled[1])):
            a_g = fetch(pg._apply(xR, mult)[0])
            a_r = fetch(rolled(xR))
            ops = max(1.0, np.abs(a_g).max())
            da = np.abs(np.where(local, a_g - a_r, 0.0)).max()
            assert da < 1e-10 * ops, (seed, "rolled", da, ops)
    if pf._flat is None:
        return "rolled-only" if prl._rolled is not None else "gather-only"

    # operator-level oracle: A.v and A^T.v to fp roundoff on a random vector
    vr = rng.standard_normal(len(cells))
    sV = g.new_state(pf.spec)
    sV = g.set_cell_data(sV, "solution", cells, vr)
    mf, mr = pg._mult_tables()
    af, ar, vox, wb, _masks = pf._flat
    for mult, fl in ((mf, af), (mr, ar)):
        a_g, _ = pg._apply(sV["solution"], mult)
        a_f = wb(fl(vox(sV["solution"])))
        ag = np.asarray(g.get_cell_data({"solution": a_g}, "solution", cells))
        afc = np.asarray(g.get_cell_data({"solution": a_f}, "solution", cells))
        ops = max(1.0, np.abs(ag).max())
        assert np.abs(ag - afc).max() < 1e-10 * ops, (seed, np.abs(ag - afc).max(), ops)

    s0 = g.new_state(pf.spec)
    s0 = g.set_cell_data(s0, "rhs", cells, rhs - rhs.mean())
    rhs_norm = float(np.linalg.norm(rhs))

    def restarted(p):
        # the reference's usage shape: restarts rebuild the Krylov space
        # from the best solution after a breakdown; compare the paths
        # under the same restart loop, not single trajectories
        st, _r, _i = p.solve(s0, max_iterations=200, stop_residual=1e-11, restarts=8)
        return st

    of = restarted(pf)
    og = restarted(pg)
    rf_chk = pg.residual(of)
    rg_chk = pg.residual(og)
    assert rf_chk <= 10.0 * rg_chk + 1e-9 * rhs_norm, (seed, rf_chk, rg_chk)
    if max(rf_chk, rg_chk) < 1e-10 * rhs_norm:
        sf = np.asarray(g.get_cell_data(of, "solution", cells))
        sg = np.asarray(g.get_cell_data(og, "solution", cells))
        scale = max(1.0, np.abs(sg).max())
        assert np.abs(sf - sg).max() < 1e-7 * scale, (seed, np.abs(sf - sg).max(), scale)

    # the whole-solve kernel B8 against the f32 flat path without it: the
    # same masked loop, so the same iteration count and solver-tolerance
    # equal solutions
    pk = Poisson(g, dtype=np.float32, **kw)
    if pk._solve_fast is not None:
        px = Poisson(g, dtype=np.float32, use_kernels=False, **kw)
        s32 = g.new_state(pk.spec)
        s32 = g.set_cell_data(s32, "rhs", cells, (rhs - rhs.mean()).astype(np.float32))
        ok_, rk, itk = pk.solve(s32, max_iterations=40, stop_residual=1e-4)
        assert pk._solve_fast is not None, (seed, "kernel fell back")
        ox_, rx, itx = px.solve(s32, max_iterations=40, stop_residual=1e-4)
        assert abs(itk - itx) <= 1, (seed, itk, itx)
        sk = np.asarray(g.get_cell_data(ok_, "solution", cells))
        sx = np.asarray(g.get_cell_data(ox_, "solution", cells))
        scale = max(1.0, np.abs(sx).max())
        assert np.abs(sk - sx).max() < 1e-4 * scale, (seed, np.abs(sk - sx).max(), scale)
    return "flat-ok", n_dev, mode


ONE = {"paths": one_paths, "three_level": one_three_level, "amr": one_amr,
       "checkpoint": one_checkpoint, "particles": one_particles,
       "gol": one_gol, "hoods": one_hoods, "vlasov": one_vlasov,
       "poisson": one_poisson}


def run_seeds(name: str, lo: int, hi: int, device: str, out=print) -> str:
    """Run ``name``'s seeds ``[lo, hi)`` on ``device`` as the JAX body
    does: a line ``<seed> <tag>`` a seed (``paths`` and ``three_level``
    count tags instead), then the body's marker.  Returns the marker line
    (``OK {tag: count}`` or ``*_FUZZ_OK``); an assertion propagates."""
    one = ONE[name]
    if name in ("paths", "three_level"):
        stats = collections.Counter()
        for seed in range(lo, hi):
            try:
                stats[one(seed, device)] += 1
            except AssertionError as e:
                if name == "paths":
                    out(f"MISMATCH: {e}")
                raise
        return f"OK {dict(stats)}"
    for seed in range(lo, hi):
        out(f"{seed} {one(seed, device)}")
    return MARKERS[name]
