"""Exchange-amortized cohort bodies of the port (``parallel/wide_halo.py``
and the models' ``_wide_spec``), the JAX package's
``tests/test_wide_halo.py`` case for case on the CPU: owned rows bitwise
equal to exchange-every-step stepping at every (g, k), also for members
retiring mid-block and heterogeneous cohorts; hood-0 grids disengage;
changing only g builds one body; ``select_k`` clamps to the exchange
budget; ``halo.exchanges_per_step`` reads 1/k; the solo ``run()``
keeps its input.  The wide plans equal the JAX package's on the same grids
(uniform and refined), and on a refined grid at neighbourhood length 2 the
wide advection cohort, which prices each (neighbour, direction) once, is
held against the JAX package's length-0 gather step on the same leaves
(1e-12 relative, float64).  Counters are read as deltas."""
import numpy as np
import pytest
import torch

import dccrg_tpu as J
import dccrg_tpu.models as JM
from dccrg_tpu.parallel import wide_halo as JW
from dccrg_tpu_torch import CartesianGeometry, Grid, obs
from dccrg_tpu_torch.models import Advection, GameOfLife, Vlasov
from dccrg_tpu_torch.parallel import halo
from dccrg_tpu_torch.parallel.exec_cache import cohort_key
from dccrg_tpu_torch.parallel.wide_halo import get_wide_plan, halo_depth_cap
from dccrg_tpu_torch.serve import Ensemble, Scenario, Scheduler

MOORE = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
         for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)]
GOL_HOOD = 7


def make_grid(n=6, hood=2, max_ref=0, refine_seed=None, n_dev=8, pkg="torch",
              leaf_set=None):
    g = ((Grid() if pkg == "torch" else J.Grid())
         .set_initial_length((n, n, n)).set_neighborhood_length(hood)
         .set_periodic(True, True, True).set_maximum_refinement_level(max_ref)
         .set_geometry(CartesianGeometry if pkg == "torch" else J.CartesianGeometry,
                       start=(0.0, 0.0, 0.0), level_0_cell_length=(1.0 / n,) * 3))
    g = (g.initialize(n_devices=n_dev, device="cpu", leaf_set=leaf_set) if pkg == "torch"
         else g.initialize(mesh=J.make_mesh(n_devices=n_dev), leaf_set=leaf_set))
    if refine_seed is not None:
        rng = np.random.default_rng(refine_seed)
        ids = np.sort(g.get_cells())
        for cid in rng.choice(ids, size=max(1, len(ids) // 6), replace=False):
            g.refine_completely(int(cid))
    g.stop_refining()
    return g


def make_gol(n=6, hood=2):
    g = make_grid(n=n, hood=hood)
    assert g.add_neighborhood(GOL_HOOD, MOORE)
    return g, GameOfLife(g, hood_id=GOL_HOOD, allow_dense=False)


def counter_total(name: str) -> int:
    return int(sum(obs.metrics.report()["counters"].get(name, {}).values()))


def solo(model, state, steps, dt=None):
    for _ in range(steps):
        state = model.step(state) if dt is None else model.step(state, dt)
    return state


def assert_local_rows_equal(model, ref, got):
    """Owned rows byte for byte; ghost rows may hold block-stale values."""
    lm = torch.as_tensor(model.batch_step_spec().wide.local_mask)
    for name in sorted(ref):
        a, b = ref[name], got[name]
        if tuple(a.shape[:2]) == tuple(lm.shape):
            a, b = a[lm], b[lm]
        assert torch.equal(a, b), name


# ------------------------------------------------- (g, k) bit-identity


@pytest.mark.parametrize("hood,k", [(2, 1), (2, 2), (2, 4), (3, 3)])
def test_gol_wide_bit_identical_at_g_k(hood, k):
    g, gol = make_gol(hood=hood)
    spec = gol.batch_step_spec()
    assert spec.wide is not None and spec.wide.budget >= 2
    rng = np.random.default_rng(11)
    cells = g.get_cells()
    states = [gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
              for _ in range(3)]
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=k)
    tickets = [ens.submit(gol, s, steps=2 * k + 1) for s in states]
    ens.run()
    assert next(iter(ens.cohorts.values()))._wide is not None
    for t, s0 in zip(tickets, states):
        assert_local_rows_equal(gol, solo(gol, s0, 2 * k + 1), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


@pytest.mark.parametrize("hood,k", [(2, 4), (3, 5)])
def test_advection_wide_bit_identical_at_g_k(hood, k):
    g = make_grid(n=8, hood=hood)
    adv = Advection(g, dtype=np.float64, allow_dense=False)
    spec = adv.batch_step_spec()
    assert spec.wide is not None and spec.wide.budget >= hood
    s0 = adv.initialize_state()
    dt = float(0.4 * adv.max_time_step(s0))
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=k)
    t = ens.submit(adv, s0, steps=k + 1, dt=dt)
    ens.run()
    assert_local_rows_equal(adv, solo(adv, s0, k + 1, dt), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


def test_vlasov_wide_bit_identical(vl_nv=2):
    g = make_grid(n=6, hood=2)
    vl = Vlasov(g, nv=vl_nv, dtype=np.float32)
    assert vl.info is None
    spec = vl.batch_step_spec()
    assert spec.wide is not None and spec.wide.budget >= 2
    s0 = vl.initialize_state()
    dt = float(np.float32(0.5 * vl.max_time_step()))
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=4)
    t = ens.submit(vl, s0, steps=5, dt=dt)
    ens.run()
    assert_local_rows_equal(vl, solo(vl, s0, 5, dt), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


def test_mid_block_retirement_and_direct_deep_step():
    g = make_grid(n=8, hood=2)
    adv = Advection(g, dtype=np.float64, allow_dense=False)
    s0 = adv.initialize_state()
    dt = float(0.4 * adv.max_time_step(s0))
    s1 = {k: v.clone() for k, v in s0.items()}
    s1["density"] = s1["density"] * 1.5
    m0 = counter_total("ensemble.verify_mismatches")
    sched = Scheduler(verify=True)
    t5 = sched.submit(Scenario(adv, s0, steps=5, dt=dt))
    t3 = sched.submit(Scenario(adv, s1, steps=3, dt=dt))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    assert cohort._wide is not None and cohort._wide_budget == 2
    assert cohort.step(5) == 5 + 3
    for slot in cohort.finished_slots():
        sched.completed.append(cohort.retire(int(slot)))
    for t, start, n in ((t5, s0, 5), (t3, s1, 3)):
        assert_local_rows_equal(adv, solo(adv, start, n, dt), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


def test_heterogeneous_same_signature_wide_cohort():
    g1 = make_grid(n=4, hood=2, max_ref=1, refine_seed=1)
    g2 = make_grid(n=4, hood=2, max_ref=1, refine_seed=2)
    a1 = Advection(g1, dtype=np.float64, allow_dense=False)
    a2 = Advection(g2, dtype=np.float64, allow_dense=False)
    assert g1.shape_signature() == g2.shape_signature()
    assert a1.batch_step_spec().wide is not None and a2.batch_step_spec().wide is not None
    s1, s2 = a1.initialize_state(), a2.initialize_state()
    dt = float(0.4 * min(a1.max_time_step(s1), a2.max_time_step(s2)))
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=2)
    t1 = ens.submit(a1, s1, steps=4, dt=dt)
    t2 = ens.submit(a2, s2, steps=4, dt=dt)
    ens.run()
    assert len(ens.cohorts) == 1
    cohort = next(iter(ens.cohorts.values()))
    assert cohort._wide is not None and not cohort.shared_args
    for t, a, s0 in ((t1, a1, s1), (t2, a2, s2)):
        assert_local_rows_equal(a, solo(a, s0, 4, dt), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


# ---------------------------------------------------- (dis)engagement


def test_hood0_grids_disengage():
    g = make_grid(hood=0)
    gol = GameOfLife(g, allow_dense=False)
    assert gol.batch_step_spec().wide is None
    s0 = gol.new_state(alive_cells=g.get_cells()[::3])
    ens = Ensemble(steps_per_dispatch=4)
    t = ens.submit(gol, s0, steps=4)
    ens.run()
    cohort = next(iter(ens.cohorts.values()))
    assert cohort._wide is None and cohort._wide_g(4) == 0
    assert torch.equal(solo(gol, s0, 4)["is_alive"], t.result["is_alive"])


def test_env_gate_disables_wide(monkeypatch):
    monkeypatch.setenv("DCCRG_ENSEMBLE_WIDE", "0")
    _, gol = make_gol()
    assert gol.batch_step_spec().wide is None


# ----------------------------------------------- body accounting


def test_zero_retrace_churn_at_held_sig_width_k_g():
    g, gol = make_gol(hood=2)
    rng = np.random.default_rng(3)
    cells = g.get_cells()
    states = [gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
              for _ in range(12)]
    ens = Ensemble(steps_per_dispatch=2)
    for s in states[:4]:
        ens.submit(gol, s, steps=4)
    ens.run()
    before = counter_total("epoch.cache_misses")
    for wave in (states[4:8], states[8:10], states[10:12]):
        for i, s in enumerate(wave):
            ens.submit(gol, s, steps=2 * (i + 1))
        ens.run()
    assert counter_total("epoch.cache_misses") == before
    assert len(ens.completed) == 12


def test_changing_only_g_compiles_exactly_one_body(monkeypatch):
    g = make_grid(n=8, hood=3)
    adv = Advection(g, dtype=np.float64, allow_dense=False)
    spec = adv.batch_step_spec()
    assert spec.wide is not None and spec.wide.budget >= 3
    s0 = adv.initialize_state()
    dt = float(0.4 * adv.max_time_step(s0))
    sched = Scheduler()
    sched.submit(Scenario(adv, s0, steps=64, dt=dt))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    cohort.step(3)
    before = counter_total("epoch.cache_misses")
    cohort.step(3)
    assert counter_total("epoch.cache_misses") == before
    monkeypatch.setenv("DCCRG_HALO_DEPTH", "2")
    assert halo_depth_cap() == 2
    cohort.step(3)
    assert counter_total("epoch.cache_misses") == before + 1
    monkeypatch.delenv("DCCRG_HALO_DEPTH")
    cohort.step(3)
    assert counter_total("epoch.cache_misses") == before + 1
    assert cohort_key(spec, cohort.W, 3, wide_g=3) != cohort_key(spec, cohort.W, 3, wide_g=2)


# --------------------------------------------------------- scheduling


def test_select_k_clamps_to_exchange_budget():
    g, gol = make_gol(hood=2)
    s0 = gol.new_state(alive_cells=g.get_cells()[::2])
    sched = Scheduler(steps_per_dispatch=16)
    sched.submit(Scenario(gol, s0, steps=64))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    assert cohort._wide is not None and cohort._wide_budget == 2
    assert sched.select_k(cohort) == 2
    cohort._remaining[:] = np.where(cohort._occupied, 1, 0)
    assert sched.select_k(cohort) == 1


# ---------------------------------------------------------- telemetry


def test_exchanges_per_step_gauge_drops_to_one_over_k():
    halo._amortization.clear()
    g, gol = make_gol(hood=2)
    s0 = gol.new_state(alive_cells=g.get_cells()[::2])
    sched = Scheduler()
    sched.submit(Scenario(gol, s0, steps=64))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    cohort.step(2)
    assert obs.metrics.report()["gauges"]["halo.exchanges_per_step"]["model=gol"] == 0.5
    cohort.step(4)
    assert obs.metrics.report()["gauges"]["halo.exchanges_per_step"]["model=gol"] == 0.5
    halo._amortization.clear()
    halo.record_dispatch_exchanges("gol", 4, 4)
    assert obs.metrics.report()["gauges"]["halo.exchanges_per_step"]["model=gol"] == 1.0


# ----------------------------------------------------- run() donation


def test_run_donate_knob_reads_env_and_run_keeps_input(monkeypatch):
    """``DCCRG_RUN_DONATE`` reads as in the JAX package, and a solo
    ``run()`` never consumes its input state: the input is unchanged and
    still steps to the same result."""
    from dccrg_tpu_torch.parallel.exec_cache import run_donate_enabled

    monkeypatch.delenv("DCCRG_RUN_DONATE", raising=False)
    assert run_donate_enabled() is False
    monkeypatch.setenv("DCCRG_RUN_DONATE", "1")
    assert run_donate_enabled() is True
    g = make_grid(hood=0)
    adv = Advection(g, dtype=np.float64, allow_dense=False)
    s0 = adv.initialize_state()
    before = s0["density"].clone()
    dt = float(0.4 * adv.max_time_step(s0))
    out = adv.run(s0, 3, dt)
    assert torch.equal(s0["density"], before)
    assert torch.equal(solo(adv, s0, 3, dt)["density"], out["density"])
    vl = Vlasov(make_grid(hood=0), nv=2, dtype=np.float32)
    sv = vl.initialize_state()
    fv = sv["f"].clone()
    dtv = float(np.float32(0.5 * vl.max_time_step()))
    out2 = vl.run(sv, 3, dtv)
    assert torch.equal(sv["f"], fv)
    assert torch.equal(solo(vl, sv, 3, dtv)["f"], out2["f"])


# --------------------------------------------------------- wide plans


def test_wide_plan_budget_matches_hood_depth():
    """Budgets of the JAX package, and the plans equal its plans array for
    array on the same grids (uniform, and refined at length 2)."""
    g = make_grid(n=8, hood=2)
    assert get_wide_plan(g, None, relevance="face").budget == 2
    g2, _ = make_gol(n=8, hood=2)
    assert get_wide_plan(g2, GOL_HOOD, relevance="all").budget == 2
    jg = make_grid(n=8, hood=2, pkg="jax")
    for pg_, jg_, rel in ((g, jg, "face"),):
        a, b = get_wide_plan(pg_, None, rel), JW.get_wide_plan(jg_, None, rel)
        for f in ("nbr_rows", "nbr_valid", "nbr_offset", "nbr_len", "nbr_slot",
                  "steps_ok", "local_mask"):
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), f)
        assert a.budget == b.budget
    pr = make_grid(n=4, hood=2, max_ref=1, refine_seed=1, n_dev=2)
    jr = make_grid(n=4, hood=2, max_ref=1, refine_seed=1, n_dev=2, pkg="jax")
    a, b = get_wide_plan(pr, None, "face"), JW.get_wide_plan(jr, None, "face")
    np.testing.assert_array_equal(a.steps_ok, np.asarray(b.steps_ok))
    assert a.budget == b.budget


def test_refined_wide_cohort_at_length_2_matches_jax_length_0():
    """On a refined grid at neighbourhood length 2 a larger face neighbour
    is listed for several offsets; the wide face tables price it once.
    The wide cohort's owned rows equal the port's solo gather step bitwise
    and the JAX package's length-0 gather step on the same leaves to
    1e-12 relative."""
    pg = make_grid(n=4, hood=2, max_ref=1, refine_seed=1, n_dev=2)
    pa = Advection(pg, dtype=np.float64, allow_dense=False)
    assert pa.batch_step_spec().wide is not None
    s0 = pa.initialize_state()
    dt = float(0.4 * pa.max_time_step(s0))
    ens = Ensemble(steps_per_dispatch=2)
    t = ens.submit(pa, s0, steps=4, dt=dt)
    ens.run()
    assert next(iter(ens.cohorts.values()))._wide is not None
    assert_local_rows_equal(pa, solo(pa, s0, 4, dt), t.result)
    cells = pg.get_cells()
    jg = make_grid(n=4, hood=0, max_ref=1, n_dev=2, pkg="jax", leaf_set=cells)
    ja = JM.Advection(jg, dtype=np.float64, use_pallas=False, allow_boxed=False)
    js = ja.initialize_state()
    for _ in range(4):
        js = ja.step(js, dt)
    np.testing.assert_allclose(pg.get_cell_data(t.result, "density", cells),
                               np.asarray(jg.get_cell_data(js, "density", cells)),
                               rtol=1e-12)
