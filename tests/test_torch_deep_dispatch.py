"""Deep dispatch of the port's cohorts: k steps a dispatch, donation and
shared tables (the JAX package's ``tests/test_deep_dispatch.py`` case for
case on the CPU).  A depth-k dispatch is bitwise equal to k solo steps,
also for members retiring mid-block and for heterogeneous grids (whose
cohort is held against the JAX package's to 1e-12, float64); churn at a
held (signature, width, k) builds no body and changing only k builds one
(``epoch.cache_misses``: the port compiles nothing at run time, so the
executable cache's misses count the bodies); the scheduler's k selection
and promotions equal the JAX package's on the same inputs.  Counters are
read as deltas."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import dccrg_tpu as J
import dccrg_tpu.models as JM
import dccrg_tpu.serve as JS
from dccrg_tpu_torch import CartesianGeometry, Grid, obs
from dccrg_tpu_torch.models import Advection, GameOfLife
from dccrg_tpu_torch.obs.events import timeline
from dccrg_tpu_torch.parallel.exec_cache import (
    cohort_key,
    default_steps_per_dispatch,
    max_steps_per_dispatch,
)
from dccrg_tpu_torch.parallel.halo import interior_steps_per_exchange
from dccrg_tpu_torch.serve import Ensemble, Scenario, Scheduler


def make_grid(n=4, n_dev=1, max_ref=0, refine_seed=None, pkg="torch"):
    g = ((Grid() if pkg == "torch" else J.Grid())
         .set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(max_ref)
         .set_geometry(CartesianGeometry if pkg == "torch" else J.CartesianGeometry,
                       start=(0.0, 0.0, 0.0), level_0_cell_length=(1.0 / n,) * 3))
    g = (g.initialize(n_devices=n_dev, device="cpu") if pkg == "torch"
         else g.initialize(mesh=J.make_mesh(n_devices=n_dev)))
    if refine_seed is not None:
        rng = np.random.default_rng(refine_seed)
        ids = np.sort(g.get_cells())
        for cid in rng.choice(ids, size=max(1, len(ids) // 6), replace=False):
            g.refine_completely(int(cid))
    g.stop_refining()
    return g


def gol_states(gol, g, count, seed=0):
    rng = np.random.default_rng(seed)
    cells = g.get_cells()
    return [gol.new_state(alive_cells=cells[rng.random(len(cells)) < 0.3])
            for _ in range(count)]


def tree_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def counter_total(name: str) -> int:
    return int(sum(obs.metrics.report()["counters"].get(name, {}).values()))


def solo(model, state, steps, dt=None):
    for _ in range(steps):
        state = model.step(state) if dt is None else model.step(state, dt)
    return state


# --------------------------------------------- k-step bit-identity


def test_k4_gol_bit_identical_incl_mid_k_retirement():
    # two slots of a 6^3 board: every dispatch exchanges ghost rows (a
    # wide plan funds one step here, so the legacy body runs)
    g = make_grid(n=6, n_dev=2)
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 4, seed=1)
    c0 = counter_total("ensemble.verify_checks")
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=4)
    budgets = [6, 8, 8, 8]
    tickets = [ens.submit(gol, s, steps=b) for s, b in zip(states, budgets)]
    ens.run()
    for t, s0, b in zip(tickets, states, budgets):
        assert t.status == "done" and t.steps_done == b
        assert tree_equal(solo(gol, s0, b), t.result)
    assert counter_total("ensemble.verify_checks") > c0
    assert counter_total("ensemble.verify_mismatches") == m0


def test_advection_f64_heterogeneous_cohort_k_steps_bit_identical():
    g1 = make_grid(max_ref=1, refine_seed=3)
    g2 = make_grid(max_ref=1, refine_seed=4)
    a1 = Advection(g1, dtype=np.float64, allow_dense=False)
    a2 = Advection(g2, dtype=np.float64, allow_dense=False)
    assert g1.shape_signature() == g2.shape_signature()
    s1, s2 = a1.initialize_state(), a2.initialize_state()
    dt = 0.4 * a1.max_time_step(s1)
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=3)
    t1 = ens.submit(a1, s1, steps=5, dt=dt, tenant="a")
    t2 = ens.submit(a2, s2, steps=6, dt=dt * 0.9, tenant="b")
    ens.run()
    assert len(ens.cohorts) == 1
    assert torch.equal(solo(a1, s1, 5, dt)["density"], t1.result["density"])
    assert torch.equal(solo(a2, s2, 6, dt * 0.9)["density"], t2.result["density"])
    assert counter_total("ensemble.verify_mismatches") == m0
    # the JAX package's depth-3 cohort of the first member
    jg = make_grid(max_ref=1, refine_seed=3, pkg="jax")
    ja = JM.Advection(jg, dtype=np.float64, allow_dense=False)
    jens = JS.Ensemble(steps_per_dispatch=3)
    jt = jens.submit(ja, ja.initialize_state(), steps=5, dt=dt)
    jens.run()
    cells = g1.get_cells()
    np.testing.assert_allclose(g1.get_cell_data(t1.result, "density", cells),
                               jg.get_cell_data(jt.result, "density", cells), rtol=1e-12)


# --------------------------------------------- body accounting


def test_zero_retrace_churn_at_held_signature_width_and_k():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 12, seed=2)
    ens = Ensemble(steps_per_dispatch=4)
    for s in states[:4]:
        ens.submit(gol, s, steps=8)
    ens.run()
    m0, r0 = counter_total("epoch.cache_misses"), counter_total("epoch.recompiles")
    for wave in (states[4:8], states[8:10], states[10:12]):
        for i, s in enumerate(wave):
            ens.submit(gol, s, steps=4 * (i + 1))
        ens.run()
    assert counter_total("epoch.cache_misses") == m0
    assert counter_total("epoch.recompiles") == r0
    assert len(ens.completed) == 12


def test_changing_only_k_compiles_exactly_one_body():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 2, seed=3)
    sched = Scheduler()
    for s in states:
        sched.submit(Scenario(gol, s, 64))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    cohort.step(1)
    before = counter_total("epoch.cache_misses")
    cohort.step(4)
    assert counter_total("epoch.cache_misses") == before + 1
    cohort.step(4)
    cohort.step(1)
    assert counter_total("epoch.cache_misses") == before + 1
    spec = cohort.spec
    assert cohort_key(spec, cohort.W, 1) != cohort_key(spec, cohort.W, 4)
    assert (cohort_key(spec, cohort.W, 4, shared_args=True)
            != cohort_key(spec, cohort.W, 4, shared_args=False))


# ------------------------------------------------------- donation


def test_donation_does_not_corrupt_oracle_replayed_member():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 3, seed=4)
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True, steps_per_dispatch=2)
    tickets = [ens.submit(gol, s, steps=8) for s in states]
    ens.run()
    cohort = next(iter(ens.cohorts.values()))
    assert cohort._donate is True
    # the pre-dispatch stacks were released as each step replaced them
    assert cohort._donate_effective is True
    for t, s0 in zip(tickets, states):
        assert tree_equal(solo(gol, s0, 8), t.result)
    assert counter_total("ensemble.verify_mismatches") == m0


def test_donation_env_gate(monkeypatch):
    from dccrg_tpu_torch.serve import donation_enabled

    monkeypatch.delenv("DCCRG_ENSEMBLE_DONATE", raising=False)
    assert donation_enabled()
    monkeypatch.setenv("DCCRG_ENSEMBLE_DONATE", "0")
    assert not donation_enabled()
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    s0 = gol_states(gol, g, 1, seed=5)[0]
    ens = Ensemble()
    t = ens.submit(gol, s0, steps=2)
    ens.run()
    cohort = next(iter(ens.cohorts.values()))
    assert cohort._donate is False and cohort._donate_effective is None
    assert t.status == "done" and tree_equal(solo(gol, s0, 2), t.result)


# ------------------------------------------------------ k selection


def _jax_gol_sched(k, budgets, seed, deadline=None):
    jg = make_grid(pkg="jax")
    jgol = JM.GameOfLife(jg, allow_dense=False)
    cells = jg.get_cells()
    rng = np.random.default_rng(seed)
    sched = JS.Scheduler(steps_per_dispatch=k)
    for b in budgets:
        sched.submit(JS.Scenario(jgol, jgol.new_state(
            alive_cells=cells[rng.random(len(cells)) < 0.3]), b, deadline=deadline))
    sched.admit()
    return sched, next(iter(sched.cohorts.values()))


def test_select_k_clamps_to_remaining_steps():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 2, seed=6)
    sched = Scheduler(steps_per_dispatch=16)
    sched.submit(Scenario(gol, states[0], 3))
    sched.submit(Scenario(gol, states[1], 5))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    jsched, jcohort = _jax_gol_sched(16, (3, 5), 6)
    assert sched.select_k(cohort) == jsched.select_k(jcohort) == 5
    while sched.step_once():
        pass
    assert all(s.steps_done == s.steps for s in sched.completed)


def test_select_k_deadline_slack_and_cap(monkeypatch):
    monkeypatch.setenv("DCCRG_COST_MODEL", "0")
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    state = gol_states(gol, g, 1, seed=7)[0]
    sched = Scheduler(steps_per_dispatch=16)
    sched.submit(Scenario(gol, state, 64, deadline=1002.0))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    jsched, jcohort = _jax_gol_sched(16, (64,), 7, deadline=1002.0)
    same = lambda now: sched.select_k(cohort, now=now) == jsched.select_k(jcohort, now=now)
    assert sched.select_k(cohort, now=1000.0) == 16 and same(1000.0)
    cohort.step_s_ema = jcohort.step_s_ema = 1.0
    assert sched.select_k(cohort, now=1000.0) == 2 and same(1000.0)
    assert sched.select_k(cohort, now=1003.0) == 1 and same(1003.0)
    monkeypatch.setenv("DCCRG_ENSEMBLE_K_MAX", "8")
    cohort.step_s_ema = jcohort.step_s_ema = None
    assert sched.select_k(cohort, now=1000.0) == 8 and same(1000.0)
    assert max_steps_per_dispatch() == 8


def test_spec_default_k_rides_env(monkeypatch):
    monkeypatch.delenv("DCCRG_ENSEMBLE_K", raising=False)
    assert default_steps_per_dispatch() == 1
    monkeypatch.setenv("DCCRG_ENSEMBLE_K", "4")
    assert default_steps_per_dispatch() == 4
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    assert gol.batch_step_spec().steps_per_dispatch == 4
    sched = Scheduler()
    sched.submit(Scenario(gol, gol_states(gol, g, 1, seed=8)[0], 8))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    assert cohort.k == 4 and sched.select_k(cohort) == 4
    monkeypatch.setenv("DCCRG_ENSEMBLE_K", "not-a-number")
    assert default_steps_per_dispatch() == 1


# --------------------------------------- shared tables + HBM gauge


def test_shared_tables_measured_lower_than_stacked_equiv():
    g = make_grid(n_dev=2)
    gol = GameOfLife(g, allow_dense=False)
    ens = Ensemble()
    for s in gol_states(gol, g, 4, seed=9):
        ens.submit(gol, s, steps=2)
    ens.admit_pending()
    cohort = next(iter(ens.cohorts.values()))
    assert cohort.shared_args
    measured = cohort.member_hbm_bytes()
    stacked = cohort.member_hbm_bytes_stacked_tables()
    assert 0 < measured < stacked
    assert obs.metrics.gauge_value("ensemble.hbm_bytes_per_member", model="gol") == measured
    ens.run()
    # the bound body's member-offset ring tables are counted once bound
    assert cohort.member_hbm_bytes(in_flight=False) > 0


def test_promotion_to_stacked_is_loss_free_and_counted():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 3, seed=10)
    v0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True)
    tickets = [ens.submit(gol, s, steps=6) for s in states]
    ens.admit_pending()
    cohort = next(iter(ens.cohorts.values()))
    ens.step()
    before_bytes = cohort.member_hbm_bytes()
    p0 = counter_total("ensemble.cohort_promotions")
    m0 = counter_total("epoch.cache_misses")
    cohort.promote_to_stacked()
    assert not cohort.shared_args
    assert counter_total("ensemble.cohort_promotions") == p0 + 1
    ens.run()
    assert counter_total("epoch.cache_misses") == m0 + 1, "one stacked body"
    assert cohort.member_hbm_bytes() > before_bytes
    for t, s0 in zip(tickets, states):
        assert tree_equal(solo(gol, s0, 6), t.result)
    assert counter_total("ensemble.verify_mismatches") == v0


def test_mismatched_tables_promote_on_admit():
    """A joiner whose tables differ by content promotes the cohort at
    admission, as in the JAX package (one promotion each), and each member
    steps to its own member program's result."""
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 2, seed=11)
    sched = Scheduler()
    a = sched.submit(Scenario(gol, states[0], 3))
    sched.admit()
    assert next(iter(sched.cohorts.values())).shared_args
    b = Scenario(gol, states[1], 3)
    sched.submit(b)
    first = sorted(b.spec.args)[0]
    x = b.spec.args[first]
    bad = ~x if x.dtype == torch.bool else x ^ 1 if not x.is_floating_point() else x + 1
    b.spec = b.spec._replace(args={**b.spec.args, first: bad})
    p0 = counter_total("ensemble.cohort_promotions")
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    assert not cohort.shared_args and cohort.occupancy == 2
    assert counter_total("ensemble.cohort_promotions") == p0 + 1
    while sched.step_once():
        pass
    assert tree_equal(solo(gol, states[0], 3), a.result)
    one = {k: v[None] for k, v in b.spec.args.items()}
    st = {k: v[None] for k, v in states[1].items()}
    dts = torch.zeros(1)
    for _ in range(3):
        st = b.spec.call(one, st, dts)
    assert tree_equal({k: v[0] for k, v in st.items()}, b.result)
    # the JAX package promotes on the same kind of joiner
    import jax

    jsched, jcohort = _jax_gol_sched(1, (3,), 11)
    jb = JS.Scenario(jcohort.members[0].model,
                     jcohort.members[0].model.new_state(), 3)
    jsched.submit(jb)
    leaves = [np.asarray(v).copy() for v in jax.tree_util.tree_leaves(jb.spec.args)]
    leaves[0] = ~leaves[0] if leaves[0].dtype == bool else leaves[0] ^ 1
    jb.spec = jb.spec._replace(args=jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jb.spec.args), leaves))
    jp0 = sum(J.obs.metrics.report()["counters"].get(
        "ensemble.cohort_promotions", {}).values())
    jsched.admit()
    assert not next(iter(jsched.cohorts.values())).shared_args
    assert sum(J.obs.metrics.report()["counters"].get(
        "ensemble.cohort_promotions", {}).values()) == jp0 + 1


# ------------------------------------------- k-aware SLO accounting


def test_request_step_span_and_steps_served_are_k_aware():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 2, seed=12)
    t0 = obs.metrics.counter_value("ensemble.steps_served", tenant="kaware")
    ens = Ensemble(steps_per_dispatch=4)
    for s in states:
        ens.submit(gol, s, steps=8, tenant="kaware")
    ens.run()
    assert obs.metrics.counter_value("ensemble.steps_served", tenant="kaware") == t0 + 16
    spans = [s for s in timeline.spans()
             if s["name"] == "request.step" and s["args"]
             and s["args"].get("steps_per_dispatch") == 4]
    assert spans
    assert spans[-1]["args"]["member_steps"] == 8
    assert spans[-1]["args"]["members"] == 2
    assert obs.metrics.gauge_value("ensemble.steps_per_dispatch", model="gol") == 4


# -------------------------------------------------- halo depth budget


def test_interior_steps_per_exchange_budget():
    from dccrg_tpu.parallel.halo import interior_steps_per_exchange as jax_budget

    for depth, radius in ((0, 1), (1, 1), (4, 1), (4, 2), (5, 2), (7, 3)):
        assert (interior_steps_per_exchange(depth, stencil_radius=radius)
                == jax_budget(depth, stencil_radius=radius))
    assert interior_steps_per_exchange(4, stencil_radius=2) == 2
    g = make_grid(n_dev=2)
    ex = g.halo(None)
    assert ex.ring_distances == tuple(ex.ring_ks)


# --------------------------------------------- telemetry ceiling gate


def test_telemetry_diff_hbm_ceiling_gate():
    """The JAX package's telemetry_diff ceiling gate reads the port's
    ``ensemble.hbm_bytes_per_member`` gauge as it reads the JAX one."""
    spec = importlib.util.spec_from_file_location(
        "telemetry_diff",
        pathlib.Path(__file__).resolve().parents[1] / "tools" / "telemetry_diff.py")
    td = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(td)
    assert "ensemble.hbm_bytes_per_member" in td.GATED_GAUGES_MAX
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    ens = Ensemble()
    for s in gol_states(gol, g, 2, seed=13):
        ens.submit(gol, s, steps=1)
    ens.run()
    gauges = obs.metrics.report()["gauges"]
    base = {"ensemble.hbm_bytes_per_member":
            {"model=gol": gauges["ensemble.hbm_bytes_per_member"]["model=gol"]}}
    bigger = {"ensemble.hbm_bytes_per_member":
              {"model=gol": 2 * base["ensemble.hbm_bytes_per_member"]["model=gol"]}}
    assert td.compare_gauges(base, base, threshold=0.35, gauges=td.GATED_GAUGES_MAX,
                             mode="max")["verdict"] == "PASS"
    assert td.compare_gauges(bigger, base, threshold=0.35, gauges=td.GATED_GAUGES_MAX,
                             mode="max")["verdict"] == "FAIL"
    with pytest.raises(ValueError, match="mode"):
        td.compare_gauges(base, base, mode="sideways")


# ------------------------------------------- the persistent kernel cache


def test_persistent_kernel_cache_is_the_build_directory(tmp_path, monkeypatch):
    """The JAX package's persistent compilation cache is the port's CUDA
    build directory: ``DCCRG_COMPILE_CACHE_DIR`` points it elsewhere, and a
    library found there (a hit) or built (a miss) is counted
    ``epoch.persistent_cache{result}``."""
    from dccrg_tpu_torch import cuda_build
    from dccrg_tpu_torch.parallel import exec_cache as ec

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("DCCRG_COMPILE_CACHE_DIR", raising=False)
    assert ec.enable_persistent_cache() is None
    assert ec.persistent_cache_dir() == str(cuda_build.BUILD_DIR)
    monkeypatch.setenv("DCCRG_COMPILE_CACHE_DIR", str(tmp_path / "kernels"))
    assert ec.enable_persistent_cache() == str(tmp_path / "kernels")
    assert ec.persistent_cache_dir() == str(tmp_path / "kernels")
    assert (tmp_path / "kernels").is_dir()
    before = ec.persistent_cache_counts()
    hit0 = obs.metrics.counter_value("epoch.persistent_cache", result="hit")
    ec.note_persistent(True)
    ec.note_persistent(False)
    after = ec.persistent_cache_counts()
    assert after == {"hits": before["hits"] + 1, "misses": before["misses"] + 1}
    assert obs.metrics.counter_value("epoch.persistent_cache", result="hit") == hit0 + 1
