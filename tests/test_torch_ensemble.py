"""Ensemble serving of the port (``dccrg_tpu_torch/serve/ensemble.py``),
the JAX package's ``tests/test_ensemble.py`` case for case on the CPU:
cohort results bitwise equal to the port's own solo steps and held
against the JAX package's cohort on the same seeded inputs (by cell id:
Game of Life exactly, float64 advection to 1e-12 relative, float32 Vlasov
to 1e-6 relative), no new body on admission and retirement at a held
signature, the occupancy mask, per-tenant telemetry, the verify oracle,
the signature keys (labels equal across packages), the width ladder and
the queue-depth elastic signal.  Counters are read as deltas."""
import tempfile

import jax
import numpy as np
import pytest
import torch

import dccrg_tpu as J
import dccrg_tpu.models as JM
import dccrg_tpu.serve as JS
from dccrg_tpu.parallel.shapes import ShapeSignature as JSig
from dccrg_tpu_torch import CartesianGeometry, Grid, obs
from dccrg_tpu_torch.models import Advection, GameOfLife, Vlasov
from dccrg_tpu_torch.parallel.shapes import ShapeSignature
from dccrg_tpu_torch.resilience import ElasticPolicy, queue_depth_signal, rescale
from dccrg_tpu_torch.serve import Ensemble, Scenario, Scheduler, cohort_width


def make_grid(n=4, n_dev=1, max_ref=0, refine_seed=None, nbh=0, pkg="torch"):
    g = (
        (Grid() if pkg == "torch" else J.Grid())
        .set_initial_length((n, n, n))
        .set_neighborhood_length(nbh)
        .set_periodic(True, True, True)
        .set_maximum_refinement_level(max_ref)
        .set_geometry(CartesianGeometry if pkg == "torch" else J.CartesianGeometry,
                      start=(0.0, 0.0, 0.0), level_0_cell_length=(1.0 / n,) * 3)
    )
    g = (g.initialize(n_devices=n_dev, device="cpu") if pkg == "torch"
         else g.initialize(mesh=J.make_mesh(n_devices=n_dev)))
    if refine_seed is not None:
        rng = np.random.default_rng(refine_seed)
        ids = np.sort(g.get_cells())
        for cid in rng.choice(ids, size=max(1, len(ids) // 6), replace=False):
            g.refine_completely(int(cid))
    g.stop_refining()
    return g


def alive_sets(g, count, seed=0):
    rng = np.random.default_rng(seed)
    cells = g.get_cells()
    return [cells[rng.random(len(cells)) < 0.3] for _ in range(count)]


def gol_states(gol, g, count, seed=0):
    return [gol.new_state(alive_cells=a) for a in alive_sets(g, count, seed)]


def tree_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def counter_total(name: str) -> int:
    return int(sum(obs.metrics.report()["counters"].get(name, {}).values()))


def solo(model, state, steps, dt=None):
    for _ in range(steps):
        state = model.step(state) if dt is None else model.step(state, dt)
    return state


# ------------------------------------------------- cohort vs solo identity


def test_gol_cohort_bit_identical_to_solo():
    """Five boards as one cohort equal the same boards stepped alone, and
    the JAX package's cohort of the same boards, cell by cell."""
    g = make_grid(n_dev=2)
    gol = GameOfLife(g, allow_dense=False)
    alive = alive_sets(g, 5)
    states = [gol.new_state(alive_cells=a) for a in alive]
    ens = Ensemble()
    tickets = [ens.submit(gol, s, steps=7, tenant=f"t{i}")
               for i, s in enumerate(states)]
    ens.run()
    jg = make_grid(n_dev=2, pkg="jax")
    jgol = JM.GameOfLife(jg, allow_dense=False)
    jens = JS.Ensemble()
    jt = [jens.submit(jgol, jgol.new_state(alive_cells=a), steps=7) for a in alive]
    jens.run()
    for ticket, s0, jticket in zip(tickets, states, jt):
        assert ticket.status == "done"
        assert tree_equal(solo(gol, s0, 7), ticket.result)
        np.testing.assert_array_equal(np.sort(gol.alive_cells(ticket.result)),
                                      np.sort(jgol.alive_cells(jticket.result)))


def test_advection_heterogeneous_grids_one_cohort_bit_identical():
    """Two different refined grids at one signature share a cohort (tables
    stacked) and each member equals its own model stepped alone; both
    equal the JAX package's cohort to 1e-12."""
    g1 = make_grid(max_ref=1, refine_seed=3)
    g2 = make_grid(max_ref=1, refine_seed=4)
    a1 = Advection(g1, dtype=np.float64, allow_dense=False)
    a2 = Advection(g2, dtype=np.float64, allow_dense=False)
    assert g1.shape_signature() == g2.shape_signature()
    s1, s2 = a1.initialize_state(), a2.initialize_state()
    dt = 0.4 * a1.max_time_step(s1)
    ens = Ensemble()
    t1 = ens.submit(a1, s1, steps=5, dt=dt, tenant="a")
    t2 = ens.submit(a2, s2, steps=5, dt=dt, tenant="b")
    ens.run()
    assert len(ens.cohorts) == 1
    assert not next(iter(ens.cohorts.values())).shared_args
    for ticket, m, s0 in ((t1, a1, s1), (t2, a2, s2)):
        assert torch.equal(solo(m, s0, 5, dt)["density"], ticket.result["density"])
    jg = make_grid(max_ref=1, refine_seed=3, pkg="jax")
    ja = JM.Advection(jg, dtype=np.float64, allow_dense=False)
    jens = JS.Ensemble()
    jt = jens.submit(ja, ja.initialize_state(), steps=5, dt=dt)
    jens.run()
    cells = g1.get_cells()
    np.testing.assert_allclose(g1.get_cell_data(t1.result, "density", cells),
                               jg.get_cell_data(jt.result, "density", cells),
                               rtol=1e-12)


def test_advection_dense_fast_path_cohort():
    """The dense path batches through the same front-end: bitwise equal
    to solo dense stepping, and to the JAX cohort to 1e-12 (float64)."""
    g = make_grid(n=8)
    adv = Advection(g)
    assert adv.dense is not None
    s0 = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(s0)
    ens = Ensemble()
    t = ens.submit(adv, s0, steps=3, dt=dt)
    ens.run()
    assert torch.equal(solo(adv, s0, 3, dt)["density"], t.result["density"])
    jg = make_grid(n=8, pkg="jax")
    ja = JM.Advection(jg)
    jens = JS.Ensemble()
    jt = jens.submit(ja, ja.initialize_state(), steps=3, dt=dt)
    jens.run()
    cells = g.get_cells()
    np.testing.assert_allclose(adv.get_cell_data(t.result, "density", cells),
                               ja.get_cell_data(jt.result, "density", cells),
                               rtol=1e-12)


def test_vlasov_general_cohort_within_envelope():
    """The general (gather) Vlasov cohort: bitwise equal to solo, and to
    the JAX cohort within 1e-6 relative (float32)."""
    g = make_grid(max_ref=1, refine_seed=1)
    vl = Vlasov(g, nv=2, dtype=np.float32)
    assert vl.info is None
    s0 = vl.initialize_state()
    dt = float(np.float32(0.5 * vl.max_time_step()))
    ens = Ensemble()
    t = ens.submit(vl, s0, steps=4, dt=dt)
    ens.run()
    assert torch.equal(solo(vl, s0, 4, dt)["f"], t.result["f"])
    jg = make_grid(max_ref=1, refine_seed=1, pkg="jax")
    jv = JM.Vlasov(jg, nv=2, dtype=np.float32)
    jens = JS.Ensemble()
    jt = jens.submit(jv, jv.initialize_state(), steps=4, dt=np.float32(dt))
    jens.run()
    cells = g.get_cells()
    np.testing.assert_allclose(g.get_cell_data(t.result, "f", cells),
                               np.asarray(jg.get_cell_data(jt.result, "f", cells)),
                               rtol=1e-6, atol=1e-9)


def test_sixty_four_scenarios_one_cohort_one_executable():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 64, seed=5)
    ens = Ensemble()
    tickets = [ens.submit(gol, s, steps=3) for s in states]
    ens.admit_pending()
    cohorts = list(ens.cohorts.values())
    assert len(cohorts) == 1 and cohorts[0].W == 64 and cohorts[0].occupancy == 64
    m0 = counter_total("epoch.cache_misses")
    ens.run()
    assert counter_total("epoch.cache_misses") == m0 + 1, "one body for the burst"
    assert len(ens.completed) == 64
    for i in (0, 17, 63):
        assert tree_equal(solo(gol, states[i], 3), tickets[i].result)


# ---------------------------------------------- no new body on churn


def test_admit_retire_at_held_signature_zero_recompiles():
    """Occupancy churn at a held (signature, width) reuses the cached
    body: no cache miss, no kernel build."""
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 13, seed=2)
    ens = Ensemble()
    for s in states[:4]:
        ens.submit(gol, s, steps=2)
    ens.run()
    r0, m0 = counter_total("epoch.recompiles"), counter_total("epoch.cache_misses")
    for wave in (states[4:8], states[8:10], states[10:13]):
        for i, s in enumerate(wave):
            ens.submit(gol, s, steps=2 + i)
        ens.run()
    assert counter_total("epoch.recompiles") == r0
    assert counter_total("epoch.cache_misses") == m0
    assert len(ens.completed) == 13
    assert next(iter(ens.cohorts.values())).W == 4


def test_cohort_width_growth_is_loss_free():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 3, seed=9)
    sched = Scheduler()
    a = sched.submit(Scenario(gol, states[0], 6))
    sched.admit()
    sched.step_once()
    sched.step_once()
    m0 = counter_total("epoch.cache_misses")
    for s in states[1:]:
        sched.submit(Scenario(gol, s, 4))
    sched.admit()
    cohort = next(iter(sched.cohorts.values()))
    assert cohort.W >= 3 and a.steps_done == 2
    while sched.step_once():
        pass
    assert counter_total("epoch.cache_misses") == m0 + 1, "one wider body"
    assert tree_equal(solo(gol, states[0], 6), a.result)


# ------------------------------------------------- occupancy masking


def test_partial_cohort_mask_freezes_inactive_and_finished_slots():
    """A width-4 cohort with two members: the pad slots never move, the
    short member freezes at its budget while the long one runs on."""
    from dccrg_tpu_torch.serve import Cohort

    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 2, seed=4)
    short, long = _spec(gol, states[0], 2), _spec(gol, states[1], 5)
    cohort = Cohort(short, width=4)
    cohort.admit(short, 0)
    cohort.admit(long, 1)
    assert cohort.W == 4 and cohort.occupancy == 2
    pad_slots = cohort.free_slots()
    pads_before = [cohort.member_state(s) for s in pad_slots]
    for _ in range(5):
        cohort.step()
    for slot, before in zip(pad_slots, pads_before):
        assert tree_equal(before, cohort.member_state(slot))
    assert tree_equal(solo(gol, states[0], 2), cohort.member_state(0))
    assert tree_equal(solo(gol, states[1], 5), cohort.member_state(1))
    assert short.steps_done == 2 and long.steps_done == 5


def _spec(model, state, steps):
    scn = Scenario(model, state, steps)
    scn.spec = model.batch_step_spec()
    scn.signature = model.grid.shape_signature()
    return scn


# -------------------------------------------------- telemetry accounting


def test_per_tenant_counters_and_lifecycle_telemetry():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 4, seed=6)
    adm0 = counter_total("ensemble.admitted")
    ret0 = counter_total("ensemble.retired")
    alice0 = obs.metrics.counter_value("ensemble.steps_served", tenant="alice")
    bob0 = obs.metrics.counter_value("ensemble.steps_served", tenant="bob")
    ens = Ensemble()
    for i, s in enumerate(states):
        ens.submit(gol, s, steps=3 if i % 2 == 0 else 5,
                   tenant="alice" if i % 2 == 0 else "bob")
    ens.run()
    assert counter_total("ensemble.admitted") == adm0 + 4
    assert counter_total("ensemble.retired") == ret0 + 4
    assert obs.metrics.counter_value("ensemble.steps_served", tenant="alice") == alice0 + 6
    assert obs.metrics.counter_value("ensemble.steps_served", tenant="bob") == bob0 + 10
    rep = obs.metrics.report()
    assert "ensemble.step" in rep["phases"] and "ensemble.admit" in rep["phases"]
    assert rep["histograms"]["ensemble.queue_latency"][""]["count"] > 0
    occ = rep["gauges"].get("ensemble.cohort_peak_occupancy", {})
    assert any(v == 1.0 for v in occ.values())


def test_rejections_counted_never_raised():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    state = gol_states(gol, g, 1)[0]

    class NoSpec:
        pass

    ens = Ensemble(max_cohorts=1)
    r_unsup = ens.submit(NoSpec(), state, steps=3)
    assert (r_unsup.status, r_unsup.reject_reason) == ("rejected", "unsupported")
    r_invalid = ens.submit(gol, state, steps=0)
    assert (r_invalid.status, r_invalid.reject_reason) == ("rejected", "invalid")
    ens.submit(gol, state, steps=2)
    g2 = make_grid(n=5)
    gol2 = GameOfLife(g2, allow_dense=False)
    r_cap = ens.submit(gol2, gol_states(gol2, g2, 1)[0], steps=2)
    ens.run()
    assert (r_cap.status, r_cap.reject_reason) == ("rejected", "capacity")
    series = obs.metrics.report()["counters"]["ensemble.rejected"]
    for reason in ("unsupported", "invalid", "capacity"):
        assert series.get(f"reason={reason}", 0) > 0


def test_scheduler_width_cap_backlog_and_waves():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 5, seed=8)
    ens = Ensemble(max_width=2)
    tickets = [ens.submit(gol, s, steps=2) for s in states]
    ens.admit_pending()
    assert ens.queue_depth() == 3
    assert obs.metrics.gauge_value("ensemble.queue_depth") == 3
    ens.run()
    assert ens.queue_depth() == 0
    for t, s0 in zip(tickets, states):
        assert t.status == "done" and tree_equal(solo(gol, s0, 2), t.result)


def test_deadline_policy_orders_cohorts():
    g1, g2 = make_grid(n=4), make_grid(n=5)
    gol1, gol2 = GameOfLife(g1, allow_dense=False), GameOfLife(g2, allow_dense=False)
    sched = Scheduler(policy="deadline")
    late = sched.submit(Scenario(gol1, gol_states(gol1, g1, 1)[0], 3, deadline=100.0))
    soon = sched.submit(Scenario(gol2, gol_states(gol2, g2, 1)[0], 3, deadline=1.0))
    sched.admit()
    order = [c.min_deadline() for c in sched._ordered_cohorts()]
    assert order == sorted(order) and order[0] == 1.0
    with pytest.raises(ValueError, match="policy"):
        Scheduler(policy="fifo")
    assert late.status == "active" and soon.status == "active"


# ----------------------------------------------------- verify oracle


def test_verify_oracle_counts_checks_no_mismatches():
    g = make_grid(n_dev=2)
    gol = GameOfLife(g, allow_dense=False)
    c0 = counter_total("ensemble.verify_checks")
    m0 = counter_total("ensemble.verify_mismatches")
    ens = Ensemble(verify=True)
    for s in gol_states(gol, g, 3, seed=11):
        ens.submit(gol, s, steps=3)
    ens.run()
    assert counter_total("ensemble.verify_checks") > c0
    assert counter_total("ensemble.verify_mismatches") == m0
    assert "ensemble.verify" in obs.metrics.phase_names()


def test_verify_oracle_detects_tampering():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    ens = Ensemble(verify=True)
    ens.submit(gol, gol_states(gol, g, 1, seed=12)[0], steps=2)
    ens.admit_pending()
    cohort = next(iter(ens.cohorts.values()))
    kernel = cohort._kernel_for(1)

    def tampered(bound, state, remaining, dts, mask, live_of):
        out = kernel(bound, state, remaining, dts, mask, live_of)
        return {**out, "is_alive": out["is_alive"] ^ 1}

    cohort._kernels[(1, 0)] = tampered
    m0 = obs.metrics.counter_value("ensemble.verify_mismatches", field="is_alive")
    cohort.step()
    assert obs.metrics.counter_value("ensemble.verify_mismatches",
                                     field="is_alive") == m0 + 1


def test_verify_env_gating(monkeypatch):
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    monkeypatch.delenv("DCCRG_ENSEMBLE_VERIFY", raising=False)
    c0 = counter_total("ensemble.verify_checks")
    ens = Ensemble()
    ens.submit(gol, gol_states(gol, g, 1)[0], steps=2)
    ens.run()
    assert counter_total("ensemble.verify_checks") == c0
    monkeypatch.setenv("DCCRG_ENSEMBLE_VERIFY", "1")
    ens2 = Ensemble()
    ens2.submit(gol, gol_states(gol, g, 1, seed=13)[0], steps=2)
    ens2.run()
    assert counter_total("ensemble.verify_checks") > c0


# ------------------------------------------- ShapeSignature cohort keys


def test_shape_signature_hashable_frozen_value_equality():
    a = ShapeSignature(2, 64, ((-1, 8),), False, ((-1, "", 1, 16),))
    b = ShapeSignature(2, 64, ((-1, 8),), False, ((-1, "", 1, 16),))
    c = ShapeSignature(2, 64, ((-1, 8),), False, ((-1, "", 1, 32),))
    assert a == b and hash(a) == hash(b) and a != c
    with pytest.raises(AttributeError):
        a.n_devices = 4
    d = {a: "x"}
    d[b] = "y"
    d[c] = "z"
    assert len(d) == 2 and d[a] == "y"


def test_shape_signature_label_stable_and_discriminating():
    """The port's labels are the JAX package's (the gateway routes on
    them across processes of either package)."""
    fields = (2, 64, ((-1, 8),), False, ((-1, "", 1, 16),))
    a, b = ShapeSignature(*fields), ShapeSignature(*fields)
    c = ShapeSignature(2, 64, ((-1, 8),), False, ((-1, "", 1, 32),))
    assert a.label() == b.label() != c.label()
    assert a.label() == JSig(*fields).label()
    assert a.label().startswith("d2.R64.gather.")


def test_live_grid_signatures_key_cohorts():
    g1 = make_grid(max_ref=1, refine_seed=3)
    g2 = make_grid(max_ref=1, refine_seed=3)
    s1, s2 = g1.shape_signature(), g2.shape_signature()
    assert s1 == s2 and hash(s1) == hash(s2)
    assert {s1: 1, s2: 2} == {s1: 2}
    jg = make_grid(max_ref=1, refine_seed=3, pkg="jax")
    assert s1.label() == jg.shape_signature().label()


# ------------------------------------------------------- width ladder


def test_cohort_width_ladder_and_hysteresis():
    """The ladder of the JAX package, value for value."""
    for n in (1, 2, 3, 5, 9, 64, 65):
        assert cohort_width(n) == JS.cohort_width(n)
    for n, prev in ((9, 16), (8, 16), (5, 16), (3, 16), (9, 4), (4, 4)):
        assert cohort_width(n, prev) == JS.cohort_width(n, prev)
    assert [cohort_width(n) for n in (1, 2, 3, 5, 9, 64, 65)] == [1, 2, 4, 8, 16, 64, 128]
    assert cohort_width(9, 16) == 16 and cohort_width(5, 16) == 8


# ------------------------------------------- queue-depth elastic signal


def test_queue_depth_signal_sources():
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    ens = Ensemble(max_width=1)
    for s in gol_states(gol, g, 3, seed=14):
        ens.submit(gol, s, steps=1)
    ens.admit_pending()
    assert ens.queue_depth() == 2
    assert queue_depth_signal(ens, target_depth=4) == 0.5
    assert queue_depth_signal(ens.scheduler, target_depth=2) == 1.0
    assert queue_depth_signal(lambda: 6, target_depth=4) == 1.5
    assert queue_depth_signal(None, target_depth=2, registry=obs.metrics) == 1.0
    assert queue_depth_signal(ens, target_depth=0) is None
    ens.run()


def test_queue_depth_env_target(monkeypatch):
    monkeypatch.setenv("DCCRG_ELASTIC_QUEUE_TARGET", "4")
    assert queue_depth_signal(8) == 2.0
    monkeypatch.setenv("DCCRG_ELASTIC_QUEUE_TARGET", "0")
    assert queue_depth_signal(8) is None


def test_policy_on_oscillating_queue_depth_never_flaps():
    p = ElasticPolicy(4, high=0.8, low=0.3, patience=2, cooldown_s=0.0, max_devices=8)
    decisions = [p.observe(queue_depth_signal(d, target_depth=8), now=float(i))
                 for i, d in enumerate([16, 0] * 10)]
    assert decisions == [None] * 20
    for i in range(2):
        last = p.observe(queue_depth_signal(16, target_depth=8), now=100.0 + i)
    assert last == 8


def test_queue_depth_driven_rescale_end_to_end():
    """Backlog -> policy decision -> rescale across slot counts, the
    payload intact."""
    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 4, seed=15)
    ens = Ensemble(max_width=1)
    for s in states:
        ens.submit(gol, s, steps=1)
    ens.admit_pending()
    assert ens.queue_depth() == 3
    policy = ElasticPolicy(1, high=0.8, low=0.3, patience=2, cooldown_s=0.0,
                           max_devices=2)
    target = None
    for tick in range(3):
        target = policy.observe(queue_depth_signal(ens, target_depth=2), now=float(tick))
        if target is not None:
            break
    assert target == 2
    spec = {"is_alive": ((), np.uint32)}
    state = {"is_alive": states[0]["is_alive"]}
    ids = g.get_cells()
    want = np.asarray(g.get_cell_data(state, "is_alive", ids))
    with tempfile.TemporaryDirectory() as td:
        r = rescale(g, state, spec, target, directory=td)
        policy.committed(r.n_devices_after)
    assert r.n_devices_after == 2 and policy.n_devices == 2
    np.testing.assert_array_equal(np.asarray(r.grid.get_cell_data(r.state, "is_alive", ids)),
                                  want)
    ens.run()
    assert ens.queue_depth() == 0


def test_device_seconds_attribution_and_step_boundary_flush(monkeypatch):
    import json as _json
    import os as _os

    g = make_grid()
    gol = GameOfLife(g, allow_dense=False)
    states = gol_states(gol, g, 4, seed=7)

    def tenant_device_s():
        out = {}
        for label, v in obs.metrics.report()["counters"].get("ensemble.device_s", {}).items():
            kv = dict(p.split("=", 1) for p in label.split(",") if "=" in p)
            assert kv.get("model"), label
            out[kv["tenant"]] = out.get(kv["tenant"], 0.0) + v
        return out

    before = tenant_device_s()
    with tempfile.TemporaryDirectory() as td:
        path = _os.path.join(td, "ens.stream.jsonl")
        monkeypatch.setenv("DCCRG_STREAM_FLUSH_S", "0.0001")
        s = obs.TelemetryStream(path, period=3600.0)
        s.start()
        try:
            ens = Ensemble()
            for i, st in enumerate(states):
                ens.submit(gol, st, steps=4, tenant="alice" if i % 2 == 0 else "bob")
            ens.run()
        finally:
            s.stop(final=False)
        lines = [ln for ln in open(path) if ln.strip()]
        assert len(lines) >= 1
        assert all("histograms" in _json.loads(ln) for ln in lines)
    after = tenant_device_s()
    for tenant in ("alice", "bob"):
        assert after.get(tenant, 0.0) > before.get(tenant, 0.0)
    d_alice = after["alice"] - before.get("alice", 0.0)
    d_bob = after["bob"] - before.get("bob", 0.0)
    assert d_alice == pytest.approx(d_bob, rel=0.6)
