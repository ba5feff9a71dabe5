"""The port's elastic rescale, policy, signals, heartbeat watchdog,
escalation ladder and supervisor (``dccrg_tpu_torch.resilience``, on the
CPU) against the JAX package's (tests/test_elastic.py mirrored): rescaled
runs equal the JAX package's elastic runs, and the same call sequences
give the same decisions and the same registry deltas in both packages.

The one behaviour that differs by design: a slot is not a device here, so
``available_devices`` counts physical devices (1 on the CPU) and
``rescale`` refuses a target *device* that is not visible, never a slot
count.

Tolerances: Game of Life exact; advection rescaled 1 -> 8 -> 2 in f64
within 1e-11 relative of the JAX package's elastic run
(test_elastic.py's own cross-layout tolerance); everything else exact.
"""
import tempfile
import time

import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu.obs as jobs
import dccrg_tpu.resilience as jres
import dccrg_tpu_torch
import dccrg_tpu_torch.obs as tobs
import dccrg_tpu_torch.resilience as tres
from dccrg_tpu.models import Advection as JAdvection
from dccrg_tpu.models import GameOfLife as JGameOfLife
from dccrg_tpu_torch.models import Advection, GameOfLife
from dccrg_tpu_torch.resilience import (
    CheckpointLineage,
    DeviceLostError,
    available_devices,
    inject,
    plane,
    rescale,
)

#: (resilience, obs) of each package
PKGS = {"jax": (jres, jobs), "port": (tres, tobs)}


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    plane.disarm()
    jres.plane.disarm()


def _mesh_kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def make_adv_grid(n_dev, n=4, seed=0, pkg=dccrg_tpu_torch):
    g = (pkg.Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(**_mesh_kw(pkg, n_dev)))
    rng = np.random.default_rng(seed)
    ids = np.sort(g.get_cells())
    for cid in rng.choice(ids, size=max(1, len(ids) // 5), replace=False):
        g.refine_completely(int(cid))
    g.stop_refining()
    return g, rng


ADV_SPEC = {k: ((), np.float64) for k in ("density", "vx", "vy", "vz")}


def land_advection(g, spec_state, Model):
    """Model + full state from a (grid, spec-field state) pair — the soak
    child's landing path."""
    ids = np.sort(g.get_cells())
    adv = Model(g)
    s = adv.initialize_state()
    for f in ADV_SPEC:
        s = adv.set_cell_data(s, f, ids, g.get_cell_data(spec_state, f, ids))
    return adv, g.update_copies_of_remote_neighbors(s)


# ------------------------------------------------------- rescale mechanism


def _gol_rescaled(pkg, Model, res, elastic):
    g = (pkg.Grid().set_initial_length((8, 8, 1)).set_neighborhood_length(1)
         .set_periodic(True, True, False).initialize(**_mesh_kw(pkg, 1)))
    cells = g.get_cells()
    gol = Model(g)
    s = gol.new_state(alive_cells=cells[np.random.default_rng(42).random(len(cells)) < 0.4])
    with tempfile.TemporaryDirectory() as td:
        for step in range(9):
            if elastic and step in (3, 6):
                target = 8 if step == 3 else 1
                kw = {} if pkg is dccrg_tpu else {"device": "cpu"}
                r = res.rescale(g, s, Model.SPEC, target, directory=td,
                                user_header=b"t", **kw)
                assert r.n_devices_after == target
                g, s = r.grid, r.state
                gol = Model(g)
            s = gol.run(s, 1)
    return set(gol.alive_cells(s).tolist())


def test_rescale_gol_bit_identity_1_to_8():
    """Game of Life stepped across rescales 1 -> 8 -> 1 finishes exactly
    equal to the fixed-slot run and to the JAX package's elastic run of
    test_rescale_gol_bit_identity_1_to_8."""
    port = _gol_rescaled(dccrg_tpu_torch, GameOfLife, tres, True)
    assert port == _gol_rescaled(dccrg_tpu_torch, GameOfLife, tres, False)
    assert port == _gol_rescaled(dccrg_tpu, JGameOfLife, jres, True)


def _adv_rescaled(pkg, Model, res, elastic):
    g, rng = make_adv_grid(1, pkg=pkg)
    ids = np.sort(g.get_cells())
    adv = Model(g)
    s = adv.initialize_state()
    s = adv.set_cell_data(s, "density", ids, rng.uniform(1, 2, len(ids)))
    for f in ("vx", "vy", "vz"):
        s = adv.set_cell_data(s, f, ids, rng.uniform(-0.2, 0.2, len(ids)))
    s = g.update_copies_of_remote_neighbors(s)
    dt = 0.3 * adv.max_time_step(s)
    with tempfile.TemporaryDirectory() as td:
        for step in range(6):
            if elastic and step in (2, 4):
                r = res.rescale(g, s, ADV_SPEC, 8 if step == 2 else 2,
                                directory=td, user_header=b"t")
                g = r.grid
                adv, s = land_advection(g, r.state, Model)
            s = adv.step(s, dt)
    return np.asarray(g.get_cell_data(s, "density", ids), np.float64)


def test_rescale_advection_converges_across_counts():
    """Advection stepped across 1 -> 8 -> 2 rescales stays within 1e-11 of
    the fixed-slot run and of the JAX package's elastic run."""
    port = _adv_rescaled(dccrg_tpu_torch, Advection, tres, True)
    np.testing.assert_allclose(port, _adv_rescaled(dccrg_tpu_torch, Advection, tres, False),
                               rtol=1e-11, atol=0)
    np.testing.assert_allclose(port, _adv_rescaled(dccrg_tpu, JAdvection, jres, True),
                               rtol=1e-11, atol=0)


def test_rescale_counters_phase_and_result():
    g, rng = make_adv_grid(2)
    spec = {"q": ((), np.float64)}
    ids = g.get_cells()
    s = g.set_cell_data(g.new_state(spec), "q", ids, rng.uniform(0, 1, len(ids)))
    up0 = tobs.metrics.counter_value("elastic.rescales", direction="up")
    down0 = tobs.metrics.counter_value("elastic.rescales", direction="down")
    with tempfile.TemporaryDirectory() as td:
        r = rescale(g, s, spec, 4, directory=td)
        assert (r.direction, r.n_devices_before, r.n_devices_after) == ("up", 2, 4)
        assert r.commit_s > 0 and r.reland_s > 0
        assert r.grid.device.type == "cpu"      # the grid's own device
        r2 = rescale(r.grid, r.state, spec, 1, directory=td)
        assert r2.direction == "down" and r2.n_devices_after == 1
        np.testing.assert_array_equal(r2.grid.get_cell_data(r2.state, "q", ids),
                                      g.get_cell_data(s, "q", ids))
    assert tobs.metrics.counter_value("elastic.rescales", direction="up") == up0 + 1
    assert tobs.metrics.counter_value("elastic.rescales", direction="down") == down0 + 1
    assert tobs.metrics.gauge_value("elastic.n_devices") == 1
    assert "elastic.rescale" in tobs.metrics.phase_names()


def test_rescale_rejects_bad_targets():
    """No lineage, no slots, or a device that is not visible: refused.  A
    slot count above the physical device count is a rescale like any other
    (slots are not devices)."""
    g, rng = make_adv_grid(1)
    spec = {"q": ((), np.float64)}
    s = g.new_state(spec)
    with tempfile.TemporaryDirectory() as td:
        with pytest.raises(ValueError, match="lineage"):
            rescale(g, s, spec, 2)
        with pytest.raises(ValueError, match="devices"):
            rescale(g, s, spec, 0, directory=td)
        gone = f"cuda:{torch.cuda.device_count()}"
        with pytest.raises(DeviceLostError, match="visible"):
            rescale(g, s, spec, 2, directory=td, device=gone)
        r = rescale(g, s, spec, available_devices() + 7, directory=td)
        assert r.n_devices_after == available_devices() + 7


def test_rescale_asked_for_cuda_never_lands_on_the_cpu():
    """A CPU grid rescaled onto CUDA where there is none raises a lost
    device; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, _ = make_adv_grid(1)
    spec = {"q": ((), np.float64)}
    with tempfile.TemporaryDirectory() as td:
        with pytest.raises(DeviceLostError, match="visible"):
            rescale(g, g.new_state(spec), spec, 2, directory=td, device="cuda")
        assert CheckpointLineage(td).generations() == []   # nothing committed


def test_rescaled_grids_share_signature():
    """Two re-landings of the same generation at the same count build
    equal shape signatures, ring hints included."""
    g, rng = make_adv_grid(2)
    spec = {"q": ((), np.float64)}
    s = g.new_state(spec)
    with tempfile.TemporaryDirectory() as td:
        lineage = CheckpointLineage(td, keep=2)
        lineage.commit(g, s, spec)
        grids = []
        for _ in range(2):
            g2, s2, _h, _gen = lineage.latest_valid(spec, n_devices=4, device="cpu")
            g2.update_copies_of_remote_neighbors(s2)      # builds the halo
            grids.append(g2)
    sig_a, sig_b = (gr.shape_signature() for gr in grids)
    assert sig_a == sig_b
    assert sig_a.rings, "ring hints missing from the grid signature"


def test_ring_signature_matches_jax():
    from dccrg_tpu.parallel.shapes import ring_signature as jring
    from dccrg_tpu_torch.parallel.shapes import ring_signature

    hints = {(None, None, 1): 44, (2, "density", 3): 16, (None, None, 2): 8}
    for h in ({}, None, hints):
        assert ring_signature(h) == jring(h)
    assert ring_signature(hints) == (
        (-1, "", 1, 44), (-1, "", 2, 8), (2, "density", 3, 16))


def test_grid_signature_surfaces_ring_hints():
    g, _rng = make_adv_grid(2)
    s = g.new_state({"q": ((), np.float64)})
    sig0 = g.shape_signature()
    g.update_copies_of_remote_neighbors(s)
    sig1 = g.shape_signature()
    assert sig1.rings and sig1._replace(rings=()) == sig0._replace(rings=())
    g.update_copies_of_remote_neighbors(s)
    assert g.shape_signature() == sig1


# ---------------------------------------------------------------- policy


def _counter_deltas(o, before, prefixes):
    after = o.metrics.report()["counters"]
    return {f"{n}{{{lab}}}": v - before.get(n, {}).get(lab, 0)
            for n, series in after.items() if n.startswith(prefixes)
            for lab, v in series.items() if v != before.get(n, {}).get(lab, 0)}


def _both(seq, prefixes=("elastic.", "supervisor.", "resilience.")):
    """Run ``seq(resilience, obs)`` in each package; returns ``{pkg:
    (result, counter deltas)}`` after asserting they are equal."""
    out = {}
    for name, (res, o) in PKGS.items():
        before = o.metrics.report()["counters"]
        got = seq(res, o)
        out[name] = (got, _counter_deltas(o, before, prefixes))
    assert out["port"] == out["jax"]
    return out["port"]


POLICY_CASES = {
    "oscillating": (dict(n=4, high=0.8, low=0.3, patience=2, cooldown_s=0.0, max_devices=8),
                    [(load, float(i), None) for i, load in enumerate([0.95, 0.05] * 10)]),
    "grow_clamp": (dict(n=4, high=0.8, low=0.3, patience=3, cooldown_s=0.0, max_devices=8),
                   [(0.9, 0.0, None), (0.9, 1.0, None), (0.9, 2.0, 8)]
                   + [(0.99, 3.0 + i, None) for i in range(5)]),
    "shrink_floor": (dict(n=4, min_devices=2, high=0.8, low=0.3, patience=2,
                          cooldown_s=0.0, max_devices=8),
                     [(0.1, 0.0, None), (0.1, 1.0, 2), (0.1, 2.0, None), (0.1, 3.0, None)]),
    "cooldown": (dict(n=2, high=0.8, low=0.3, patience=1, cooldown_s=10.0, max_devices=8),
                 [(0.9, 0.0, 4), (0.9, 5.0, None), (0.9, 10.5, 8)]),
    "hysteresis": (dict(n=4, high=0.8, low=0.3, patience=2, cooldown_s=0.0),
                   [(0.9, 0.0, None), (0.5, 1.0, None), (0.9, 2.0, None)]),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_jax(case):
    """The policy cases of test_elastic.py: each load sequence gives the
    expected decisions (committing each one), and the same decisions and
    ``elastic.policy_decisions`` deltas as the JAX package's policy."""
    kw, seq = POLICY_CASES[case]

    def run(res, o):
        kw2 = dict(kw)
        p = res.ElasticPolicy(kw2.pop("n"), **kw2)
        got = []
        for load, now, _want in seq:
            d = p.observe(load, now=now)
            got.append(d)
            if d is not None:
                p.committed(d, now=now)
        return got

    got, _deltas = _both(run)
    assert got == [want for _l, _n, want in seq]


def test_policy_env_knobs(monkeypatch):
    monkeypatch.setenv("DCCRG_ELASTIC_HIGH", "0.6")
    monkeypatch.setenv("DCCRG_ELASTIC_LOW", "0.2")
    monkeypatch.setenv("DCCRG_ELASTIC_PATIENCE", "1")
    monkeypatch.setenv("DCCRG_ELASTIC_COOLDOWN", "0")
    p = tres.ElasticPolicy(2, max_devices=8)
    assert (p.high, p.low, p.patience, p.cooldown_s) == (0.6, 0.2, 1, 0.0)
    assert p.observe(0.7, now=0.0) == 4
    with pytest.raises(ValueError, match="low < high"):
        tres.ElasticPolicy(2, high=0.3, low=0.5)


def test_policy_without_max_never_outgrows_the_devices():
    """Without ``max_devices`` growth is bounded by the physical devices
    (1 on the CPU): sustained high load holds the count."""
    p = tres.ElasticPolicy(max(available_devices(), 1), high=0.8, low=0.3,
                           patience=1, cooldown_s=0.0)
    assert [p.observe(0.99, now=float(i)) for i in range(3)] == [None] * 3


def test_signals_from_registry():
    def run(res, o):
        reg = o.MetricsRegistry(enabled=True)
        out = [res.utilization_signal(reg)]
        reg.gauge("hbm.bytes_in_use", 750, device=0)
        reg.gauge("hbm.bytes_limit", 1000, device=0)
        reg.gauge("hbm.bytes_in_use", 100, device=1)
        reg.gauge("hbm.bytes_limit", 1000, device=1)
        out.append(res.utilization_signal(reg))
        out.append(res.step_latency_signal(0.5, registry=reg))
        reg.phase_add("halo.exchange", 1.0)
        out.append(res.step_latency_signal(0.5, registry=reg))
        return out

    got, _ = _both(run)
    assert got[0] is None and got[1] == pytest.approx(0.75)
    assert got[2] is None and got[3] == pytest.approx(2.0)


def test_queue_depth_signal_sources(monkeypatch):
    """Every depth source (the ``ensemble.queue_depth`` gauge, an object
    with ``queue_depth()``, a callable, a number) reads alike in both
    packages; the target comes from ``DCCRG_ELASTIC_QUEUE_TARGET``."""
    class Sched:
        def queue_depth(self):
            return 12

    def run(res, o):
        reg = o.MetricsRegistry(enabled=True)
        out = [res.queue_depth_signal(None, registry=reg)]
        reg.gauge("ensemble.queue_depth", 6)
        out += [res.queue_depth_signal(None, registry=reg),
                res.queue_depth_signal(Sched(), target_depth=4),
                res.queue_depth_signal(lambda: 3, target_depth=6),
                res.queue_depth_signal(2.0, target_depth=8),
                res.queue_depth_signal(5, target_depth=0)]
        return out

    monkeypatch.setenv("DCCRG_ELASTIC_QUEUE_TARGET", "4")
    got, _ = _both(run)
    assert got == [None, 1.5, 3.0, 0.5, 0.25, None]


# -------------------------------------------------------------- watchdog


def _stream(o, path, registry=None):
    return o.TelemetryStream(path, period=3600.0, registry=registry, truncate=True)


def test_heartbeat_monitor_detects_silence(tmp_path):
    def run(res, o):
        hb = str(tmp_path / f"{o.__name__}.jsonl")
        mon = res.HeartbeatMonitor(hb, stall_after_s=5.0, now=0.0)
        out = [mon.poll(now=1.0), mon.poll(now=6.0)]
        _stream(o, hb).write_snapshot(step=0)
        mon = res.HeartbeatMonitor(hb, stall_after_s=5.0, now=0.0)
        return out + [mon.poll(now=t) for t in (1.0, 4.0, 7.0)]

    got, _ = _both(run)
    assert got == [("waiting", None), ("stalled", "no-heartbeat"), ("ok", None),
                   ("ok", None), ("stalled", "no-heartbeat")]


def test_heartbeat_monitor_detects_frozen_progress(tmp_path):
    """Lines keep arriving but the step marker and counters are frozen —
    the ``step.hang`` shape — then progress resumes."""
    def run(res, o):
        reg = o.MetricsRegistry(enabled=True)
        hb = str(tmp_path / f"{o.__name__}.jsonl")
        s = _stream(o, hb, registry=reg)
        reg.inc("work.done")
        s.write_snapshot(step=0)
        mon = res.HeartbeatMonitor(hb, stall_after_s=3.0, now=0.0)
        out = [mon.poll(now=0.5)]
        reg.inc("work.done")
        s.write_snapshot(step=1)
        out.append(mon.poll(now=2.0))
        for now in (4.0, 6.0):
            s.write_snapshot(step=1)
            out.append(mon.poll(now=now))
        reg.inc("work.done")
        s.write_snapshot(step=2)
        return out + [mon.poll(now=7.0)]

    got, _ = _both(run)
    assert got == [("ok", None), ("ok", None), ("ok", None),
                   ("stalled", "no-progress"), ("ok", None)]


def test_heartbeat_monitor_tolerates_torn_tail(tmp_path):
    hb = tmp_path / "hb.jsonl"
    _stream(tobs, str(hb)).write_snapshot(step=0)
    with open(hb, "a") as f:
        f.write('{"seq": 1, "truncated')       # killed mid-write
    mon = tres.HeartbeatMonitor(str(hb), stall_after_s=5.0, now=0.0)
    assert mon.poll(now=1.0) == ("ok", None) and mon.beats == 1


def test_escalation_ladder_order_counters_and_reset():
    def run(res, o):
        lad = res.EscalationLadder()
        out = [lad.escalate("unit") for _ in range(4)]
        lad.reset()
        out.append(lad.escalate("unit"))
        lad2 = res.EscalationLadder(patience=2)
        out += [lad2.escalate("x") for _ in range(4)]
        out.append(res.EscalationLadder().escalate("child-dead", minimum="rescale_down"))
        return out

    got, deltas = _both(run)
    assert got == ["warn", "rescale_down", "restart", "restart", "warn",
                   "warn", "warn", "rescale_down", "rescale_down", "rescale_down"]
    assert deltas["supervisor.warnings{reason=unit}"] == 2
    assert deltas["elastic.degraded{}"] == 4
    assert deltas["supervisor.escalations{action=restart}"] == 2


def test_supervisor_escalates_and_recovers(tmp_path):
    def run(res, o):
        hb = str(tmp_path / f"{o.__name__}.jsonl")
        s = _stream(o, hb)
        s.write_snapshot(step=0)
        sup = res.Supervisor(res.HeartbeatMonitor(hb, stall_after_s=2.0, now=0.0))
        out = [sup.poll(now=0.5)]
        out += [sup.poll(now=10.0 + i) for i in range(3)]
        s.write_snapshot(step=1)
        return out + [sup.poll(now=13.5), sup.poll(now=20.0)]

    got, _ = _both(run)
    assert [g["action"] for g in got] == [None, "warn", "rescale_down", "restart",
                                          None, "warn"]
    assert "supervisor.poll" in tobs.metrics.phase_names()


def test_supervisor_dead_child_goes_degraded(tmp_path):
    def run(res, o):
        hb = str(tmp_path / f"{o.__name__}.jsonl")
        _stream(o, hb).write_snapshot(step=0)
        sup = res.Supervisor(res.HeartbeatMonitor(hb, stall_after_s=30.0, now=0.0),
                             child_alive=lambda: False)
        return [sup.poll(now=1.0), sup.poll(now=2.0)]

    got, _ = _both(run)
    assert (got[0]["status"], got[0]["action"], got[1]["action"]) == \
        ("dead", "rescale_down", "restart")


def test_supervisor_alert_source_keeps_the_ladder_climbing(tmp_path):
    """A live, beating child whose alert rules fire is degraded: the ladder
    climbs instead of resetting, in both packages alike."""
    class Firing:
        def __init__(self, names):
            self.names = names

        def firing(self):
            return self.names

    def run(res, o):
        hb = str(tmp_path / f"{o.__name__}.jsonl")
        s = _stream(o, hb)
        sup = res.Supervisor(res.HeartbeatMonitor(hb, stall_after_s=30.0, now=0.0),
                             alerts=Firing(["slo.p99"]))
        out = []
        for i in range(3):
            s.write_snapshot(step=i)
            out.append(sup.poll(now=1.0 + i))
        return out

    got, _ = _both(run)
    assert [(g["status"], g["reason"], g["action"]) for g in got] == [
        ("degraded", "alert:slo.p99", a) for a in ("warn", "rescale_down", "restart")]


# ------------------------------------------------------------ fault sites


def test_device_lost_site_raises_and_counts():
    before = tobs.metrics.counter_value("resilience.injected", site="device.lost",
                                        where="discovery")
    plane.arm("device.lost", prob=1.0, seed=0, count=1)
    with pytest.raises(DeviceLostError):
        available_devices()
    assert available_devices() >= 1   # budget spent: back to normal
    assert tobs.metrics.counter_value("resilience.injected", site="device.lost",
                                      where="discovery") == before + 1


def test_device_lost_aborts_rescale():
    g, rng = make_adv_grid(1)
    spec = {"q": ((), np.float64)}
    s = g.new_state(spec)
    plane.arm("device.lost", prob=1.0, seed=0, count=1)
    with tempfile.TemporaryDirectory() as td:
        with pytest.raises(DeviceLostError):
            rescale(g, s, spec, 2, directory=td)
        plane.disarm()
        assert rescale(g, s, spec, 2, directory=td).n_devices_after == 2


def test_step_hang_site_sleeps_and_counts():
    assert not inject.maybe_hang("step.hang", seconds=0.01)
    plane.arm("step.hang", prob=1.0, seed=0, count=1)
    t0 = time.perf_counter()
    assert inject.maybe_hang("step.hang", seconds=0.05)
    assert time.perf_counter() - t0 >= 0.05
    assert not inject.maybe_hang("step.hang", seconds=0.05)  # budget spent
