"""The port's observability plane (``dccrg_tpu_torch.obs``) against the JAX
package's (``dccrg_tpu.obs``): the same call sequence goes into both
packages' registries, timelines, exporters, streams, flight recorders and
SLO, live, alert and cost objects, under one fake clock, and their
exported dicts must be equal (pids and thread ids set aside).  Every
object here is built fresh: the JAX package's process-wide registry is
only read, never reset or disabled (other tests on the same worker read
it)."""
import json
import os
import threading
import time

import pytest

import dccrg_tpu.obs as jobs
import dccrg_tpu_torch.obs as tobs
from dccrg_tpu.utils import PhaseTimers as JPhaseTimers
from dccrg_tpu_torch.utils import PhaseTimers as TPhaseTimers

#: keys whose values are the process's or the thread's identity
_IDENTITY_KEYS = {"pid", "tid", "host_pid"}


def _normalize(x):
    """Drop process and thread identities; leave every other value as it
    was exported."""
    if isinstance(x, dict):
        return {k: _normalize(v) for k, v in x.items() if k not in _IDENTITY_KEYS}
    if isinstance(x, (list, tuple)):
        return [_normalize(v) for v in x]
    return x


class _FakeClock:
    """``time.perf_counter`` / ``time.time`` advancing a fixed quarter
    second a call, so durations and timestamps repeat exactly."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return 100.0 + 0.25 * self.n

    def time(self):
        self.n += 1
        return 1.7e9 + 0.25 * self.n


def _registry_sequence(obs, reg):
    """One registry call sequence: counters (single, batched, prepared),
    gauges, histograms at two resolutions, nested and direct phases."""
    from importlib import import_module

    labels_key = import_module(obs.__name__ + ".registry")._labels_key
    reg.set_histogram_resolution("ensemble.e2e_s", 8)
    reg.inc("halo.exchanges", kind="blocking", hood="default")
    reg.inc("halo.exchanges", 2, kind="split", hood="default")
    reg.inc_many([("checkpoint.bytes_written", 4096), ("amr.commits", 1, {})])
    reg.inc_batch([(("halo.send_cells", labels_key({"device": 3})), 17)])
    reg.gauge("epoch.n_cells", 904)
    reg.gauge("hbm.bytes_in_use", 1 << 20, device=0)
    for v in (0.0, 0.003, 0.125, 0.5, 1.0, 3.7):
        reg.observe("ensemble.e2e_s", v, tenant="a")
        reg.observe("checkpoint.sizes", v * 100)
    with reg.phase("epoch.build"):
        with reg.phase("epoch.build"):
            with reg.phase("epoch.hood_build"):
                pass
    reg.phase_add("halo.exchange", 0.002)
    reg.observe_duration("custom.span", 0.01)
    return {
        "report": reg.report(),
        "counter": reg.counter_value("halo.exchanges", kind="split", hood="default"),
        "gauge": reg.gauge_value("epoch.n_cells"),
        "phases": sorted(reg.phase_names()),
    }


def _case_registry(obs, tmp):
    reg = obs.MetricsRegistry()
    out = _registry_sequence(obs, reg)
    reg.reset()
    out["after_reset"] = reg.report()
    off = obs.MetricsRegistry(enabled=False)
    _registry_sequence(obs, off)
    out["disabled"] = off.report()
    return out


def _case_events(obs, tmp):
    reg = obs.MetricsRegistry()
    tl = obs.EventTimeline(enabled=True, max_events=6)
    reg.timeline = tl
    with tl.context(grid_id=3):
        with reg.phase("amr.refine"):
            reg.phase_add("epoch.delta_build", 0.5)
        with tl.context(step=1):
            with tl.span("workload.step", model="advection"):
                reg.phase_add("halo.exchange", 0.25)
    tl.add("hand.fed", 101.0, 2.0, {"k": 1})
    for i in range(4):
        tl.add(f"overflow.{i}", 110.0 + i, 0.5)
    path = os.path.join(tmp, "trace.json")
    obs.export_chrome_trace(path, tl)
    with open(path) as f:
        exported = json.load(f)
    return {"summary": tl.summary(), "spans": tl.spans(), "len": len(tl),
            "chrome": tl.chrome_trace(), "exported": exported,
            "wall": tl.wall_time(tl.origin_perf + 1.0),
            "registry": reg.report()}


def _case_export(obs, tmp):
    reg = obs.MetricsRegistry()
    _registry_sequence(obs, reg)
    path = os.path.join(tmp, "telemetry.json")
    rep = obs.export_json(path, registry=reg, extra={"workload": "probe"})
    with open(path) as f:
        return {"returned": rep, "file": json.load(f)}


def _case_stream(obs, tmp):
    reg = obs.MetricsRegistry()
    path = os.path.join(tmp, "t.stream.jsonl")
    st = obs.TelemetryStream(path, period=3600.0, registry=reg,
                             extra={"proc": "probe"}, truncate=True)
    for i in range(3):
        reg.inc("halo.exchanges", i + 1, kind="blocking", hood="default")
        reg.observe("ensemble.e2e_s", 0.1 * (i + 1), tenant="a")
        st.write_snapshot(round=i)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    return {"lines": lines}


def _case_flightrec(obs, tmp):
    reg = obs.MetricsRegistry()
    reg.inc("halo.exchanges", 5, kind="blocking", hood="default")
    fr = obs.FlightRecorder(cap=8, enabled=True, registry=reg)
    for i in range(10):
        fr.add_span(f"halo.exchange.{i}", 100.0 + i, 0.5, {"step": i} if i % 2 else None)
    fr.note("alert.fired", rule="r", value=2.0)
    fr.begin_request("req-1", tenant="a", steps=4)
    fr.begin_request("req-2", tenant="b", steps=2)
    fr.end_request("req-1", ok=True)
    fr.mark_unit("unit-7", model="advection")
    path = os.path.join(tmp, "flightrec.json")
    fr.dump(path, reason="probe")
    with open(path) as f:
        dumped = json.load(f)
    return {"record": fr.record("probe"), "in_flight": fr.in_flight(),
            "dumped": dumped, "valid": obs.validate_flightrec(path)}


def _slo_report(obs):
    reg = obs.MetricsRegistry()
    for t, vals in (("a", (0.01, 0.02, 0.05, 0.4)), ("b", (0.2, 0.3))):
        for v in vals:
            reg.observe("ensemble.e2e_s", v, tenant=t)
    reg.inc("ensemble.deadline_miss", 1, tenant="a")
    reg.inc("ensemble.deadline_miss", 2, tenant="c")
    return reg.report()


def _case_slo(obs, tmp):
    rep = _slo_report(obs)
    series = obs.slo.collect_series(rep, "ensemble.e2e_s")
    merged = obs.slo.merge(*series.values())
    path = os.path.join(tmp, "r.json")
    with open(path, "w") as f:
        json.dump(rep, f)
    return {"series": series, "merged": merged,
            "q": [obs.slo.quantile(merged, q) for q in (0.0, 0.5, 0.95, 0.99, 1.0)],
            "quantiles": obs.slo.quantiles(merged),
            "summary": obs.slo.summarize(merged),
            "merge_series": obs.slo.merge_series([rep, rep], "ensemble.e2e_s"),
            "miss": obs.slo.deadline_miss_rates(rep),
            "loaded": obs.slo.load_report(path)}


def _two_streams(obs, tmp):
    """Two writers' streams, three snapshots each, two seconds apart."""
    paths = []
    for w in range(2):
        reg = obs.MetricsRegistry()
        path = os.path.join(tmp, f"w{w}.stream.jsonl")
        st = obs.TelemetryStream(path, registry=reg, truncate=True)
        for i in range(3):
            reg.inc("halo.exchanges", 10 * (w + 1), kind="blocking", hood="default")
            reg.inc("ensemble.deadline_miss", w, tenant="a")
            reg.gauge("device.busy_fraction", 0.5 + 0.1 * w + 0.01 * i, device=w)
            for v in (0.01 * (i + 1), 0.2 * (w + 1)):
                reg.observe("ensemble.e2e_s", v, tenant="a")
            st.write_snapshot()
        paths.append(path)
    return paths


def _case_live(obs, tmp):
    paths = _two_streams(obs, tmp)
    reg = obs.MetricsRegistry()
    agg = obs.live.FleetAggregator(paths, window_s=1.0, registry=reg)
    new = agg.poll(now=1.7e9 + 100.0)
    view = agg.view(now=1.7e9 + 100.0)
    lab = {"kind": "blocking", "hood": "default"}
    rep = _slo_report(obs)
    prom = obs.live.to_prometheus(rep)
    tail = obs.live.StreamTailer(paths[0], registry=reg)
    return {"new": new,
            "counter": view.counter("halo.exchanges", lab),
            "counter_cum": view.counter("halo.exchanges", lab, windowed=False),
            "rate": view.rate("halo.exchanges", lab),
            "hist": view.histogram("ensemble.e2e_s", {"tenant": "a"}, windowed=False),
            "q": view.quantile("ensemble.e2e_s", 0.5, {"tenant": "a"}, windowed=False),
            "gauges": view.gauge_values("device.busy_fraction"),
            "miss": view.miss_rates(windowed=False),
            "prom": prom, "parsed": obs.live.parse_prometheus(prom),
            "tail": len(tail.poll()), "gaps": tail.seq_gaps,
            "registry": reg.report()["counters"]}


def _case_alerts(obs, tmp):
    paths = _two_streams(obs, tmp)
    agg = obs.live.FleetAggregator(paths, window_s=1.0, registry=obs.MetricsRegistry())
    agg.poll(now=1.7e9 + 100.0)
    view = agg.view(now=1.7e9 + 100.0)
    rules = [
        obs.alerts.AlertRule("busy", "device.busy_fraction", kind="floor",
                             threshold=0.9, clear=0.95),
        obs.alerts.AlertRule("busy_ok", "device.busy_fraction", threshold=0.99),
        obs.alerts.AlertRule("slow", "ensemble.e2e_s", source="quantile",
                             threshold=0.1, quantile=0.5, for_s=5.0),
    ]
    reg = obs.MetricsRegistry()
    eng = obs.alerts.AlertEngine(rules, registry=reg, flight_recorder=False)
    got = [eng.poll(view, now=1.7e9 + 100.0 + 10.0 * i) for i in range(3)]
    return {"transitions": got, "firing": eng.firing(), "snapshot": eng.snapshot(),
            "state": eng.state("slow"), "rules": [r.to_dict() for r in rules],
            "round_trip": [obs.alerts.AlertRule.from_dict(r.to_dict()).to_dict()
                           for r in rules],
            "defaults": [r.to_dict() for r in obs.alerts.default_rules()],
            "registry": reg.report()["counters"]}


def _case_cost(obs, tmp):
    reg = obs.MetricsRegistry()
    m = obs.cost.StepCostModel(registry=reg)
    for i, (model, k) in enumerate((("advection", 4), ("advection", 8), ("gol", 4)) * 4):
        m.observe(model, "sig0", k, 1, 8, 0.001 * (i + 1))
    reg.inc("ensemble.device_s", 1.5, tenant="a", model="advection")
    reg.inc("ensemble.device_s", 0.5, tenant="b", model="gol")
    reg.inc("ensemble.device_s_total", 2.0)
    reg.inc("ensemble.steps_served", 40, tenant="a")
    reg.inc("ensemble.steps_served", 10, tenant="b")
    reg.gauge("halo.exchanges_per_step", 0.25, model="advection")
    rep = reg.report()
    est = lambda e: None if e is None else tuple(e)
    return {"export": m.export(), "keys": m.keys(), "n": m.sample_count(),
            "exact": est(m.predict("advection", "sig0", 4, 1, 8, q=0.5)),
            "model": est(m.predict("advection", q=0.95)),
            "global": est(m.predict("vlasov")),
            "label": obs.cost.key_label("advection", "sig0", 4, 1, 8),
            "charge": obs.cost.chargeback(rep), "conserve": obs.cost.conservation(rep),
            "wait": obs.cost.predicted_wait({"a": 100, "b": 0, "c": 5},
                                            rates=lambda t: {"a": 50.0}.get(t, 0.0)),
            "registry": rep}


def _case_hbm(obs, tmp):
    reg = obs.MetricsRegistry()
    v = obs.hbm.sample_ensemble_hbm("advection", 12345, registry=reg)
    off = obs.MetricsRegistry(enabled=False)
    # neither package's CPU process has a device allocator to sample
    return {"v": v, "off": obs.hbm.sample_ensemble_hbm("gol", 1, registry=off),
            "cpu": obs.sample_hbm(reg), "registry": reg.report()}


def _case_timers(obs, tmp):
    t = (JPhaseTimers if obs is jobs else TPhaseTimers)()
    with t.phase("a"):
        with t.phase("a"):
            pass
    with t.phase("b"):
        pass
    out = {"report": t.report(), "total": t.total, "count": t.count,
           "enabled": t.enabled}
    t.enabled = False
    with t.phase("c"):
        pass
    t.reset()
    out["after"] = t.report()
    return out


def _case_fused(obs, tmp):
    """``fused.record_run`` writes the process-wide registry: compare the
    counter deltas it leaves."""
    before = obs.metrics.report()["counters"]
    obs.fused.record_run("probe_model", "fused", 7, 96)
    obs.fused.record_run("probe_model", "dense", "3", 0)
    obs.fused.record_run("probe_model", "fused", object(), 96)   # skipped
    after = obs.metrics.report()["counters"]
    return {f"{name}{{{lab}}}": v - before.get(name, {}).get(lab, 0)
            for name, series in after.items() if name.startswith("fused.")
            for lab, v in series.items() if v != before.get(name, {}).get(lab, 0)}


CASES = {
    "registry": _case_registry,
    "events": _case_events,
    "export": _case_export,
    "stream": _case_stream,
    "flightrec": _case_flightrec,
    "slo": _case_slo,
    "live": _case_live,
    "alerts": _case_alerts,
    "cost": _case_cost,
    "hbm": _case_hbm,
    "timers": _case_timers,
    "fused": _case_fused,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_jax_module(case, tmp_path, monkeypatch):
    """The same calls into the JAX module and its copy in the port export
    equal dicts."""
    got = {}
    for name, obs in (("jax", jobs), ("torch", tobs)):
        clock = _FakeClock()
        monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
        monkeypatch.setattr(time, "time", clock.time)
        d = tmp_path / name
        d.mkdir()
        got[name] = _normalize(json.loads(json.dumps(CASES[case](obs, str(d)),
                                                     default=repr)))
        monkeypatch.undo()
    assert got["torch"] == got["jax"]


def test_port_exports_series_names_and_formats():
    """The port's package surface is the JAX package's, with ``kineto`` in
    the place of ``xplane`` and without ``trace_span`` (a lone
    ``record_function`` nothing in the port called: every registry phase
    annotates a running capture)."""
    want = set(jobs.__all__) - {"xplane", "trace_span"} | {"kineto"}
    assert set(tobs.__all__) == want
    for name in tobs.__all__:
        assert hasattr(tobs, name)
    assert tobs.kineto.CLOCK_SYNC_TAG == jobs.xplane.CLOCK_SYNC_TAG


def test_registry_thread_safety_and_reentrancy():
    """Concurrent outer phases of one name on different threads each count;
    a nested span of the same name counts once (the JAX registry's
    contract)."""
    reg = tobs.MetricsRegistry()

    def work():
        for _ in range(50):
            with reg.phase("p"):
                with reg.phase("p"):
                    reg.inc("c")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = reg.report()
    assert rep["counters"]["c"][""] == 200
    assert rep["phases"]["p"]["count"] == 200
