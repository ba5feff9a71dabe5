"""The port's offline consoles (``dccrg_tpu_torch/tools/{slo_report,
cost_report,fleet_top,telemetry_diff}.py``) against the JAX package's
(``tools/<name>.py``): on the same input files, the same ``--json`` output
and the same printed report and exit code.

The inputs are the JAX tests' fixtures (``tests/test_slo.py``'s offline
latency registry and drill-down trace, ``tests/test_live.py``'s stream
directory, ``tests/test_deep_dispatch.py``'s gauge ceilings) and a
serving round of the port on the CPU with the cost model armed, exported
as ``telemetry.json`` (the cost series, the chargeback and the gateway's
counters come from real runs).  ``fleet_top``'s ``ts``, per-writer
``age_s`` and alert ``fired_at`` / ``since`` read the wall clock at the
call and are left out of its comparison."""
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest

from dccrg_tpu_torch.obs.registry import MetricsRegistry
from dccrg_tpu_torch.tools import cost_report, fleet_top, slo_report, telemetry_diff

ROOT = pathlib.Path(__file__).resolve().parents[1]

PORT = {"slo_report": slo_report, "cost_report": cost_report,
        "fleet_top": fleet_top, "telemetry_diff": telemetry_diff}


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_console_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {name: _jax_tool(name) for name in PORT}


def _slo_registry():
    from dccrg_tpu_torch.obs import slo

    reg = MetricsRegistry(enabled=True)
    for name in ("ensemble.queue_wait_s", "ensemble.e2e_s", "ensemble.service_s"):
        reg.set_histogram_resolution(name, slo.SLO_RESOLUTION)
    return reg


def _offline_telemetry(path):
    """``test_slo_report_cli_offline``'s registry: two tenants' lognormal
    queue waits and end-to-end latencies, three misses for one."""
    reg = _slo_registry()
    rng = np.random.default_rng(5)
    for tenant in ("alice", "bob"):
        for v in rng.lognormal(-3, 0.6, size=60):
            reg.observe("ensemble.queue_wait_s", float(v), tenant=tenant)
            reg.observe("ensemble.e2e_s", 3 * float(v), tenant=tenant)
    reg.inc("ensemble.deadline_miss", 3, tenant="alice")
    path.write_text(json.dumps(reg.report()))
    return path


def _drilldown_trace(path):
    """``test_slo_report_drilldown``'s trace."""
    path.write_text(json.dumps({"traceEvents": [
        {"name": "request.e2e", "ph": "B", "pid": 1, "tid": 0, "ts": 0.0,
         "args": {"request": 5, "tenant": "alice"}},
        {"name": "request.e2e", "ph": "E", "pid": 1, "tid": 0, "ts": 9000.0},
        {"name": "jit_gol_step", "ph": "X", "pid": 2, "tid": 0, "ts": 1000.0,
         "dur": 7000.0},
        {"name": "unrelated_kernel", "ph": "X", "pid": 2, "tid": 0, "ts": 20000.0,
         "dur": 500.0},
    ]}))
    return path


def _stream_dir(d):
    """``test_fleet_top_cli_json``'s stream directory (8 lines of one
    writer, one tenant), plus a worker heartbeat stream."""
    d.mkdir()
    now = time.time()
    for name, n in (("a.stream.jsonl", 8), ("worker.stream.jsonl", 3)):
        reg = _slo_registry()
        with open(d / name, "w") as f:
            for j in range(n):
                reg.observe("ensemble.e2e_s", 0.002 * (1 + j % 5), tenant="acme")
                reg.inc("ensemble.steps_served", 1, tenant="acme")
                if j % 2 == 0:
                    reg.inc("ensemble.deadline_miss", 1, tenant="acme")
                rec = {"seq": j, "ts": now - n + j, **reg.report()}
                f.write(json.dumps(rec, default=float) + "\n")
    return d


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two serving rounds of the port on the CPU with the cost model armed
    (deadline-mixed Game of Life, two tenants; advection at four steps a
    dispatch), each exported as a telemetry file: ``(base, cur)``."""
    import dccrg_tpu_torch as P
    from dccrg_tpu_torch import obs
    from dccrg_tpu_torch.serve import Ensemble

    out = []
    d = tmp_path_factory.mktemp("served")
    for rnd, steps in ((0, 2), (1, 3)):
        obs.metrics.reset()
        obs.enable()
        g = (P.Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(0)
             .set_periodic(True, True, True)
             .set_geometry(P.CartesianGeometry, start=(0, 0, 0),
                           level_0_cell_length=(0.25,) * 3)
             .initialize(n_devices=2, device="cpu"))
        gol = P.GameOfLife(g, allow_dense=False)
        cells = g.get_cells()
        rng = np.random.default_rng(rnd)
        ens = Ensemble(policy="deadline")
        now = time.perf_counter()
        for i in range(6):
            ens.submit(gol, gol.new_state(cells[rng.random(len(cells)) < 0.3]),
                       steps=steps + i % 3, tenant=f"tenant{i % 2}",
                       deadline=now - 1.0 if i % 2 == 0 else now + 3600.0)
        ens.run()
        adv = P.Advection(g, dtype=np.float32, allow_dense=False)
        dt = np.float32(0.4 * adv.max_time_step(adv.initialize_state()))
        ens = Ensemble(steps_per_dispatch=4)
        for i in range(4):
            ens.submit(adv, adv.initialize_state(), steps=8, dt=dt, tenant=f"ct{i % 2}")
        ens.run()
        path = d / f"round{rnd}.json"
        obs.export_json(str(path))
        out.append(path)
    obs.metrics.reset()
    return tuple(out)


def _run(tool, argv, capsys):
    """``(exit code, printed text)`` of one console's ``main``."""
    capsys.readouterr()
    rc = tool.main(argv)
    return rc, capsys.readouterr().out


def _both(jax_tools, name, argv_of, tmp_path, capsys, strip=()):
    """Run the JAX console and the port's with ``argv_of(json_path)``;
    assert the same exit code, print-out and ``--json`` object."""
    got = []
    for side, tool in (("jax", jax_tools[name]), ("port", PORT[name])):
        out = tmp_path / f"{name}_{side}.json"
        rc, text = _run(tool, argv_of(str(out)), capsys)
        rec = json.loads(out.read_text()) if out.exists() else None
        for key in strip:
            rec = strip_key(rec, key)
        got.append((rc, text, rec))
    assert got[0][0] == got[1][0]
    assert got[0][2] == got[1][2]
    return got


def strip_key(obj, key):
    """``obj`` without any mapping entry named ``key``, at any depth."""
    if isinstance(obj, dict):
        return {k: strip_key(v, key) for k, v in obj.items() if k != key}
    if isinstance(obj, list):
        return [strip_key(v, key) for v in obj]
    return obj


def test_slo_report_offline(jax_tools, tmp_path, capsys):
    tel = _offline_telemetry(tmp_path / "telemetry.json")
    trace = _drilldown_trace(tmp_path / "trace.json")
    (rc, text, rec), (_, ptext, _) = _both(
        jax_tools, "slo_report",
        lambda js: [str(tel), "--trace", str(trace), "--json", js], tmp_path, capsys)
    assert rc == 0 and text == ptext
    assert rec["deadline_miss_rates"]["alice"]["missed"] == 3
    assert [k["name"] for k in rec["slowest_requests"][0]["kernels"]] == ["jit_gol_step"]


def test_slo_report_served(jax_tools, served, tmp_path, capsys):
    base, cur = served
    (rc, text, rec), (_, ptext, _) = _both(
        jax_tools, "slo_report",
        lambda js: [str(base), str(cur), "--quantiles", "0.5,0.9,0.99", "--json", js],
        tmp_path, capsys)
    assert rc == 0 and text == ptext and rec["latency"]


def test_slo_report_live(jax_tools, tmp_path, capsys):
    d = _stream_dir(tmp_path / "streams")
    (rc, _, rec), _ = _both(
        jax_tools, "slo_report",
        lambda js: ["--live", str(d), "--window", "3600", "--json", js], tmp_path, capsys)
    assert rc == 0 and rec["window_s"] == 3600.0


def test_cost_report(jax_tools, served, tmp_path, capsys):
    base, cur = served
    (rc, text, rec), (_, ptext, _) = _both(
        jax_tools, "cost_report", lambda js: [str(base), str(cur), "--json", js],
        tmp_path, capsys)
    assert rc == 0 and text == ptext
    assert rec["model"] and rec["conservation"]["ok"]
    assert {"ct0", "ct1"} <= set(rec["chargeback"])


def test_cost_report_live(jax_tools, tmp_path, capsys):
    d = _stream_dir(tmp_path / "streams")
    (rc, _, _), _ = _both(
        jax_tools, "cost_report",
        lambda js: ["--live", str(d), "--window", "3600", "--json", js], tmp_path, capsys)
    assert rc == 0


def test_fleet_top(jax_tools, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DCCRG_ALERT_RULES", raising=False)
    d = _stream_dir(tmp_path / "streams")
    (rc, _, rec), _ = _both(
        jax_tools, "fleet_top",
        lambda js: [str(d), "--json", js, "--window", "3600", "--cost", "--workers",
                    "--alerts"],
        tmp_path, capsys, strip=("ts", "age_s", "fired_at", "since"))
    assert rc == 0
    assert rec["health"]["files"] == 2
    assert rec["rates"]["ensemble.steps_served"]["tenant=acme"] > 0


@pytest.mark.parametrize("case", ["pass", "regressed", "gauges"])
def test_telemetry_diff(jax_tools, served, tmp_path, capsys, case):
    """A served round against the other (the counter, gauge and p99
    gates engage on real series), an injected 3x phase regression, and
    ``test_telemetry_diff_hbm_ceiling_gate``'s gauge ceiling through the
    command line."""
    base, cur = served
    if case == "regressed":
        rep = json.loads(cur.read_text())
        for ph in rep["phases"].values():
            ph["total_s"] *= 3.0
            if "mean_s" in ph:
                ph["mean_s"] *= 3.0
        cur = tmp_path / "regressed.json"
        cur.write_text(json.dumps(rep))
    elif case == "gauges":
        base, cur = tmp_path / "g_base.json", tmp_path / "g_cur.json"
        for path, v in ((base, 1000), (cur, 2000)):
            path.write_text(json.dumps({
                "phases": {"halo.exchange": {"total_s": 0.1, "count": 10}},
                "gauges": {"ensemble.hbm_bytes_per_member": {"model=gol": v}}}))
    (rc, text, rec), (prc, ptext, _) = _both(
        jax_tools, "telemetry_diff",
        lambda js: ["--current", str(cur), "--baseline", str(base), "--min-total", "0",
                    "--no-history", "--json", js], tmp_path, capsys)
    assert text == ptext
    if case != "pass":     # the served pair may pass or fail on timing
        assert rc == 1 and rec["verdict"] == "FAIL"


def test_telemetry_diff_history(jax_tools, served, tmp_path, capsys):
    """Three rounds through each tool's own history file: the drift record
    and the retained history agree."""
    base, cur = served
    for side, tool in (("jax", jax_tools["telemetry_diff"]),
                       ("port", telemetry_diff)):
        hist = tmp_path / f"{side}_history.jsonl"
        for _ in range(3):     # the third sees two retained rounds
            tool.main(["--current", str(cur), "--baseline", str(base),
                       "--history", str(hist), "--json",
                       str(tmp_path / f"{side}.json")])
    capsys.readouterr()
    j = json.loads((tmp_path / "jax.json").read_text())
    p = json.loads((tmp_path / "port.json").read_text())
    assert j == p and "drift" in p
    assert (tmp_path / "jax_history.jsonl").read_text() == \
        (tmp_path / "port_history.jsonl").read_text()


def test_telemetry_diff_defaults_stay_off_the_jax_files(served, tmp_path, capsys):
    """The port's defaults: the baseline is ``telemetry_prev.json`` beside
    ``--current`` (absent: a vacuous pass) and the history lands beside
    ``--current``, never in ``tools/``."""
    cur = tmp_path / "telemetry.json"
    cur.write_text(served[1].read_text())
    assert telemetry_diff.main(["--current", str(cur)]) == 0
    assert not (tmp_path / "telemetry_history.jsonl").exists()
    (tmp_path / "telemetry_prev.json").write_text(cur.read_text())
    assert telemetry_diff.main(["--current", str(cur), "--min-total", "0"]) == 0
    assert (tmp_path / "telemetry_history.jsonl").exists()
    assert "telemetry_prev.json" in capsys.readouterr().out
