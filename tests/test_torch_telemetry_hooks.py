"""The port's recording hooks against the JAX package's: one workload (an
8^3 grid with one refined ball, on 1 and 8 slots — exchanges, an HSFC
``balance_load``, a refine + ``stop_refining``, ``save_grid_data`` and an
Advection ``run``) runs in both packages, and the counters, gauges and
phase counts it records must be equal, series by series, apart from an
explicit excluded set that gives each reason.  Also: the disabled modes
record nothing, the JAX package's consoles read the port's files, and the
hooks' individual series (verify oracle, fault injection, CRC failures,
staged balance, the fused paths of GoL and Vlasov, the CUDA build's
compile accounting) fire as the JAX package's do.

The JAX package's process-wide registry is only read here (deltas around
the workload, gauge calls observed through a wrapper), never reset or
disabled: other tests on the same worker read it."""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu.obs as jobs
import dccrg_tpu_torch
import dccrg_tpu_torch.obs as tobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: series the two packages record differently by design, with the reason
EXCLUDED = {
    "epoch.cache_hits": "the executable cache's series: the JAX package "
                        "counts compiled programs, the port (which compiles "
                        "none) the cohort bodies it builds",
    "epoch.cache_misses": "as epoch.cache_hits",
    "epoch.cache_size": "as epoch.cache_hits",
    "epoch.recompiles": "the JAX package counts traces of its jitted kernels; "
                        "the port's only compile is a CUDA library build at "
                        "first use (cuda_build), once a process",
    "compile": "the phase of epoch.recompiles (same reason)",
    "hbm.": "device allocator gauges: the CPU has none in either package",
    "grid.": "the port's set-up spans (grid.initialize, grid.partition, "
             "grid.stop_refining), which the JAX package does not record",
    "advection.": "the port's model spans and its host-read and "
                  "host-to-device counters, which the JAX package does not "
                  "record (its step runs inside a jitted program)",
}

#: series of the Advection run that differ by design: the JAX package's
#: exchanges inside its jitted step loop are not recorded; the port
#: launches each step's exchange from the host and records it
RUN_EXCLUDED = {
    "halo.": "exchanges inside the JAX package's jitted run are not recorded",
    "halo.exchange": "the phase of those exchanges (same reason)",
}


def _excluded(name, table):
    return any(name == k or (k.endswith(".") and name.startswith(k)) for k in table)


def _mesh_kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def _grid(pkg, n_dev):
    g = (pkg.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
         .set_periodic(True, True, True).set_maximum_refinement_level(1)
         .set_load_balancing_method("HSFC")
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1 / 8,) * 3)
         .initialize(**_mesh_kw(pkg, n_dev)))
    ids = g.get_cells()
    r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
    g.refine_completely_many(ids[r < 0.3])
    g.stop_refining()
    return g


def _advection(pkg, g):
    Adv = importlib.import_module(pkg.__name__ + ".models").Advection
    # the JAX flat kernel runs in interpret mode on the CPU, which keeps
    # the flat preference over the boxed passes; the port's H100 edge
    # constants keep it on this grid too
    kw = {"use_pallas": "interpret"} if pkg is dccrg_tpu else {}
    return Adv(g, dtype=np.float32, **kw)


def _state_of(report):
    """(counters, phase counts) of a report, flat: ``name{labels}``."""
    counters = {f"{n}{{{lab}}}": v for n, s in report["counters"].items()
                for lab, v in s.items()}
    phases = {n: rec["count"] for n, rec in report["phases"].items()}
    return counters, phases


def _delta(a, b):
    """Per-series increase from report ``a`` to report ``b``."""
    (ca, pa), (cb, pb) = _state_of(a), _state_of(b)
    out = {k: v - ca.get(k, 0) for k, v in cb.items() if v != ca.get(k, 0)}
    out.update({"phase:" + k: v - pa.get(k, 0) for k, v in pb.items()
                if v != pa.get(k, 0)})
    return out


class _GaugeLog:
    """Every gauge a registry sets, observed through an instance wrapper
    (the registry itself is left as it is)."""

    def __init__(self, reg, monkeypatch):
        self.calls = {}
        inner = reg.gauge

        def gauge(name, value, **labels):
            key = name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
            self.calls[key] = value.item() if hasattr(value, "item") else value
            return inner(name, value, **labels)

        monkeypatch.setattr(reg, "gauge", gauge)


def _workload(pkg, reg, n_dev, tmp, monkeypatch):
    """Drive the workload; returns the recorded deltas before the run, of
    the run, and the gauges set."""
    gauges = _GaugeLog(reg, monkeypatch)
    r0 = reg.report()
    g = _grid(pkg, n_dev)
    adv = _advection(pkg, g)
    s = adv.initialize_state()
    s = g.update_copies_of_remote_neighbors(s)
    h = g.start_remote_neighbor_copy_updates(s)
    s = g.wait_remote_neighbor_copy_updates(s, h)
    g.balance_load()
    s = g.update_copies_of_remote_neighbors(g.remap_state(s))
    ids = g.get_cells()
    g.refine_completely_many(ids[:: max(len(ids) // 6, 1)][:4])
    g.stop_refining()
    s = g.update_copies_of_remote_neighbors(g.remap_state(s))
    g.save_grid_data(s, os.path.join(tmp, f"{pkg.__name__}.dc"), adv.spec)
    r1 = reg.report()
    adv = _advection(pkg, g)
    dt = 0.4 * adv.max_time_step(s)
    adv.run(s, 3, dt)
    r2 = reg.report()
    monkeypatch.undo()
    return _delta(r0, r1), _delta(r1, r2), gauges.calls


@pytest.mark.parametrize("n_dev", [1, 8])
def test_workload_counters_equal_jax(n_dev, tmp_path, monkeypatch):
    got = {}
    for pkg, reg in ((dccrg_tpu, jobs.metrics), (dccrg_tpu_torch, tobs.metrics)):
        got[pkg.__name__] = _workload(pkg, reg, n_dev, str(tmp_path), monkeypatch)
    (jpre, jrun, jg), (tpre, trun, tg) = got["dccrg_tpu"], got["dccrg_tpu_torch"]

    def keep(d, table):
        return {k: v for k, v in d.items()
                if not _excluded(k.split("{")[0].removeprefix("phase:"), table)}

    assert keep(tpre, EXCLUDED) == keep(jpre, EXCLUDED)
    both = {**EXCLUDED, **RUN_EXCLUDED}
    assert keep(trun, both) == keep(jrun, both)
    assert keep(tg, EXCLUDED) == keep(jg, EXCLUDED)
    # what the comparison covers: every family of the hooks fired
    for fam in ("halo.exchanges", "epoch.delta_builds", "amr.commits",
                "loadbalance.migrations", "checkpoint.bytes_written"):
        assert any(k.startswith(fam) for k in tpre), fam
    for ph in ("halo.exchange", "halo.start", "epoch.build", "epoch.delta_build",
               "loadbalance.migrate", "amr.refine", "checkpoint.write"):
        assert tpre.get("phase:" + ph, 0) >= 1, ph
    assert trun["fused.runs{model=advection,path=" + ("flat" if n_dev == 1 else "general")
                + "}"] == 1
    assert any(k.startswith("epoch.n_cells") for k in tg)
    if n_dev > 1:
        assert tpre["halo.bytes_moved{}"] > 0
        assert any(k.startswith("halo.send_cells_per_exchange") for k in tg)
        # the run's exchanges are recorded in the port only
        assert trun["halo.exchanges{hood=default,kind=blocking}"] == 3
        assert "halo.exchanges{hood=default,kind=blocking}" not in jrun


def test_spans_carry_grid_id():
    g = _grid(dccrg_tpu_torch, 2)
    s = g.new_state({"v": ((), np.float32)})
    tobs.timeline.clear()     # the port's timeline: bounded, shared by the worker
    g.update_copies_of_remote_neighbors(s)
    (span,) = tobs.timeline.spans()
    assert span["name"] == "halo.exchange" and span["args"] == {"grid_id": g.grid_id}
    rep = g.report()
    assert rep["grid"] == {"grid_id": g.grid_id, "n_cells": len(g.get_cells()),
                           "n_devices": 2, "rows_per_device": g.epoch.R,
                           "ghost_cells": int(g.epoch.n_ghost.sum()),
                           "neighborhoods": 1, "max_refinement_level": 1}
    assert g.telemetry is tobs.metrics and g.events is tobs.timeline
    assert set(rep) == {"phases", "counters", "gauges", "histograms", "events", "grid"}


_DISABLED_PROBE = r"""
import json, os, sys, tempfile
import numpy as np
sys.path.insert(0, {root!r})
import dccrg_tpu_torch as P
from dccrg_tpu_torch import obs
from dccrg_tpu_torch.models import Advection, GameOfLife
if {use_call}:
    obs.disable()
g = (P.Grid().set_initial_length((8, 8, 8)).set_neighborhood_length(0)
     .set_periodic(True, True, True).set_maximum_refinement_level(1)
     .set_load_balancing_method("HSFC")
     .set_geometry(P.CartesianGeometry, start=(0, 0, 0), level_0_cell_length=(1 / 8,) * 3)
     .initialize(n_devices=4, device="cpu"))
ids = g.get_cells()
g.refine_completely_many(ids[np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
g.stop_refining()
adv = Advection(g, dtype=np.float32)
s = adv.initialize_state()
s = g.wait_remote_neighbor_copy_updates(s, g.start_remote_neighbor_copy_updates(s))
g.balance_load()
s = g.update_copies_of_remote_neighbors(g.remap_state(s))
with tempfile.TemporaryDirectory() as d:
    g.save_grid_data(s, os.path.join(d, "c.dc"), adv.spec)
    P.Grid.load_grid_data(os.path.join(d, "c.dc"), adv.spec, n_devices=2, device="cpu")
adv = Advection(g, dtype=np.float32)
adv.run(s, 2, 0.4 * adv.max_time_step(s))
gg = (P.Grid().set_initial_length((16, 16, 1)).set_neighborhood_length(1)
      .set_periodic(True, True, False).initialize(device="cpu"))
gol = GameOfLife(gg)
gol.run(gol.new_state(gg.get_cells()[::3]), 3)
print(json.dumps({{"report": obs.metrics.report(), "timeline": len(obs.timeline)}}))
"""


@pytest.mark.parametrize("how", ["disable", "env"])
def test_disabled_records_nothing(how):
    """With ``obs.disable()`` or ``DCCRG_TELEMETRY=0`` a whole workload
    leaves the registry empty (and no phase reaches the timeline)."""
    env = {**os.environ, "DCCRG_TELEMETRY": "0" if how == "env" else "1"}
    code = _DISABLED_PROBE.format(root=ROOT, use_call=how == "disable")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["report"] == {"phases": {}, "counters": {}, "gauges": {}, "histograms": {}}
    assert got["timeline"] == 0


def _tools():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_telemetry
    finally:
        sys.path.pop(0)
    return check_telemetry


def test_consoles_read_the_port_files(tmp_path, monkeypatch):
    """A port workload's ``telemetry.json``, stream, timeline trace, merged
    trace and flight-recorder dump pass the JAX package's validators and
    load in its SLO reader."""
    from dccrg_tpu.obs.flightrec import validate_flightrec as j_validate_flightrec
    from dccrg_tpu.obs.merge import validate_merged_trace as j_validate_merged
    from dccrg_tpu.obs.slo import load_report

    ct = _tools()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    monkeypatch.setenv("DCCRG_HALO_VERIFY", "1")
    stream_path = str(tmp_path / "telemetry.json.stream.jsonl")
    st = tobs.TelemetryStream(stream_path, truncate=True)
    st.write_snapshot()
    with tobs.profile_trace(str(tmp_path / "prof")):
        g = _grid(dccrg_tpu_torch, 8)
        adv = _advection(dccrg_tpu_torch, g)
        s = adv.initialize_state()
        s = g.wait_remote_neighbor_copy_updates(s, g.start_remote_neighbor_copy_updates(s))
        g.balance_load()
        s = g.update_copies_of_remote_neighbors(g.remap_state(s))
        g.save_grid_data(s, str(tmp_path / "c.dc"), adv.spec)
    st.write_snapshot()
    tele = str(tmp_path / "telemetry.json")
    rep = tobs.export_json(tele, extra={"workload": "hooks"})
    trace = str(tmp_path / "telemetry.json.trace.json")
    tobs.export_chrome_trace(trace)
    merged = str(tmp_path / "telemetry.json.merged_trace.json")
    tobs.merge_profile(str(tmp_path / "prof"), out_path=merged, registry=tobs.MetricsRegistry())
    dump = tobs.flight_recorder.dump(str(tmp_path / "flightrec.json"), reason="probe")
    counts = {}
    assert ct.validate_stream(stream_path, counts) == []
    assert counts["lines"] == 2 and counts["seq_gaps"] == 0 and counts["torn_tail"] == 0
    assert ct.validate_chrome_trace(trace) == []
    assert j_validate_merged(merged) == []
    assert j_validate_flightrec(dump) == []
    assert tobs.validate_flightrec(dump) == []
    assert load_report(tele)["counters"] == json.loads(json.dumps(rep))["counters"]
    # the phases and counters the port's layers owe the console's lists
    ported = ("halo.exchange", "epoch.build", "epoch.delta_build", "loadbalance.migrate",
              "amr.refine", "checkpoint.write")
    assert set(ported) <= set(ct.REQUIRED_PHASES) and set(ported) <= set(rep["phases"])
    for name in ("halo.bytes_moved", "halo.cells_moved", "amr.cells_refined",
                 "checkpoint.bytes_written", "halo.backend_schedules", "halo.verify_checks"):
        assert name in ct.REQUIRED_NONZERO_COUNTERS
        assert sum(rep["counters"][name].values()) > 0, name
    assert "phase.duration_s" in rep["histograms"]


def test_verify_oracle_counts_in_registry(monkeypatch):
    """``DCCRG_HALO_VERIFY=1`` on the kernel backend (its twin on the CPU):
    checks and the verify phase land in the registry as in the JAX
    package, beside the exchange's own counts."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    monkeypatch.setenv("DCCRG_HALO_VERIFY", "1")
    g = _grid(dccrg_tpu_torch, 4)
    s = g.new_state({"a": ((), np.float32), "b": ((2,), np.float64)})
    c0 = tobs.metrics.counter_value("halo.verify_checks")
    n0 = tobs.metrics.report()["phases"].get("halo.verify", {}).get("count", 0)
    ex = g.halo()
    assert ex.backend == "pallas"
    g.update_copies_of_remote_neighbors(s)
    g.wait_remote_neighbor_copy_updates(s, g.start_remote_neighbor_copy_updates(s))
    assert tobs.metrics.counter_value("halo.verify_checks") == c0 + 4 == c0 + ex.verify_checks
    assert tobs.metrics.report()["phases"]["halo.verify"]["count"] == n0 + 2
    assert tobs.metrics.counter_value("halo.backend_schedules", backend="pallas") >= 1
    assert ex.verify_mismatches == {}


def test_staged_balance_and_checkpoint_faults():
    """The staged balance counts its copied rows; an injected fault counts
    under its site; a flipped byte counts a CRC failure of its section."""
    from dccrg_tpu_torch.io.checkpoint import CheckpointError
    from dccrg_tpu_torch.resilience import inject
    import tempfile

    g = _grid(dccrg_tpu_torch, 4)
    s = g.new_state({"v": ((), np.float64)})
    rows0 = tobs.metrics.counter_value("loadbalance.staged_rows")
    mig0 = tobs.metrics.counter_value("loadbalance.migrations")
    g.set_partitioning_option("LB_METHOD", "RCB")
    g.initialize_balance_load()
    while g.continue_balance_load(s, max_cells=100):
        pass
    s = g.finish_balance_load(s)
    assert tobs.metrics.counter_value("loadbalance.staged_rows") == rows0 + len(g.get_cells())
    assert tobs.metrics.counter_value("loadbalance.migrations") == mig0 + 1
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "c.dc")
        inj0 = tobs.metrics.counter_value("resilience.injected", site="checkpoint.bit_flip")
        crc0 = tobs.metrics.counter_value("checkpoint.crc_failures", section="payload")
        inject.plane.arm("checkpoint.bit_flip", prob=1.0, seed=3, count=1)
        try:
            g.save_grid_data(s, path, {"v": ((), np.float64)})
        finally:
            inject.plane.disarm("checkpoint.bit_flip")
        assert tobs.metrics.counter_value(
            "resilience.injected", site="checkpoint.bit_flip") == inj0 + 1
        with pytest.raises(CheckpointError):
            dccrg_tpu_torch.Grid.load_grid_data(path, {"v": ((), np.float64)}, device="cpu")
        assert tobs.metrics.counter_value(
            "checkpoint.crc_failures", section="payload") == crc0 + 1


def _fused_delta(reg, fn):
    before = reg.report()["counters"]
    fn()
    after = reg.report()["counters"]
    return {f"{n}{{{lab}}}": v - before.get(n, {}).get(lab, 0)
            for n, s in after.items() if n.startswith("fused.")
            for lab, v in s.items() if v != before.get(n, {}).get(lab, 0)}


def test_fused_paths_of_gol_and_vlasov_equal_jax():
    """GameOfLife's dense 2-D run and Vlasov's dense and general runs record
    the JAX package's ``fused.*`` series (paths and halo byte equivalents)."""
    def gol(pkg, n_dev):
        g = (pkg.Grid().set_initial_length((12, 12, 1)).set_neighborhood_length(1)
             .set_periodic(True, True, False).initialize(**_mesh_kw(pkg, n_dev)))
        # the JAX board kernel in interpret mode, the port's twin on the CPU
        kw = {"use_pallas": "interpret"} if pkg is dccrg_tpu else {}
        m = importlib.import_module(pkg.__name__ + ".models").GameOfLife(g, **kw)
        s = m.new_state(g.get_cells()[::3])
        return lambda: m.run(s, 3)

    def vlasov(pkg, n_dev, refined):
        g = (pkg.Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(0)
             .set_periodic(True, True, True).set_maximum_refinement_level(1)
             .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=(0.25,) * 3)
             .initialize(**_mesh_kw(pkg, n_dev)))
        if refined:
            g.refine_completely(1)
            g.stop_refining()
        m = importlib.import_module(pkg.__name__ + ".models").Vlasov(g, 2, dtype=np.float64)
        s = m.initialize_state()
        return lambda: m.run(s, 2, 0.1 * m.max_time_step())

    for name, make in (("gol", lambda p: gol(p, 1)), ("gol8", lambda p: gol(p, 4)),
                       ("vlasov", lambda p: vlasov(p, 2, False)),
                       ("vlasov_amr", lambda p: vlasov(p, 2, True))):
        j = _fused_delta(jobs.metrics, make(dccrg_tpu))
        t = _fused_delta(tobs.metrics, make(dccrg_tpu_torch))
        assert t == j, name


def test_cuda_build_counts_compiles(monkeypatch, tmp_path):
    """Each library ``cuda_build.build`` compiles counts one
    ``epoch.recompiles{kernel=<stem>}`` and adds its seconds to the
    ``compile`` phase; a library already built counts nothing.  (The
    compiler is stood in for by a script that writes the output file: the
    CPU has no nvcc.)"""
    from dccrg_tpu_torch import cuda_build
    from dccrg_tpu_torch.parallel import exec_cache

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ \"$1\" = -o ]; then "
                    "shift; : > \"$1\"; fi\n  shift\ndone\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    r0 = tobs.metrics.counter_value("epoch.recompiles", kernel="gol")
    n0 = tobs.metrics.report()["phases"].get("compile", {}).get("count", 0)
    t0 = exec_cache.trace_counts().get("gol", 0)
    cuda_build.build(["gol"])
    cuda_build.build(["gol"])
    assert tobs.metrics.counter_value("epoch.recompiles", kernel="gol") == r0 + 1
    assert tobs.metrics.report()["phases"]["compile"]["count"] == n0 + 1
    assert exec_cache.trace_counts()["gol"] == t0 + 1
