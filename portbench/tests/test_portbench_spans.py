"""The per-layer metrics read from the program's own spans and counters
(``portbench/spans.py``): a traced run of each tiny cell on the CPU reports
them, ``flat_prep_ms_per_chunk`` takes the untraced chunks only, and with
the program's telemetry off every one of them is left out."""
import json
import os
import subprocess
import sys
import time
import types

import pytest

from conftest import REPO, tiny_tree

from portbench import load, run, spans

NEW = {
    "adv_uniform_512.run100": ["host_reads_per_chunk", "h2d_bytes_per_chunk",
                               "grid_init_s", "model_init_s"],
    "adv_amr_48.run2000": ["host_reads_per_chunk.cached", "h2d_bytes_per_chunk.cached",
                           "flat_prep_ms_per_chunk", "grid_init_s", "model_init_s"],
    "adv_amr_128.step20": ["host_reads_per_chunk", "h2d_bytes_per_chunk",
                           "grid_init_s", "model_init_s"],
}
#: blocking reads a chunk: the dense ``dt`` reads one a dimension, the row
#: layout's one in all; the steps read nothing
READS = {"adv_uniform_512.run100": 3, "adv_amr_48.run2000": 1, "adv_amr_128.step20": 1}


def _fresh_telemetry():
    """A run is a process of its own: here, where the cells share one, the
    program's registry and timeline start empty for each."""
    from dccrg_tpu_torch import obs

    obs.metrics.reset()
    obs.timeline.clear()
    return obs


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_program_metrics(tiny, cell):
    obs = _fresh_telemetry()
    bench = load.benchmark(tiny)
    # past the traced window's seconds, so that some chunks run untraced
    r = run.run_cell(bench, load.workload(bench, cell), 2**31 + 5, run.TRACE_S + 0.2,
                     True, "cpu", time.perf_counter(), root=tiny, log=lambda m: None)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW[cell]) <= set(m)
    for name in NEW[cell]:
        entry = next(e for e in bench["per_layer"] if e["name"] == name)
        assert load.applies(entry, cell, bench) and r["metrics"][name]["unit"] == entry["unit"]
    reads = m.get("host_reads_per_chunk", m.get("host_reads_per_chunk.cached"))
    assert reads == READS[cell]
    h2d = m.get("h2d_bytes_per_chunk", m.get("h2d_bytes_per_chunk.cached"))
    if cell == "adv_uniform_512.run100":
        assert h2d == 3 * 4          # the cell length of each dimension, float32
    elif cell == "adv_amr_128.step20":
        assert h2d == 0
    else:                            # the flat weights' leaf mask, a byte a voxel
        rep = obs.metrics.report()["counters"]
        assert rep["advection.h2d_bytes"] == {"site=flat.weights": h2d * (r["attempted"] + 1)}
        assert 0 < m["flat_prep_ms_per_chunk"] <= m["dispatch_ms_per_chunk.cached"]
    assert 0 < m["grid_init_s"] < m["grid_build_s"]
    assert m["model_init_s"] > 0


def _ctx(traced):
    return types.SimpleNamespace(chunks=[{"traced": t} for t in traced])


def test_flat_prep_takes_the_untraced_chunks_only(monkeypatch):
    """Chunk spans split the timeline: the warm-up's spans and the traced
    chunks' are left out of the mean; a chunk without its flat spans, or
    another number of chunk spans, reads nothing."""
    from dccrg_tpu_torch import obs

    tl = obs.EventTimeline()
    monkeypatch.setattr(obs, "timeline", tl)
    monkeypatch.setattr(obs.metrics, "enabled", True)
    reader = load.reader("flat_prep_ms_per_chunk")
    # warm-up, two untraced chunks (1 + 2 ms, then 3 + 4 ms), a traced one (100 ms)
    t = 100.0
    for inputs, wb in ((50e-3, 50e-3), (1e-3, 2e-3), (3e-3, 4e-3), (0.1, 0.1)):
        tl.add(spans.CHUNK_SPAN, t, 1e-4)
        tl.add("advection.run", t + 1e-3, 0.5)
        tl.add("advection.flat.inputs", t + 2e-3, inputs)
        tl.add("advection.flat.launch", t + 0.2, 1e-3)
        tl.add("advection.flat.write_back", t + 0.3, wb)
        t += 1.0
    assert reader(_ctx([False, False, True])) == pytest.approx(5.0)
    assert reader(_ctx([False, False, False, True])) is None
    tl.add("advection.max_time_step", t, 1e-4)
    assert reader(_ctx([False, False, True, False])) is None


def test_telemetry_off_leaves_the_program_metrics_out(tmp_path):
    root = tiny_tree(tmp_path)
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from portbench import load, run\n"
        f"root = {str(root)!r}\n"
        "bench = load.benchmark(root)\n"
        "r = run.run_cell(bench, load.workload(bench, 'adv_amr_48.run2000'), 3, 0.2, True,\n"
        "                 'cpu', time.perf_counter(), root=root, log=lambda m: None)\n"
        "from dccrg_tpu_torch import obs\n"
        "print(json.dumps({'metrics': sorted(r['metrics']), 'report': obs.metrics.report(),\n"
        "                  'timeline': len(obs.timeline)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "DCCRG_TELEMETRY": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "grid_build_s" in got["metrics"]
    assert not set(got["metrics"]) & set(NEW["adv_amr_48.run2000"])
    assert got["report"] == {"phases": {}, "counters": {}, "gauges": {}, "histograms": {}}
    assert got["timeline"] == 0
