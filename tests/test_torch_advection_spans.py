"""The advection model's and the grid's spans and counters in the port's
registry (``obs.metrics``) and timeline (``obs.timeline``): which spans a
call records, how they nest, and what the host-read and host-to-device
counters add a call; and that a registry phase is an annotation of any
``torch.profiler`` capture that records at the time.

The port's registry and timeline are process-wide and shared by every test
of a worker: each test reads counter deltas and the spans that begin after
its own mark, on its own thread."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import dccrg_tpu_torch.obs as tobs
from dccrg_tpu_torch import Advection, CartesianGeometry, Grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the spans of a flat ``run`` inside ``advection.run``, in call order
FLAT = ["advection.record", "advection.flat.inputs", "advection.flat.launch",
        "advection.flat.write_back"]


def _grid(n=8, refine=True):
    g = Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
    g = g.set_periodic(True, True, True)
    if refine:
        g = g.set_maximum_refinement_level(1)
    g = g.set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
    g = g.initialize(device="cpu")
    if refine:
        ids = g.get_cells()
        r = np.linalg.norm(g.geometry.get_center(ids) - 0.5, axis=1)
        g.refine_completely_many(ids[r < 0.3])
        g.stop_refining()
    return g


def _counters():
    return {f"{n}{{{lab}}}": v for n, s in tobs.metrics.report()["counters"].items()
            if n.startswith("advection.") for lab, v in s.items()}


def _delta(before):
    after = _counters()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class _Spans:
    """The timeline spans of this thread that begin inside the block."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.counters = _counters()
        return self

    def __exit__(self, *exc):
        tid = threading.get_ident()
        self.spans = sorted((s for s in tobs.timeline.spans()
                             if s["begin"] >= self.t0 and s["tid"] == tid),
                            key=lambda s: s["begin"])
        self.delta = _delta(self.counters)
        return False

    def names(self):
        return [s["name"] for s in self.spans]

    def inside(self, outer):
        """The spans that nest inside span ``outer``, in order."""
        a, b = outer["begin"], outer["begin"] + outer["dur"]
        return [s["name"] for s in self.spans
                if s is not outer and a <= s["begin"] and s["begin"] + s["dur"] <= b]


@pytest.fixture
def telemetry_on():
    if not (tobs.metrics.enabled and tobs.timeline.enabled):
        pytest.skip("telemetry is off in this process (DCCRG_TELEMETRY / DCCRG_TIMELINE)")
    if tobs.timeline.summary()["recorded"] > tobs.timeline.max_events // 2:
        tobs.timeline.clear()     # bounded and shared by the worker: room for the test


def test_flat_run_records_nested_spans_and_counts(telemetry_on):
    g = _grid()
    adv = Advection(g, dtype=np.float32)
    assert adv._flat_kind == "pallas" and not adv._prefer_boxed
    s = adv.initialize_state()
    with _Spans() as sp:
        dt = 0.4 * adv.max_time_step(s)
        adv.run(s, 3, dt)
    assert sp.names() == ["advection.max_time_step", "advection.run", *FLAT]
    run = sp.spans[1]
    assert run["args"]["path"] == "flat"
    assert sp.inside(run) == FLAT
    assert sp.inside(sp.spans[0]) == []
    leaf = adv._flat_run.tables["leaf_fine"]
    assert sp.delta == {"advection.host_reads{site=max_time_step}": 1,
                        "advection.h2d_copies{site=flat.weights}": 1,
                        "advection.h2d_bytes{site=flat.weights}": leaf.nbytes}
    # self time: the run's duration less what its children cover
    kids = sum(x["dur"] for x in sp.spans[2:])
    assert 0 <= run["dur"] - kids <= run["dur"]


def test_dense_run_and_max_time_step_count_three_reads(telemetry_on):
    g = _grid(refine=False)
    adv = Advection(g, dtype=np.float32)
    assert adv.dense is not None
    s = adv.initialize_state()
    with _Spans() as sp:
        dt = 0.4 * adv.max_time_step(s)
    assert sp.names() == ["advection.max_time_step"]
    assert sp.delta == {"advection.host_reads{site=max_time_step}": 3,
                        "advection.h2d_copies{site=max_time_step}": 3,
                        "advection.h2d_bytes{site=max_time_step}": 3 * 4}
    with _Spans() as sp:
        adv.run(s, 2, dt)
    path = "fused" if adv.fused else "dense"
    assert sp.names() == ["advection.run", "advection.record"]
    assert sp.spans[0]["args"]["path"] == path
    assert sp.delta == {}


def test_gather_step_records_one_span_a_call_and_no_reads(telemetry_on):
    g = _grid()
    adv = Advection(g, dtype=np.float32, use_kernels=False)
    s = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(s)
    with _Spans() as sp:
        for _ in range(3):
            s = adv.step(s, dt)
    assert [n for n in sp.names() if n.startswith("advection.")] == ["advection.step"] * 3
    assert sp.delta == {}
    with _Spans() as sp:
        adv.run(s, 2, dt)
    assert [n for n in sp.names() if n.startswith("advection.")] == [
        "advection.run", "advection.record"]
    assert sp.spans[0]["args"]["path"] == "general"


def test_setup_spans_nest(telemetry_on):
    with _Spans() as sp:
        g = _grid()
        adv = Advection(g, dtype=np.float32)
        s = adv.initialize_state()
        adv.set_cell_data(s, "density", g.get_cells()[:4], 0.5)
    names = sp.names()
    for n in ("grid.initialize", "grid.partition", "grid.stop_refining",
              "advection.init", "advection.initialize_state",
              "advection.set_cell_data"):
        assert names.count(n) == 1, n
    by = {s["name"]: s for s in sp.spans}
    init = sp.inside(by["grid.initialize"])
    assert "grid.partition" in init and "epoch.build" in init
    assert "amr.refine" in sp.inside(by["grid.stop_refining"])
    assert sp.delta == {}


def test_phase_is_an_annotation_of_any_capture():
    """A registry phase inside a plain ``torch.profiler.profile`` is a
    ``user_annotation`` of its name; one opened with no profiler recording
    is not, and opens no annotation."""
    if not tobs.metrics.enabled:
        pytest.skip("telemetry is off in this process")
    from torch.autograd import profiler as ap

    with tobs.metrics.phase("probe.before"):
        assert not ap._is_profiler_enabled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.metrics.phase("probe.inside", {"k": 1}):
            torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert "probe.inside" in names and "probe.before" not in names


_DISABLED = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import dccrg_tpu_torch.obs as obs
from dccrg_tpu_torch import Advection, CartesianGeometry, Grid
g = (Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(0)
     .set_periodic(True, True, True).set_maximum_refinement_level(1)
     .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                   level_0_cell_length=(0.25,) * 3).initialize(device="cpu"))
g.refine_completely_many(g.get_cells()[:2]); g.stop_refining()
adv = Advection(g, dtype=np.float32)
s = adv.initialize_state()
s = adv.run(s, 2, 0.4 * adv.max_time_step(s))
s = adv.step(s, 0.4 * adv.max_time_step(s))
print(json.dumps({{"report": obs.metrics.report(), "timeline": len(obs.timeline),
                  "flat": adv._flat_kind}}))
"""


def test_telemetry_off_records_no_model_span_or_counter():
    env = {**os.environ, "DCCRG_TELEMETRY": "0"}
    out = subprocess.run([sys.executable, "-c", _DISABLED.format(root=ROOT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["flat"] == "pallas"
    assert got["report"] == {"phases": {}, "counters": {}, "gauges": {}, "histograms": {}}
    assert got["timeline"] == 0
