"""The port's device timeline (``obs.kineto`` + ``obs.merge``): the JAX
package's known-value merge cases (tests/test_trace_merge.py) replayed
through a hand-written Kineto trace, whose summary, gauges, host gaps and
merged Chrome trace must equal the JAX package's built from the same
intervals; a real CPU capture (host markers, clock syncs, the no-device
no-op); the kernel-symbol map held against the ``__global__`` names in
``csrc/``; and the symbol parsing of Kineto's kernel names."""
import json
import pathlib
import re

import pytest
import torch

from dccrg_tpu.obs import xplane as jxp
from dccrg_tpu.obs.events import EventTimeline as JTimeline
from dccrg_tpu.obs.merge import build_merged as j_build_merged
from dccrg_tpu.obs.registry import MetricsRegistry as JRegistry
from dccrg_tpu_torch import obs as tobs
from dccrg_tpu_torch.obs import kineto
from dccrg_tpu_torch.obs.events import EventTimeline
from dccrg_tpu_torch.obs.merge import (
    HALO_PHASE_PREFIX,
    ClockAlignment,
    build_merged,
    merge_profile,
    validate_merged_trace,
)
from dccrg_tpu_torch.obs.registry import MetricsRegistry
from dccrg_tpu_torch.ops import LAUNCHES
from dccrg_tpu_torch.parallel.exec_cache import KERNEL_SYMBOLS, kernel_labels

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: trace clock = host perf clock + this offset (ns), a whole microsecond
SKEW_NS = 5_000_000_000_000

#: the synthetic kernels: (Kineto name, symbol, label)
KERNELS = {
    "pad": ("void pad_kernel<float>(float*, int)", "pad_kernel", "pad.op"),
    "step": ("void (anonymous namespace)::model_step_kernel<float, 4>(Args)",
             "model_step_kernel", "model.step"),
    "halo": ("_Z18ring_gather_kernel6Fields", "ring_gather_kernel", "halo.ring_copy"),
}


def _us(tl, ms):
    """Trace microseconds of a point ``ms`` after the timeline origin,
    rounded to a whole microsecond so the Kineto JSON carries it
    exactly."""
    return float(round((tl.origin_perf * 1e9 + ms * 1e6 + SKEW_NS) / 1e3))


def _scenario(overlap_ms, halo_spans):
    """tests/test_trace_merge.py's constructed evidence: host halo window
    [10ms, 16ms] (start span [10,11], exchange span [15,16]), the device
    running interior compute [12ms, 12 + overlap_ms], a halo kernel
    [11.2ms, 11.5ms] and two edge kernels at 9 and 16.9 ms; plus three
    clock-sync beacons.  Returns (host spans, device kernels, beacons),
    times in ms after the origin."""
    host = [("halo.start", 10.0, 1.0), ("halo.exchange", 15.0, 1.0),
            ("epoch.build", 1.0, 2.0)] if halo_spans else [("epoch.build", 1.0, 2.0)]
    dev = [("pad", 9.0, 0.1), ("step", 12.0, overlap_ms),
           ("halo", 11.2, 0.3), ("pad", 16.9, 0.1)]
    beacons = [0.5, 0.75, 17.5]
    return host, [d for d in dev if d[2] > 0], beacons


def _kineto_json(path, tl, dev, beacons):
    """A Kineto trace of the scenario: kernel events on device 0 (two
    streams), the beacons as ``user_annotation`` events, plus events the
    ingest must leave alone (aten ops, a runtime call, a flow)."""
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for i, (kind, ms, dur) in enumerate(dev):
        events.append({"ph": "X", "cat": "kernel", "name": KERNELS[kind][0],
                       "pid": 0, "tid": 7 + (kind == "halo"),
                       "ts": _us(tl, ms), "dur": dur * 1e3,
                       "args": {"device": 0, "stream": 7 + (kind == "halo"),
                                "correlation": i}})
    for b in beacons:
        perf_ns = round(tl.origin_perf * 1e9 + b * 1e6)
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"{kineto.CLOCK_SYNC_TAG}:{perf_ns}", "pid": 1,
                       "tid": 1, "ts": float(round((perf_ns + SKEW_NS) / 1e3)),
                       "dur": 1.0})
    events += [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
         "ts": _us(tl, 12.0), "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
         "tid": 1, "ts": _us(tl, 11.9), "dur": 3.0},
        {"ph": "s", "cat": "ac2g", "name": "flow", "id": 1, "pid": 1, "tid": 1,
         "ts": _us(tl, 11.9)},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": 0}, f)


def _pair(overlap_ms, halo_spans, tmp_path):
    """The port's merge of the Kineto file and the JAX package's merge of
    the same intervals, each over its own timeline holding the same host
    spans."""
    host, dev, beacons = _scenario(overlap_ms, halo_spans)
    tl = EventTimeline(enabled=True)
    jtl = JTimeline(enabled=True)
    jtl.rebase(tl.origin_perf, tl.origin_wall)
    for name, ms, dur in host:
        tl.add(name, tl.origin_perf + ms * 1e-3, dur * 1e-3)
        jtl.add(name, tl.origin_perf + ms * 1e-3, dur * 1e-3)
    _kineto_json(tmp_path / "h_1.1.pt.trace.json", tl, dev, beacons)
    labels = {sym: lab for _name, sym, lab in KERNELS.values()}
    ing = kineto.ingest(str(tmp_path))
    merged = build_merged(ingest=ing, timeline=tl, kernel_labels=labels)
    # the JAX side: the same spans and beacons as an xplane ingest
    spans = [jxp.KernelSpan(KERNELS[k][0], KERNELS[k][1], _us(tl, ms) * 1e3, dur * 1e3 * 1e3)
             for k, ms, dur in dev]
    spans.sort(key=lambda s: s.start_ns)
    markers = [jxp.HostMarker(f"{jxp.CLOCK_SYNC_TAG}:{round(tl.origin_perf * 1e9 + b * 1e6)}",
                              float(round((round(tl.origin_perf * 1e9 + b * 1e6) + SKEW_NS)
                                          / 1e3)) * 1e3, 1e3) for b in beacons]
    jing = jxp.XIngest(["synthetic"], [jxp.ExecLine(0, "/device:CUDA:0", "device", spans)],
                       markers, ["kernel"])
    jmerged = j_build_merged(ingest=jing, timeline=jtl, kernel_labels=labels)
    return merged, jmerged, ing


def _without_identity(trace):
    """A merged Chrome trace without the host pid (each package's
    timeline export carries the same process's pid; the producer strings
    are the JAX package's in both)."""
    out = json.loads(json.dumps(trace))
    for e in out["traceEvents"]:
        e.pop("pid", None)
    out["otherData"].pop("host_pid", None)
    return out


@pytest.mark.parametrize("overlap_ms,halo_spans", [(2.0, True), (0.5, True), (3.9, True),
                                                   (0.0, True), (2.0, False)])
def test_known_value_merge_equals_jax(overlap_ms, halo_spans, tmp_path):
    merged, jmerged, ing = _pair(overlap_ms, halo_spans, tmp_path)
    assert ing.has_device_evidence and len(kineto.clock_syncs(ing)) == 3
    s, js = merged.summary(), jmerged.summary()
    assert s == js
    # the beacons carry whole microseconds: the fit is within one
    assert s["aligned"] and abs(s["alignment"]["offset_ns"] - SKEW_NS) < 1e3
    ov = s["overlap"]["halo"]
    if halo_spans:
        # in-flight window = [10, 16] ms; interior compute inside it
        assert ov["inflight_s"] == pytest.approx(6e-3, rel=1e-6)
        assert ov["overlap_s"] == pytest.approx(min(overlap_ms, 4.0) * 1e-3, rel=1e-6)
        assert ov["fraction"] == pytest.approx(min(overlap_ms, 4.0) / 6, abs=1e-6)
        assert ov["device_collective_s"] == pytest.approx(0.3e-3, rel=1e-6)
    else:
        assert ov["fraction"] is None
    # attribution under the labels, by symbol (the mangled halo name too)
    assert s["kernels"]["halo.ring_copy"]["count"] == 1
    assert s["kernels"]["pad.op"]["count"] == 2
    assert ("model.step" in s["kernels"]) == (overlap_ms > 0)
    assert merged.host_gaps(min_us=100.0) == jmerged.host_gaps(min_us=100.0)
    reg, jreg = MetricsRegistry(), JRegistry()
    merged.record_gauges(reg)
    jmerged.record_gauges(jreg)
    assert reg.report() == jreg.report()
    trace = merged.to_chrome()
    assert validate_merged_trace(trace) == []
    assert _without_identity(trace) == _without_identity(jmerged.to_chrome())
    assert _without_identity(merged.to_chrome(max_spans_per_device=1)) == \
        _without_identity(jmerged.to_chrome(max_spans_per_device=1))


def test_ingest_keeps_streams_and_leaves_host_work_alone(tmp_path):
    merged, _j, ing = _pair(2.0, True, tmp_path)
    (line,) = ing.exec_lines
    assert line.device_id == 0 and line.kind == "device"
    assert sorted({s.stream for s in line.spans}) == [7, 8]
    assert [s.module for s in line.spans] == ["pad_kernel", "ring_gather_kernel",
                                             "model_step_kernel", "pad_kernel"]
    # aten ops and runtime calls are host work: no span, no marker
    assert all(m.name.startswith(kineto.CLOCK_SYNC_TAG) for m in ing.markers)
    assert {"kernel", "user_annotation", "cpu_op", "cuda_runtime"} <= set(ing.plane_names)
    # the union of the two streams' intervals, not their sum
    assert line.busy_ns() == pytest.approx((0.1 + 2.0 + 0.3 + 0.1) * 1e6)
    s = merged.summary()
    assert s["devices"][0]["busy_s"] == pytest.approx(2.5e-3)


def test_opt_out_and_missing_capture(tmp_path, monkeypatch):
    _pair(2.0, True, tmp_path)
    monkeypatch.setenv("DCCRG_XPLANE", "0")
    ing = kineto.ingest(str(tmp_path))
    assert ing.paths == [] and not ing.has_device_evidence
    monkeypatch.delenv("DCCRG_XPLANE")
    empty = kineto.ingest(str(tmp_path / "nothing"))
    assert empty.exec_lines == [] and empty.markers == []
    merged = build_merged(ingest=empty, timeline=EventTimeline(), kernel_labels={})
    reg = MetricsRegistry()
    s = merged.record_gauges(reg)
    assert not s["device_evidence"] and not s["aligned"]
    assert reg.report()["gauges"] == {} and reg.report()["counters"] == {}


def test_real_cpu_capture(tmp_path):
    """A ``profile_trace`` capture on the CPU: the registry's phases appear
    as host markers (those opened after it do not), both ends' clock syncs
    are found, and there is no device line (the CPU's aten ops are not
    promoted to one) — the documented no-op, with no gauge recorded."""
    log_dir = tmp_path / "prof"
    tobs.timeline.clear()     # the port's timeline: bounded, shared by the worker
    with tobs.profile_trace(str(log_dir)) as prof:
        with tobs.metrics.phase("probe.phase"):
            x = torch.arange(4096, dtype=torch.float32)
            y = (x * 2.0).sum()
    with tobs.metrics.phase("probe.after"):
        pass
    assert float(y) > 0
    assert prof is not None
    files = kineto.find_trace_files(str(log_dir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    ing = kineto.ingest(str(log_dir))
    names = [m.name for m in ing.markers]
    assert "probe.phase" in names and "probe.after" not in names
    syncs = kineto.clock_syncs(ing)
    assert len(syncs) >= 2
    assert not ing.has_device_evidence and ing.exec_lines == []
    reg = MetricsRegistry()
    merged, summary = merge_profile(str(log_dir), registry=reg,
                                    out_path=str(tmp_path / "merged.json"))
    assert summary["aligned"] and not summary["device_evidence"]
    rep = reg.report()
    assert rep["gauges"] == {} and {"xplane.ingest", "trace.merge"} <= set(rep["phases"])
    assert validate_merged_trace(str(tmp_path / "merged.json")) == []
    # the post-hoc form: the host track rebuilt from the capture's markers
    post = tobs.build_from_capture(str(log_dir))
    assert any(s["name"] == "probe.phase" for s in post.host_spans)
    # the fitted offset places the phase marker near its host span
    fit = ClockAlignment.from_syncs(syncs)
    marker = next(m for m in ing.markers if m.name == "probe.phase")
    (span,) = [s for s in tobs.timeline.spans() if s["name"] == "probe.phase"]
    assert abs(fit.to_perf_s(marker.start_ns) - span["begin"]) < 0.05


def _global_symbols():
    """``__global__`` function names in ``csrc/*.cu``: the identifier
    before the parameter list, past ``void`` and a ``__launch_bounds__``
    clause (whose arguments may nest parentheses)."""
    out = {}
    for path in sorted((ROOT / "dccrg_tpu_torch" / "csrc").glob("*.cu")):
        src = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+", src):
            i = m.end()
            if src.startswith("__launch_bounds__", i):
                i = src.index("(", i)
                depth = 0
                while True:
                    depth += {"(": 1, ")": -1}.get(src[i], 0)
                    i += 1
                    if depth == 0:
                        break
            out[re.match(r"\s*(\w+)\s*\(", src[i:]).group(1)] = path.name
    return out


def test_kernel_symbol_map_matches_sources():
    """Every kernel in ``csrc/`` has an attribution label, every label
    names a wrapper of ``ops.LAUNCHES`` (B9's under the halo prefix, so the
    merge counts it as halo work), and every wrapper has a kernel.  A
    renamed kernel fails here."""
    syms = _global_symbols()
    assert set(syms) == set(KERNEL_SYMBOLS), (sorted(syms), sorted(KERNEL_SYMBOLS))
    assert kernel_labels() == KERNEL_SYMBOLS
    labels = set(KERNEL_SYMBOLS.values())
    assert labels <= set(LAUNCHES) | {"halo.ring_copy"}
    assert KERNEL_SYMBOLS["ring_gather_kernel"].startswith(HALO_PHASE_PREFIX)
    assert syms["ring_gather_kernel"] == "halo_dma.cu"
    # flux_update_blocked launches the same kernel as flux_update
    assert {k for k in LAUNCHES if k != "ring_copy"} - labels == {"flux_update_blocked"}
    for sym, lab in KERNEL_SYMBOLS.items():
        if not lab.startswith(HALO_PHASE_PREFIX):
            assert not lab.startswith("halo"), lab


@pytest.mark.parametrize("name,symbol", [
    ("ring_gather_kernel", "ring_gather_kernel"),
    ("void ring_gather_kernel(Fields)", "ring_gather_kernel"),
    ("void flat_amr_run_kernel<1>(float const*, Weights, float const*)", "flat_amr_run_kernel"),
    ("void (anonymous namespace)::bicg_box_kernel<true>(Args)", "bicg_box_kernel"),
    ("void dccrg::detail::vlasov_tile_kernel<16>(float const*)", "vlasov_tile_kernel"),
    ("_Z19flat_amr_run_kernelILi1EEvPKf7Weights", "flat_amr_run_kernel"),
    ("_Z14gol_run_kernelPKfPfS1_S1_iii", "gol_run_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_symbol_parsing(name, symbol):
    assert kineto.kernel_symbol(name) == symbol


def test_labels_by_prefix(tmp_path):
    """A symbol that carries a suffix past the table's key still attributes
    to its wrapper (the longest key it starts with); an unknown symbol
    keeps its own name; copies and memsets keep the event name."""
    tl = EventTimeline(enabled=True)
    ing = kineto.XIngest(["x"], [kineto.ExecLine(0, "/device:CUDA:0", "device", [
        kineto.KernelSpan("a", "flat_ml_run_kernel_v2", 1e3, 5e3, 7),
        kineto.KernelSpan("b", "mystery_kernel", 7e3, 5e3, 7),
        kineto.KernelSpan("Memset (Device)", None, 13e3, 5e3, 7),
    ])], [], [])
    m = build_merged(ingest=ing, timeline=tl, alignment=ClockAlignment(0.0),
                     kernel_labels=kernel_labels())
    assert [s["label"] for s in m.device_lines[0]["spans"]] == [
        "flat_ml_run", "mystery_kernel", "Memset (Device)"]
