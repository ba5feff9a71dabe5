"""The port's telemetry gate (``dccrg_tpu_torch/tools/check_telemetry.py``)
against the JAX package's (``tools/check_telemetry.py``): the gate passes
on the CPU with the parameters of ``tests/test_obs.py``'s
``test_check_telemetry_tool``, its required series are the tool's, its
validators give the tool's verdicts on the same files, and its entry point
asked for CUDA where there is none fails and says so."""
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from dccrg_tpu_torch.tools import check_telemetry as ct

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _timeline_as_found():
    """The gate and the probe enable the process's event timeline; the
    other tests on this worker export it, so this module leaves it as it
    found it."""
    from dccrg_tpu_torch import obs

    was = obs.timeline.enabled
    yield
    obs.timeline.enabled = was
    if not was:
        obs.timeline.clear()


@pytest.fixture(scope="module")
def jax_ct():
    spec = importlib.util.spec_from_file_location("jax_check_telemetry",
                                                  ROOT / "tools" / "check_telemetry.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """A good stream and a good Chrome trace of the port's exporters: a
    few snapshots around halo exchanges on a small grid, and the
    timeline's spans."""
    import numpy as np

    import dccrg_tpu_torch as P
    from dccrg_tpu_torch import obs

    d = tmp_path_factory.mktemp("files")
    obs.enable()
    obs.enable_timeline()
    g = (P.Grid().set_initial_length((4, 4, 4)).set_neighborhood_length(1)
         .initialize(n_devices=2, device="cpu"))
    state = g.new_state({"v": ((), np.float32)})
    s = obs.TelemetryStream(str(d / "t.stream.jsonl"), period=3600.0, truncate=True)
    for i in range(4):
        with obs.timeline.context(step=i):
            state = g.update_copies_of_remote_neighbors(state)
            h = g.start_remote_neighbor_copy_updates(state)
            state = g.wait_remote_neighbor_copy_updates(state, h)
        s.write_snapshot(step=i)
    s.stop(final=True)
    obs.export_chrome_trace(str(d / "t.trace.json"))
    return d / "t.stream.jsonl", d / "t.trace.json"


def test_gate_passes_on_the_cpu(tmp_path, jax_ct, monkeypatch):
    """``test_check_telemetry_tool``'s parameters: no failure, every
    required series present, and the side files valid by both packages'
    validators.  The fleet's workers and the live writers inherit one
    intra-op thread, as the gate's own process runs on the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    failures = ct.run_check(str(tmp_path / "telemetry.json"), steps=10, reps=3,
                            threshold=1.5, device="cpu")
    assert failures == []
    data = json.loads((tmp_path / "telemetry.json").read_text())
    phases, counters, hists = ct.required_series(torch.device("cpu"))
    for phase in phases:
        assert data["phases"][phase]["count"] >= 1, phase
    for name in counters:
        assert any(v > 0 for v in data["counters"][name].values()), name
    for name in hists:
        assert any(h["count"] > 0 for h in data["histograms"][name].values()), name
    assert set(data["launches_by_probe"]) >= {"workload", "fleet", "device_timeline"}
    stream = str(tmp_path / "telemetry.json.stream.jsonl")
    trace = str(tmp_path / "telemetry.json.trace.json")
    assert ct.validate_stream(stream) == jax_ct.validate_stream(stream) == []
    assert ct.validate_chrome_trace(trace) == jax_ct.validate_chrome_trace(trace) == []


def test_required_series_are_the_tools(jax_ct):
    assert ct.REQUIRED_PHASES == jax_ct.REQUIRED_PHASES
    assert ct.REQUIRED_NONZERO_COUNTERS == jax_ct.REQUIRED_NONZERO_COUNTERS
    assert ct.REQUIRED_HISTOGRAMS == jax_ct.REQUIRED_HISTOGRAMS
    assert ct.STREAM_REQUIRED_KEYS == jax_ct.STREAM_REQUIRED_KEYS
    # the card requires every series; the CPU all but the named compiles
    assert ct.required_series(torch.device("cuda")) == (
        ct.REQUIRED_PHASES, ct.REQUIRED_NONZERO_COUNTERS, ct.REQUIRED_HISTOGRAMS)
    cpu = ct.required_series(torch.device("cpu"))
    dropped = (set(ct.REQUIRED_PHASES) - set(cpu[0])) | (
        set(ct.REQUIRED_NONZERO_COUNTERS) - set(cpu[1]))
    assert dropped == set(ct.CPU_ABSENT) == {"compile", "epoch.recompiles"}


def _lines(path):
    return path.read_text().splitlines(keepends=True)


def _bad_streams(d, good):
    """Broken copies of a good stream: a torn tail, a seq repeated, a
    seq gap, ts going back, a counter decreasing, a missing key, a
    non-JSON line."""
    lines = _lines(good)
    recs = [json.loads(ln) for ln in lines]
    out = {}

    def write(name, text):
        p = d / f"{name}.stream.jsonl"
        p.write_text(text)
        out[name] = p

    write("torn", "".join(lines) + lines[-1][: len(lines[-1]) // 2])
    write("seq_repeat", "".join(lines + [lines[-1]]))
    gap = dict(recs[-1], seq=recs[-1]["seq"] + 3)
    write("seq_gap", "".join(lines) + json.dumps(gap) + "\n")
    back = dict(recs[-1], seq=recs[-1]["seq"] + 1, ts=recs[0]["ts"] - 1.0)
    write("ts_back", "".join(lines) + json.dumps(back) + "\n")
    dec = json.loads(lines[-1])
    dec["seq"] += 1
    name, series = next((n, s) for n, s in dec["counters"].items() if s)
    label = next(iter(series))
    series[label] = -1
    write("counter_down", "".join(lines) + json.dumps(dec) + "\n")
    miss = dict(recs[-1], seq=recs[-1]["seq"] + 1)
    del miss["gauges"]
    write("missing_key", "".join(lines) + json.dumps(miss) + "\n")
    write("not_json", "".join(lines) + "{not json}\n" + lines[-1])
    write("empty", "")
    return out


def test_validate_stream_verdicts(small_files, jax_ct, tmp_path):
    good = small_files[0]
    cases = {"good": good, **_bad_streams(tmp_path, good)}
    for name, path in cases.items():
        pc, jc = {}, {}
        got = ct.validate_stream(str(path), pc)
        want = jax_ct.validate_stream(str(path), jc)
        assert got == want and pc == jc, name
        assert bool(got) == (name not in ("good", "torn", "seq_gap")), (name, got)
    assert ct.validate_stream(str(tmp_path / "absent.jsonl")) == \
        jax_ct.validate_stream(str(tmp_path / "absent.jsonl"))


def test_validate_chrome_trace_verdicts(small_files, jax_ct, tmp_path):
    good = small_files[1]
    events = json.loads(good.read_text())["traceEvents"]
    b = next(ev for ev in events if ev.get("ph") == "B")
    cases = {"good": good}

    def write(name, evs):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"traceEvents": evs}))
        cases[name] = p

    write("unmatched_b", events + [dict(b, ts=events[-1].get("ts", 0) + 1.0)])
    write("stray_e", events + [dict(b, ph="E", tid=-7)])
    write("wrong_close", [dict(b, ts=1.0), dict(b, ph="E", name="other", ts=2.0)])
    write("ts_back", [dict(b, ts=5.0), dict(b, ph="E", ts=3.0)])
    write("bad_ts", [dict(b, ts=-1)])
    (tmp_path / "not_a_list.json").write_text(json.dumps({"traceEvents": 3}))
    cases["not_a_list"] = tmp_path / "not_a_list.json"
    for name, path in cases.items():
        got = ct.validate_chrome_trace(str(path))
        assert got == jax_ct.validate_chrome_trace(str(path)), name
        assert bool(got) == (name != "good"), (name, got)


def test_validate_cli(small_files, tmp_path):
    ok = ct.main(["--validate-stream", str(small_files[0]),
                  "--validate-trace", str(small_files[1])])
    assert ok == 0
    bad = tmp_path / "bad.stream.jsonl"
    bad.write_text("{}\n")
    assert ct.main(["--validate-stream", str(bad)]) == 1


def test_artifact_paths(tmp_path):
    out = str(tmp_path / "t.json")
    assert ct.artifact_path(out, ".trace.json") == str(tmp_path / "t.json.trace.json")
    assert ct.artifact_path(out, ".x", str(tmp_path / "a")) == str(tmp_path / "a" / "t.json.x")
    # the default --out stays off the JAX gate's root telemetry.json
    from dccrg_tpu_torch.tools import DEFAULT_TELEMETRY

    assert DEFAULT_TELEMETRY != ROOT / "telemetry.json"
    assert DEFAULT_TELEMETRY.parent.name in (ROOT / ".gitignore").read_text()


def test_compiled_labels_name_each_librarys_kernels():
    got = ct.compiled_labels({"kernel=halo_dma": 1, "kernel=dense_advection": 1,
                              "kernel=ipc": 1, "": 2})
    assert got == {"halo.ring_copy", "fused_run", "flux_update"}


@pytest.mark.parametrize("tool", ["check_telemetry", "trace_report"])
def test_entry_point_asked_for_cuda_without_it_fails(tool, tmp_path):
    """No silent CPU fallback: without a card the default (and an
    explicit ``--device cuda``) exit non-zero and say why."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = {"check_telemetry": ["--out", str(tmp_path / "t.json")],
            "trace_report": ["--run"]}[tool]
    for extra in ([], ["--device", "cuda"]):
        r = subprocess.run([sys.executable, "-m", f"dccrg_tpu_torch.tools.{tool}",
                            *args, *extra], capture_output=True, text=True, timeout=120,
                           cwd=ROOT)
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "t.json").exists()
