"""The port's device-timeline probe (``dccrg_tpu_torch/tools/
trace_report.py``) against the JAX package's (``tools/trace_report.py``):
``run_probe`` on the CPU for each ``--model`` under both halo backends (a
capture without device events: the documented no-op there), a record with
the tool's keys (the JAX tool's ``report_record`` run on the port's merged
trace), and the post-hoc and fleet modes of the command line."""
import importlib.util
import json
import pathlib

import pytest

from dccrg_tpu_torch.tools import trace_report as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ("advection", "advection-fused", "gol", "vlasov")


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
def jax_tr():
    spec = importlib.util.spec_from_file_location("jax_trace_report",
                                                  ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_backend(monkeypatch):
    """``run_probe`` sets DCCRG_HALO_BACKEND for its process; the default
    set here is what the test's end restores from."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "auto")


@pytest.mark.parametrize("backend", ["collective", "pallas"])
@pytest.mark.parametrize("model", MODELS)
def test_run_probe(model, backend, jax_tr, restore_backend):
    merged, summary = tr.run_probe(steps=3, model=model, halo_backend=backend,
                                   device="cpu")
    assert summary["device_evidence"] is False and summary["devices"] == {}
    assert summary["window_s"] > 0
    halo = summary["overlap"]["halo"]
    assert halo["inflight_s"] > 0    # the host track holds the halo windows
    rec = tr.report_record(merged, summary)
    want = jax_tr.report_record(merged, summary)
    assert rec.keys() == want.keys()
    assert {k: v for k, v in rec.items() if k != "top_kernels"} == \
        {k: v for k, v in want.items() if k != "top_kernels"}
    json.dumps(rec, default=float)


def test_cli_run_and_require_devices(capsys, restore_backend):
    assert tr.main(["--run", "--device", "cpu", "--steps", "2", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["device_evidence"] is False
    # absence of device events is an error only when asked for on the CPU
    assert tr.main(["--run", "--device", "cpu", "--steps", "2",
                    "--require-devices"]) == 1
    assert "no device execution evidence" in capsys.readouterr().out


def test_cli_post_hoc_and_fleet(tmp_path, capsys):
    """A capture's log directory read after the fact, and two merged
    traces unified on their epoch-zero."""
    import numpy as np

    from dccrg_tpu_torch import obs
    from dccrg_tpu_torch.tools import check_telemetry as ct

    g, adv, state, dt = ct.build_workload("cpu")
    obs.enable_timeline()
    traces = []
    for i in range(2):
        log_dir = tmp_path / f"prof{i}"
        with obs.profile_trace(str(log_dir)):
            state = ct.drive_split(g, adv, state, dt, 2)
        merged = tmp_path / f"merged{i}.json"
        assert tr.main([str(log_dir), "--merged-out", str(merged), "--json"]) == 0
        rec = json.loads(capsys.readouterr().out)
        assert rec["device_evidence"] is False
        traces.append(str(merged))
    assert np.isfinite(adv.total_mass(state))
    fleet = tmp_path / "fleet.json"
    assert tr.main(["--fleet", *traces, "--merged-out", str(fleet), "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["valid"] and len(rec["sources"]) == 2
    assert obs.validate_merged_trace(str(fleet)) == []
