"""The port's crash and elastic soak harnesses
(``python -m dccrg_tpu_torch.resilience.soak``), one seed each at their
default sizes on the CPU: every child is a fresh interpreter that imports
only the port.

* crash: SIGKILLed attempts (injected at commit boundaries and by the
  parent at random times) resume from the lineage on 2, 1 and 4 slots and
  converge to the uninterrupted run (Game of Life exact, advection 1e-11);
* elastic: a watchdog-detected ``step.hang`` (warn -> rescale_down), an
  injected ``device.lost`` (exit 42) and in-process rescales converge to
  the fixed-slot run, and a second fresh process compiles nothing.  On the
  CPU no kernel library is ever built, so its ``epoch.recompiles`` is 0 by
  construction; on the card the same harness (``--device cuda``) holds it to
  0 with the libraries on disk.

The fleet's admission A/B (``soak.fleet_admission_ab``) runs its real
workers on the card; here its round and its verdict run on the fake fleet
of ``tests/test_torch_gateway.py`` (a worker process stub, the gateway's
``rates=`` seam and an injected wall clock), with the A/B's own chunk
rule, deadlines and submissions.
"""
import os
import sys

import pytest

from dccrg_tpu_torch.resilience import soak

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def test_crash_harness_one_seed(capsys):
    ok = soak.run_crash(0, 1, device="cpu")
    out = capsys.readouterr().out
    assert ok, out
    assert "crash seed 0: OK" in out


def test_elastic_harness_one_seed(capsys):
    ok = soak.run_elastic(0, 1, device="cpu")
    out = capsys.readouterr().out
    assert ok, out
    assert "fault=step.hang: rescale_down" in out
    assert "fault=device.lost: exited rc=42" in out
    assert "warm start recompiles=0" in out


def test_child_asked_for_cuda_does_not_run_on_the_cpu(tmp_path):
    """Where there is no CUDA, a child told to run on it fails; the harness
    reports the failure instead of carrying on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p, log = soak._launch(str(tmp_path), "crash-child",
                          [str(tmp_path), 0, 1, 3, 3, "cuda"])
    assert p.wait(timeout=120) != 0
    log.close()
    assert "CUDA is not available" in (tmp_path / "child.log").read_text()


# ------------------------------------------------ the admission A/B's logic

def _fake_ab_round(tmp_path, monkeypatch, admission, rate=10.0):
    """One mode of the A/B on the fake fleet: a stub worker that serves
    every tenant at ``rate`` member-steps a second, one cohort a model a
    round of at most ``chunk`` steps, its rounds advancing the injected
    wall clock; the gateway's admission prices the burst at the same rate
    (``rates=``)."""
    from test_torch_gateway import fake_worker

    from dccrg_tpu_torch.serve import Gateway
    from dccrg_tpu_torch.serve.gateway import _append_jsonl

    monkeypatch.setenv("DCCRG_GATEWAY_ADMISSION", "1" if admission else "0")
    monkeypatch.delenv("DCCRG_SLO_QUEUE_S", raising=False)
    chunk = soak.admission_ab_chunk(rate)
    clock = [1000.0]
    w = fake_worker(tmp_path, "w0")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w], rates=lambda t: rate,
                 wall=lambda: clock[0])

    def drive(sids):
        gw.tick(restart_lost=False)
        live = [s for s in gw.journal.accepted if s not in gw.journal.retired]
        by_model = {}
        for sid in live:
            spec = gw.journal.accepted[sid]
            by_model.setdefault(spec["model"], []).append(int(spec["steps"]))
        # one ensemble round: each model's cohort steps min(chunk, left)
        clock[0] += sum(min(chunk, max(steps)) for steps in by_model.values()) / rate
        for sid in sids:
            _append_jsonl(w.outbox, {"ev": "retired", "sid": sid,
                                     "step": gw.journal.accepted[sid]["steps"]})
        gw.poll_outboxes()
        return set(sids) <= gw.journal.retired

    try:
        return soak.admission_ab_round(gw, drive, chunk), chunk
    finally:
        gw.close()


def test_admission_ab_on_the_fake_fleet(tmp_path, monkeypatch):
    """Admission on: the burst (2 x chunk steps, a 2 s budget) is priced
    late and rejected, the deadline tenant retires on time; off: the burst
    is admitted, the deadline tenant waits one burst round (3 of its 5 s
    deadlines) and misses.  The verdict passes, and flags each arm turned
    the other way."""
    on, chunk = _fake_ab_round(tmp_path / "on", monkeypatch, True)
    off, _ = _fake_ab_round(tmp_path / "off", monkeypatch, False)
    assert chunk == 150        # 3 x 5 s x 10 member-steps/s
    assert on == {"rejected": 4, "miss": 0, "ok": 1}
    assert off == {"rejected": 0, "miss": 1, "ok": 0}
    assert soak.admission_ab_verdict(on, off) == []
    assert len(soak.admission_ab_verdict(off, on)) == 4
    assert soak.admission_ab_verdict(None, off) == ["a mode failed to complete"]


@pytest.mark.parametrize("on,off,flag", [
    ({"rejected": 0, "miss": 0, "ok": 1}, {"rejected": 0, "miss": 1, "ok": 0}, "not enforcing"),
    ({"rejected": 2, "miss": 1, "ok": 0}, {"rejected": 0, "miss": 1, "ok": 0}, "missed"),
    ({"rejected": 2, "miss": 0, "ok": 1}, {"rejected": 1, "miss": 1, "ok": 0}, "ADMISSION=0"),
    ({"rejected": 2, "miss": 0, "ok": 1}, {"rejected": 0, "miss": 0, "ok": 1}, "starvation"),
])
def test_admission_ab_verdict_flags_each_failure(on, off, flag):
    fails = soak.admission_ab_verdict(on, off)
    assert len(fails) == 1 and flag in fails[0], fails


def test_admission_ab_chunk_needs_a_measured_rate():
    assert soak.admission_ab_chunk(1000.0) == 15000
    with pytest.raises(ValueError):
        soak.admission_ab_chunk(0.0)
