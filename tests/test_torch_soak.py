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
"""
import pytest

from dccrg_tpu_torch.resilience import soak


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
