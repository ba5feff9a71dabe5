"""A run of each cell, at a tiny size on the CPU, prints the contract's
result; the command refuses to run without a card."""
import json
import subprocess
import sys
import time

import pytest

from conftest import REPO

from portbench import load, run

CELLS = ["adv_uniform_512.run100", "adv_amr_48.run2000", "adv_amr_128.step20"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace, seed=2**31 + 17, seconds=0.3):
    bench = load.benchmark(root)
    return bench, run.run_cell(bench, load.workload(bench, cell), seed, seconds,
                               trace, "cpu", time.perf_counter(), root=root,
                               log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_end_to_end_metrics(tiny, cell):
    bench, r = _run(tiny, cell, False)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                 if load.applies(m, cell, bench)}
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(r["checks"]) == {"density_gap_first", "density_gap_later", "dt_gap",
                                "leaf_mismatch"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_layer_metrics(tiny, cell):
    bench, r = _run(tiny, cell, True, seconds=0.2)
    names = {m["name"] for m in bench["per_layer"]}
    # on the CPU the trace has no device activity: only host readers answer
    assert set(r["metrics"]) <= names and "grid_build_s" in r["metrics"]
    assert "breakdown" in r and list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELLS[1],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_seeds_draw_inputs_not_work(tiny):
    """Two seeds give other densities on the same leaves, and a seed beyond
    32 bits works; the same seed gives the same inputs."""
    from portbench.reference.advection import Reference

    ref = Reference(load.config("adv_amr_48", tiny))
    a, b, c = ref.inputs(2**33 + 1), ref.inputs(5), ref.inputs(2**33 + 1)
    assert (a["ids"] == b["ids"]).all()
    assert (a["density"] == c["density"]).all()
    assert not (a["density"] == b["density"]).all()


def test_on_the_card(cuda_device):
    """The command end to end on the card (a short run2000 run)."""
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", CELLS[1],
                        "--seed", "7", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
