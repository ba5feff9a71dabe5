"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in bfloat16 in the program's place) and each fault a
cell can have, planted in the program underneath a whole run."""
import time

import numpy as np
import pytest
import torch

from portbench import load, run
from portbench.reference.advection import Reference

CELLS = ["adv_uniform_512.run100", "adv_amr_48.run2000", "adv_amr_128.step20"]


def _limits_failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, cell):
    bench = load.benchmark(tiny)
    w = load.workload(bench, cell)
    cfg, traffic = load.config(w["config"], tiny), load.traffic(w["traffic"], tiny)
    limits = load.limits(cell, tiny)
    ref = Reference(cfg)
    inp = ref.inputs(9)
    pairs = [(inp["density"], None)]
    got = ref.control("cpu", pairs, traffic, torch.bfloat16)
    assert [k for k in got if got[k] > limits[k]], got


def _broken(kind):
    from dccrg_tpu_torch import Advection

    run_, step_, dt_ = Advection.run, Advection.step, Advection.max_time_step

    def spoil(old, new):
        if kind == "unchanged":
            return old
        d0, d1 = old["density"], new["density"].clone()
        if kind == "half_left_out":
            d1.view(-1)[::2] = d0.reshape(-1)[::2]
        elif kind == "one_altered":
            i = int(torch.argmax(d1))
            d1.view(-1)[i] = d1.reshape(-1)[i] * 1.1
        return {**new, "density": d1}

    def run_b(self, state, steps, dt):
        return spoil(state, run_(self, state, steps, dt))

    def step_b(self, state, dt):
        return spoil(state, step_(self, state, dt))

    def dt_b(self, state):
        return dt_(self, state) * (1.0001 if kind == "dt_altered" else 1.0)

    return run_b, step_b, dt_b


@pytest.mark.parametrize("kind", ["unchanged", "half_left_out", "one_altered",
                                  "dt_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_underneath_a_run_is_not_correct(tiny, monkeypatch, cell, kind):
    from dccrg_tpu_torch import Advection

    run_b, step_b, dt_b = _broken(kind)
    monkeypatch.setattr(Advection, "run", run_b)
    monkeypatch.setattr(Advection, "step", step_b)
    monkeypatch.setattr(Advection, "max_time_step", dt_b)
    bench = load.benchmark(tiny)
    r = run.run_cell(bench, load.workload(bench, cell), 123, 0.2, False, "cpu",
                     time.perf_counter(), root=tiny, log=lambda m: None)
    assert r["correct"] is False and r["failed"] > 0
    assert _limits_failed(r["checks"])
