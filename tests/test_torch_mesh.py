"""The controllers' layer (``dccrg_tpu_torch/parallel/mesh.py``): slot
blocks in rank order, the transport's explicit choice, and the launcher's
hard timeout and failure handling (a failing or hung controller fails the
call quickly and leaves no process behind)."""
import sys
import time

import numpy as np
import pytest

from dccrg_tpu_torch.parallel import mesh


@pytest.mark.parametrize("P,D", [(1, 1), (1, 5), (2, 8), (3, 6), (4, 4)])
def test_slot_blocks_in_rank_order(P, D):
    blocks = [mesh.Controllers(rank=r, size=P).local_slots(D) for r in range(P)]
    assert [s for b in blocks for s in b] == list(range(D))
    assert len({len(b) for b in blocks}) == 1
    owner = mesh.Controllers(size=P).slot_owner(D)
    assert all((owner[list(b)] == r).all() for r, b in enumerate(blocks))


@pytest.mark.parametrize("P,D", [(2, 3), (3, 8), (4, 6)])
def test_slots_must_divide(P, D):
    with pytest.raises(ValueError, match="do not divide"):
        mesh.Controllers(rank=0, size=P).local_slots(D)


def test_grid_refuses_uneven_slots():
    from dccrg_tpu_torch import Grid

    with pytest.raises(ValueError, match="do not divide"):
        Grid().set_initial_length((4, 4, 1)).initialize(
            n_devices=3, device="cpu", controllers=mesh.Controllers(size=2))


def test_single_controller_default():
    from dccrg_tpu_torch import Grid

    assert mesh.current() is mesh.SINGLE and not mesh.SINGLE.multi
    g = Grid().set_initial_length((4, 4, 1)).initialize(n_devices=2, device="cpu")
    assert g.controllers is mesh.SINGLE and g.slots == range(2)
    assert g.new_state({"a": ((), np.float32)})["a"].shape[0] == 2


def test_backend_is_chosen_explicitly(monkeypatch):
    monkeypatch.setenv(mesh.ENV_BACKEND, "mpi")
    with pytest.raises(ValueError, match="expected one of"):
        mesh.setup()
    monkeypatch.delenv(mesh.ENV_BACKEND)
    with pytest.raises(ValueError, match="expected one of"):
        mesh.setup(backend="ucc")


def test_launch_results_in_rank_order():
    code = ("import os, json; print('noise'); "
            "print('RESULT ' + json.dumps({'rank': int(os.environ['RANK']), "
            "'size': int(os.environ['WORLD_SIZE'])}))")
    got = mesh.launch([sys.executable, "-c", code], 3, timeout_s=60)
    assert got == [{"rank": r, "size": 3} for r in range(3)]


def test_launch_failing_controller_raises():
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="controller 1 exited with 3"):
        mesh.launch([sys.executable, "-c", code], 2, timeout_s=60)
    assert time.monotonic() - t < 30


def test_launch_hard_timeout_kills():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="still running after"):
        mesh.launch([sys.executable, "-c", "import time; time.sleep(60)"], 2,
                    timeout_s=2)
    assert time.monotonic() - t < 30


def test_launch_missing_result_raises():
    with pytest.raises(RuntimeError, match="no RESULT line"):
        mesh.launch([sys.executable, "-c", "print('hello')"], 1, timeout_s=60)
