"""The device-direct ring transport (``DCCRG_TORCH_DIST_BACKEND=ipc``,
``parallel/ipc.py``) on the CPU: real OS processes, one controller each,
2 controllers x 4 slots and 3 x 2.

On CPU tensors an arena is a shared file mapping and B9's remote-write
form is its twin, so the whole protocol runs here: the arenas, their
placement by generation and parity, the tokens and acks over the gloo
group, the collective growth.  Every case of
``tests/torch_multiproc_worker.py::ipc_scenarios`` — the blocking and
split halo exchange of a mixed-dtype state (f64, f32 (3,), uint32), the
same for W = 3 member stacks through ``MemberExchange``, the controller
ring's planes (``HaloExtend.cross``, the member ring), the staged balance
rows, a rolled Poisson solve, the particles' two exchanges — must be
bitwise equal under ``ipc``, under gloo and on one controller of the same
slots.  The stress case (50 back-to-back exchanges whose payloads change
every generation, the last controller sleeping before each merge) must
find no torn or stale ghost row; the growth case (an epoch change, then a
field 128 f64 wide) must grow the arenas; ``ipc`` with no arena raises and
never carries on over gloo.

One controller of these slots is held against the JAX package by
``tests/test_torch_halo_backends.py``, ``tests/test_torch_split_spmd.py``
and ``tests/test_torch_models_spmd.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_multiproc_worker as W  # noqa: E402

CASES = ("halo", "ring", "member_ring", "staged", "poisson_rolled", "particles",
         "stress", "growth")


@pytest.fixture(scope="module", params=[(2, 4), (3, 2)],
                ids=["2proc_x4slots", "3proc_x2slots"])
def runs(request, tmp_path_factory):
    """Each transport's controllers' results, and one controller's."""
    from dccrg_tpu_torch.parallel import mesh

    nproc, per = request.param
    D = nproc * per

    def run(wd):
        return {"ipc": W.launch("ipc", nproc, D, wd, backend="ipc"),
                "gloo": W.launch("ipc", nproc, D, wd, backend="gloo"),
                "one": W.ipc_scenarios(mesh.SINGLE, nproc, D)}

    return W.shared_run(request, tmp_path_factory, f"transport_ipc_{nproc}x{per}", run)


@pytest.mark.parametrize("case", CASES)
def test_ipc_equals_gloo_and_one_controller(runs, case):
    """Bitwise: every slot's rows (ghost rows included) or every cell's
    values, on every controller, under both transports."""
    for r in runs["ipc"] + runs["gloo"]:
        assert r[case] == runs["one"][case], (r["transport"]["backend"], case)


def test_ipc_carried_every_payload(runs):
    """Under ``ipc`` every controller posted its batches through the arenas
    and left none in flight; no transport staged host bytes or
    synchronised a stream (these are CPU tensors, which gloo never stages
    either: on the card, ``chip_smoke.py`` phase 34 counts 0 under ipc)."""
    for r in runs["ipc"]:
        t = r["transport"]
        assert t["backend"] == "ipc" and t["batches"] > 0 and t["in_flight"] == 0, t
        assert t["staged"] == {"bytes": 0, "syncs": 0}, t
    assert {r["transport"]["backend"] for r in runs["gloo"]} == {"gloo"}


def test_stress_leaves_no_torn_or_stale_row(runs):
    """Invariants (a) and (b): 50 exchanges, every refreshed ghost row
    poisoned before and checked after each, a controller late to every
    merge."""
    for r in runs["ipc"] + runs["gloo"]:
        assert r["stress"]["torn_or_stale"] == 0
        assert r["transport"]["stress_rows_checked"] > 0


def test_arenas_grow_at_the_epoch_change(runs):
    """Invariant (d): the first exchange of the new schedule's wide field
    grows every controller's arena, to the same channel size."""
    grew = [r["transport"]["grew"] for r in runs["ipc"]]
    for before, after, cap in grew:
        assert after > before, grew
    assert len({tuple(g) for g in grew}) == 1, grew
    assert grew[0][2] > 64 << 10


def test_ipc_without_an_arena_raises(tmp_path):
    """An arena that cannot be made fails every controller's set-up; no
    controller carries on over gloo."""
    missing = str(tmp_path / "no_such_dir")
    with pytest.raises(RuntimeError) as err:
        W.launch("ring", 2, 4, str(tmp_path), backend="ipc", timeout_s=60,
                 env={"DCCRG_TORCH_IPC_DIR": missing})
    text = str(err.value)
    assert "arena" in text and "RESULT" not in text, text[-2000:]


def test_transport_refuses_ipc_without_an_arena():
    from dccrg_tpu_torch.parallel import mesh
    from dccrg_tpu_torch.parallel.transport import Transport

    assert "ipc" in mesh.BACKENDS
    with pytest.raises(RuntimeError, match="arena"):
        Transport(mesh.Controllers(0, 2, "ipc", torch.device("cpu")))


def test_unknown_backend_is_refused(monkeypatch):
    from dccrg_tpu_torch.parallel import mesh

    monkeypatch.setenv(mesh.ENV_BACKEND, "shm")
    with pytest.raises(ValueError, match="ipc"):
        mesh._env_backend()


def test_layout_aligns_rows_and_refuses_overflow():
    """A message lies at an offset aligned to lcm(16, row bytes) inside its
    channel and parity, so its rows are whole rows of the arena read as its
    dtype; a batch past the channel raises."""
    from dccrg_tpu_torch.parallel import ipc

    a = object.__new__(ipc.Arena)
    a.cap = 8192
    pos = a._layout(1, 1, [(10, 1), (36, 12), (2048, 2048), (8, 8)])
    assert pos[0] == 3 * 8192
    assert pos[1] % 48 == 0 and pos[1] >= pos[0] + 10
    assert pos[2] % 2048 == 0 and pos[2] >= pos[1] + 36
    assert pos[3] % 16 == 0 and pos[3] >= pos[2] + 2048 and pos[3] + 8 <= 4 * 8192
    assert ipc.channel_bound([(10, 1), (36, 12), (0, 4)]) == 10 + 16 + 36 + 48
    with pytest.raises(ipc.IpcError):
        a._layout(0, 0, [(8192, 1), (1, 1)])


@pytest.mark.parametrize("dtype,row", [(torch.float64, ()), (torch.float32, (3,)),
                                       (torch.int32, ()), (torch.uint8, (2048,))])
def test_ring_put_twin_writes_the_payload_rows(dtype, row):
    """B9's remote-write form on CPU tensors: each job's rows land in its own
    destination, bit for bit the payload gather's rows, one twin call for
    all jobs."""
    from dccrg_tpu_torch.ops import PLAIN_CALLS
    from dccrg_tpu_torch.parallel import halo_dma

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 250, (3, 7) + row).astype(np.uint8)).to(dtype)
    tables = [torch.from_numpy(rng.integers(0, 21, n).astype(np.int32)) for n in (5, 0, 9)]
    buf = torch.zeros((14 + 4,) + row, dtype=dtype)
    dsts = [buf[0:5], buf[5:5], buf[9:18]]
    calls = PLAIN_CALLS["ring_copy"]
    halo_dma.ring_put([(x, t, d) for t, d in zip(tables, dsts)])
    assert PLAIN_CALLS["ring_copy"] == calls + 1
    for t, d in zip(tables, dsts):
        (want,) = halo_dma.ring_gather_plain([(x, t)])
        assert torch.equal(d, want)
    assert not buf[5:9].any()


def test_killed_run_relaunches_under_ipc(tmp_path):
    """Invariant (e): the lineage run killed on controller 1 after its second
    commit leaves no arena behind (each arena's file is unlinked once its
    peers have mapped it), and the relaunch from ``latest_valid`` over
    fresh arenas ends bitwise equal to one controller's uninterrupted run."""
    from dccrg_tpu_torch.parallel import mesh

    arenas = tmp_path / "arenas"
    arenas.mkdir()
    env = {"DCCRG_TORCH_IPC_DIR": str(arenas)}
    with pytest.raises(RuntimeError, match="controller 1 exited with -9"):
        W.launch("kill", 2, 8, str(tmp_path), backend="ipc", env=env)
    assert not list(arenas.iterdir())
    resumed = W.launch("resume", 2, 8, str(tmp_path), backend="ipc", env=env)
    assert not list(arenas.iterdir())
    one = W.lineage_run(mesh.SINGLE, 8, str(tmp_path / "one"), "one")
    for r in resumed:
        assert r["resumed_gen"] == 2 and r["density"] == one["density"]
