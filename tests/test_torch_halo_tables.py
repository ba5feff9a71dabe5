"""The halo's grouped gather (kernel B9) and its per-epoch tables, on the CPU.

Each schedule builds two int32 tables over all ``D * R`` rows beside its
ring tables: ``full`` (the blocking exchange's gather) and ``merge`` (the
split exchange's merge of a payload).  On CPU tensors ``ring_gather`` runs
its plain twin, so these tests hold the tables, the twin, the one-gather
protocol and the models' split steps; the kernel itself is held against the
twin on the card by ``chip_smoke.py``.

Tolerances: exchanges exact (bytes, by cell id against the JAX package,
every row against the collective backend); split steps bitwise equal to
the port's eager steps.
"""
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import dccrg_tpu_torch
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS
from dccrg_tpu_torch.parallel import halo_dma

from test_torch_halo import _by_id
from test_torch_halo_backends import (SPEC_IDS, SPECS, _policy_grid, both, even_cells_only,
                                      make_grid, rand_state)

REFINED = dict(length=(8, 8, 8), max_ref=1, refine_ball=0.3, periodic=True)


def _ghost_rows(g, keep=lambda cell: True):
    """Flat rows ``d * R + row`` of the ghost rows whose cell ``keep``s."""
    ep = g.epoch
    return sorted(d * ep.R + int(ep.n_local[d]) + k
                  for d in range(g.n_devices) for k, pos in enumerate(ep.ghost_pos[d])
                  if keep(int(ep.leaves.cells[pos])))


# ------------------------------------------------------------- the tables


@pytest.mark.parametrize("policy", [None, even_cells_only], ids=["all", "policy"])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_tables_follow_the_ring(monkeypatch, n_dev, policy):
    """``full`` maps every refreshed ghost row to its owner's flat row and
    every other row to itself; ``merge`` maps the same rows to their payload
    slot and the others to -1; pad slots enter neither, so the scratch row
    keeps its own value.  Under a ``cell_datatype`` policy the filtered
    schedule refreshes only the selected ghost rows."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch, n_dev=n_dev, **REFINED)
    ex = g.halo(None, cell_datatype=policy)
    rings = ex._rings_for_field("rho")
    D, R = g.n_devices, g.epoch.R
    if n_dev == 1:
        assert not rings.ks and rings.full is None and rings.merge is None
        assert rings.send.numel() == 0
        return
    assert len(rings.ks) >= 2, "want a multi-ring schedule"
    send, recv = rings.send.numpy(), rings.recv.numpy()
    full, merge = rings.full.numpy(), rings.merge.numpy()
    assert full.dtype == merge.dtype == send.dtype == np.int32
    assert full.shape == merge.shape == (D * R,)
    real = np.flatnonzero(recv % R != R - 1)
    assert len(real) == rings.cells < len(send) == rings.wire
    rows = recv[real]
    assert len(np.unique(rows)) == len(rows)          # one owner a ghost row
    want = _ghost_rows(g) if policy is None else _ghost_rows(g, lambda c: c % 2 == 0)
    assert sorted(rows.tolist()) == want
    np.testing.assert_array_equal(full[rows], send[real])
    np.testing.assert_array_equal(merge[rows], real)
    rest = np.setdiff1d(np.arange(D * R), rows)
    np.testing.assert_array_equal(full[rest], rest)
    assert (merge[rest] == -1).all()
    # pads ship the sender's scratch row, and land nowhere
    pads = np.setdiff1d(np.arange(len(send)), real)
    assert len(pads) and (send[pads] % R == R - 1).all()
    scratch = np.arange(D) * R + R - 1
    np.testing.assert_array_equal(full[scratch], scratch)
    assert (merge[scratch] == -1).all()
    # the owner's row holds the ghost's cell
    ids = g.epoch.cell_ids.reshape(-1)
    np.testing.assert_array_equal(ids[full[rows]], ids[rows])


def test_ring_max_fields_matches_the_kernel():
    """The wrapper splits a launch where the kernel's parameter block ends;
    the kernel's rows a thread are forms it has, and its grid is one wave
    or a positive cap."""
    src = (pathlib.Path(dccrg_tpu_torch.__file__).parent / "csrc/halo_dma.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kMaxFields"] == halo_dma.RING_MAX_FIELDS
    assert const["kRowsPayload"] in (1, 2, 4, 8) and const["kRowsOwn"] in (1, 2, 4, 8)
    assert const["kRunBytes"] in (16, 32, 64) and const["kMaxCtas"] >= 0


# ------------------------------------------------------ the grouped twin


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy() if t.dtype != torch.bool \
        else t.contiguous().to(torch.uint8).numpy()


@pytest.mark.parametrize("n_jobs", [1, 5, 11])
def test_grouped_twin_mixed_dtypes(n_jobs):
    """One twin call gathers every job, whatever its dtype and row shape:
    ``(x, table)`` is the flat gather, ``(x, table, payload)`` the merge
    (payload rows where the entry is >= 0, x's rows elsewhere)."""
    rng = np.random.default_rng(11)
    kinds = [(torch.float64, ()), (torch.float32, (3,)), (torch.uint32, ()),
             (torch.uint8, ()), (torch.float16, (3,)), (torch.bool, ()),
             (torch.bfloat16, (2,)), (torch.int16, (1,)), (torch.int8, (2, 2)),
             (torch.uint16, (5,)), (torch.int64, ())]
    D, R, jobs, want = 3, 7, [], []
    for j in range(n_jobs):
        dtype, row = kinds[j % len(kinds)]
        nbytes = math.prod(row) * dtype.itemsize
        raw = rng.integers(0, 256, (D, R, nbytes), dtype=np.uint8)
        x = torch.from_numpy(raw.copy()).view(dtype) if dtype != torch.bool else \
            torch.from_numpy(raw & 1).to(torch.bool)
        x = x.reshape((D, R) + row)
        flat = _bytes(x).reshape(D * R, -1)
        if j % 3 == 0:            # a payload: any rows, repeats allowed
            table = rng.integers(0, D * R, 9).astype(np.int32)
            jobs.append((x, torch.from_numpy(table)))
            want.append(flat[table])
        elif j % 3 == 1:          # a blocking gather: own rows but a few
            table = np.arange(D * R, dtype=np.int32)
            table[[2, 9, 15]] = [20, 0, 4]
            jobs.append((x, torch.from_numpy(table)))
            want.append(flat[table])
        else:                     # a merge of a 4-row payload
            table = np.full(D * R, -1, np.int32)
            table[[1, 8, 13, 19]] = [3, 0, 2, 0]
            p_raw = rng.integers(0, 256, (4, nbytes), dtype=np.uint8)
            p = torch.from_numpy(p_raw.copy()).view(dtype) if dtype != torch.bool else \
                torch.from_numpy(p_raw & 1).to(torch.bool)
            p = p.reshape((4,) + row)
            jobs.append((x, torch.from_numpy(table), p))
            want.append(np.where((table < 0)[:, None], flat,
                                 _bytes(p).reshape(4, -1)[np.maximum(table, 0)]))
    calls, launches = PLAIN_CALLS["ring_copy"], LAUNCHES["ring_copy"]
    got = halo_dma.ring_gather(jobs)
    assert PLAIN_CALLS["ring_copy"] == calls + 1 and LAUNCHES["ring_copy"] == launches
    for job, y, w in zip(jobs, got, want):
        x = job[0]
        assert y.dtype == x.dtype
        assert y.shape == (x.shape if len(job) == 3 else (job[1].numel(),) + x.shape[2:])
        np.testing.assert_array_equal(_bytes(y).reshape(len(w), -1), w)
    assert halo_dma.ring_gather([]) == []


# ------------------------------------- exchanges against the JAX package


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("backend", ["collective", "pallas"])
def test_split_exchange_matches_jax(monkeypatch, backend, spec):
    """start / finish (one grouped payload gather, one grouped merge) leave
    every local and ghost row equal to the JAX package's exchange by cell id,
    and every row of the tensor equal to the blocking exchange's."""
    jg, pg = both(monkeypatch, backend=backend, n_dev=8, **REFINED)
    st = rand_state(pg, spec)
    h = pg.halo()
    merged = h.finish(st, h.start(st))
    want = jg.update_copies_of_remote_neighbors(rand_state(jg, spec))
    assert _by_id(pg, merged) == _by_id(jg, want)
    blocking = h(st)
    for name in spec:
        assert np.array_equal(_bytes(merged[name]), _bytes(blocking[name]))


# ------------------------------------------- the scratch row, pallas == collective


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_exchange_keeps_the_scratch_row(monkeypatch, spec):
    """With random bytes in every row (scratch row and unused pad rows
    included), the pallas exchange equals the collective one byte for byte,
    blocking and split; a row the schedule does not refresh keeps its
    value, the scratch row among them."""
    kw = dict(n_dev=8, **REFINED)
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "collective")
    hc = make_grid(dccrg_tpu_torch, **kw).halo()
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch, **kw)
    hp = g.halo()
    D, R = g.n_devices, g.epoch.R
    rng = np.random.default_rng(13)
    st = {}
    for name, (shape, dtype) in spec.items():
        itemsize = np.dtype(dtype).itemsize
        raw = rng.integers(0, 256, (D, R) + shape + (itemsize,), dtype=np.uint8)
        if dtype == np.bool_:
            raw &= 1
        st[name] = torch.from_numpy(raw.view(dtype).reshape((D, R) + shape))
    refreshed = np.zeros(D * R, bool)
    refreshed[_ghost_rows(g)] = True
    for got in (hp(st), hp.finish(st, hp.start(st))):
        want = hc(st)
        for name, x in st.items():
            assert np.array_equal(_bytes(got[name]), _bytes(want[name])), name
            rows_x = _bytes(x).reshape(D * R, -1)
            rows_y = _bytes(got[name]).reshape(D * R, -1)
            np.testing.assert_array_equal(rows_y[~refreshed], rows_x[~refreshed])
            assert (rows_y[refreshed] != rows_x[refreshed]).any()


# ---------------------------------------------------- one gather a step


@pytest.mark.parametrize("n_fields", [1, 3, 9])
def test_one_gather_a_protocol_step(monkeypatch, n_fields):
    """A blocking exchange is one grouped gather, start one and finish one,
    whatever the field count (above ``RING_MAX_FIELDS`` fields the kernel's
    wrapper splits the launch; the twin stays one call)."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch, n_dev=8, **REFINED)
    ex = g.halo()
    spec = {f"f{i}": (((), np.float64), ((3,), np.float32), ((), np.uint32))[i % 3]
            for i in range(n_fields)}
    st = rand_state(g, spec, seed=3)
    calls = []

    def spy(jobs):
        calls.append(len(jobs))
        return halo_dma.ring_gather_plain(jobs)

    monkeypatch.setattr(halo_dma, "ring_gather", spy)
    twins = PLAIN_CALLS["ring_copy"]
    out = ex(st)
    assert calls == [n_fields]
    handle = ex.start(st)
    assert calls == [n_fields] * 2
    merged = ex.finish(st, handle)
    assert calls == [n_fields] * 3
    assert PLAIN_CALLS["ring_copy"] == twins + 3
    for name in st:
        assert torch.equal(out[name], merged[name])


def test_policy_exchange_is_one_gather(monkeypatch):
    """Fields with their own filtered schedules still go out in one gather;
    a field the policy leaves without a ring is returned as it is."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = _policy_grid(dccrg_tpu_torch)
    st = g.new_state({"rho": ((), np.float64), "aux": ((), np.float64)}, fill=-1.0)

    def rho_only(field, cell_ids, sender, receiver, hood_id):
        return np.full(len(cell_ids), field == "rho")

    h = g.halo(None, cell_datatype=rho_only)
    calls = PLAIN_CALLS["ring_copy"]
    out = h(st)
    assert PLAIN_CALLS["ring_copy"] == calls + 1
    assert out["aux"] is st["aux"]
    handle = h.start(st)
    assert handle.payload["aux"] is None and handle.payload["rho"] is not None
    assert h.finish(st, handle)["aux"] is st["aux"]


# ------------------------------------------------------- the models


def _poison(g, state):
    """``state`` with every row that holds no cell (the scratch row and the
    unused pad rows) set to NaN (floats) or 1 (integers)."""
    ep = g.epoch
    used = torch.zeros(g.n_devices, ep.R, dtype=torch.bool)
    for d in range(g.n_devices):
        used[d, :int(ep.n_local[d] + ep.n_ghost[d])] = True
    out = {}
    for name, x in state.items():
        mask = used.view(used.shape + (1,) * (x.dim() - 2))
        bad = torch.full_like(x, float("nan") if x.is_floating_point() else 1)
        out[name] = torch.where(mask, x, bad)
    return out


def _models(g):
    """(label, eager model, split model, initial state, step) for the three
    models with a split step."""
    adv_e = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False)
    adv_s = dccrg_tpu_torch.Advection(g, dtype=np.float64, allow_dense=False, overlap=True)
    s = adv_e.initialize_state()
    dt = 0.4 * adv_e.max_time_step(s)
    vl_e = dccrg_tpu_torch.Vlasov(g, nv=2, dtype=np.float32)
    vl_s = dccrg_tpu_torch.Vlasov(g, nv=2, dtype=np.float32, overlap=True)
    dtv = np.float32(0.5 * vl_e.max_time_step())
    gol_e = dccrg_tpu_torch.GameOfLife(g, allow_dense=False)
    gol_s = dccrg_tpu_torch.GameOfLife(g, overlap=True)
    alive = g.get_cells()[::3]
    return [("advection", adv_e, adv_s, s, lambda m, x: m.step(x, dt)),
            ("vlasov", vl_e, vl_s, vl_e.initialize_state(), lambda m, x: m.step(x, dtv)),
            ("gol", gol_e, gol_s, gol_e.new_state(alive_cells=alive), lambda m, x: m.step(x))]


@pytest.mark.parametrize("n_dev", [3, 8])
def test_split_steps_equal_eager_and_ignore_the_scratch_row(monkeypatch, n_dev):
    """The split steps of Advection, Vlasov and the Game of Life equal their
    eager steps bitwise, and no model path reads a value from a row that
    holds no cell: with those rows poisoned (NaN, or 1 for the Game of
    Life's alive flags) every cell's value after three steps is the same, by
    cell id, as from the clean state, on both steps."""
    monkeypatch.setenv("DCCRG_HALO_BACKEND", "pallas")
    g = make_grid(dccrg_tpu_torch, n_dev=n_dev, **REFINED)
    for label, eager, split, s0, step in _models(g):
        assert split._exchange.backend == "pallas", label
        se, ss, sp = s0, s0, _poison(g, s0)
        for _ in range(3):
            se, ss, sp = step(eager, se), step(split, ss), step(split, sp)
            for name in se:
                assert torch.equal(se[name], ss[name]), (label, name)
        assert _by_id(g, sp) == _by_id(g, ss), label
        assert _by_id(g, step(eager, _poison(g, s0))) == _by_id(g, step(eager, s0)), label
