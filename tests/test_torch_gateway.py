"""The port's fleet gateway (``dccrg_tpu_torch/serve/gateway.py``), the
JAX package's ``tests/test_gateway.py`` case for case on the CPU: journal
torn-tail replay (cut at every record boundary and mid-record), CRC
corruption, snapshot compaction, enforced admission, exactly-once
retirement, worker-loss redispatch, gateway-crash recovery and the armed
cost plane's ``select_k`` charge, with the JAX tests' ``FakeProc``
workers.  The journal's on-disk format is the JAX package's: a journal
written by either package replays in the other, records byte for byte.
One real CPU worker process steps a scenario to retirement, and its park
equals the JAX package's solo result.  Counters are read as deltas."""
import json
import os
import time
import zlib

import numpy as np
import pytest

import dccrg_tpu.serve.gateway as JG
from dccrg_tpu_torch import CartesianGeometry, Grid, obs
from dccrg_tpu_torch.models import Advection
from dccrg_tpu_torch.obs import cost
from dccrg_tpu_torch.serve import Ensemble, Gateway, SubmissionJournal, WorkerHandle
from dccrg_tpu_torch.serve.gateway import _append_jsonl, _canon


@pytest.fixture(autouse=True)
def _fresh_state():
    cost.model.reset()
    cost.tracker.reset()
    yield
    cost.model.reset()
    cost.tracker.reset()


def counter_total(name: str) -> int:
    rep = obs.metrics.report()
    return int(sum(rep["counters"].get(name, {}).values()))


def rejected(reason: str) -> int:
    return int(obs.metrics.report()["counters"].get("gateway.rejected", {})
               .get(f"reason={reason}", 0))


# ------------------------------------------------------------- journal


#: a representative event tape covering every record type the gateway
#: journals (the cut sweep walks its byte stream)
EVENTS = [
    ("accepted", {"sid": "s0", "model": "gol", "seed": 0, "steps": 8,
                  "tenant": "a"}),
    ("assigned", {"sid": "s0", "worker": "w0"}),
    ("accepted", {"sid": "s1", "model": "advection", "seed": 1,
                  "steps": 6, "tenant": "b"}),
    ("watermark", {"sid": "s0", "step": 4, "park": "/tmp/p0"}),
    ("rejected", {"sid": "s2", "tenant": "a", "reason": "queue-full"}),
    ("redispatched", {"sid": "s0", "worker": "w1", "from_worker": "w0",
                      "step": 4}),
    ("retired", {"sid": "s0", "worker": "w1"}),
]


def _state_of(j: SubmissionJournal):
    return (dict(j.accepted), dict(j.assigned),
            {k: dict(v) for k, v in j.watermark.items()},
            set(j.retired), dict(j.rejected))


def _write_tape(path: str):
    """Append EVENTS, snapshotting the expected state after each record
    (tracked independently of replay, so the sweep's oracle is not the
    code under test)."""
    j = SubmissionJournal(path)
    expected = [_state_of(j)]
    for ev, fields in EVENTS:
        j.append(ev, **fields)
        expected.append(_state_of(j))
    j.close()
    return expected


def test_journal_replay_cut_at_every_boundary_and_midrecord(tmp_path):
    """The WAL cut at any byte: replay reconstructs exactly the state
    of the longest clean record prefix; a partial trailing record is a
    counted tear (``gateway.journal_torn``), never an exception."""
    path = str(tmp_path / "wal.jsonl")
    expected = _write_tape(path)
    raw = open(path, "rb").read()
    # record boundaries: byte offsets just after each newline
    bounds = [0]
    for i, b in enumerate(raw):
        if b == ord("\n"):
            bounds.append(i + 1)
    assert len(bounds) == len(EVENTS) + 1
    cut_path = str(tmp_path / "cut.jsonl")
    for n_rec, off in enumerate(bounds):
        # clean cut AT the boundary: exact prefix, no tear
        open(cut_path, "wb").write(raw[:off])
        jc = SubmissionJournal(cut_path)
        assert _state_of(jc) == expected[n_rec], f"boundary {n_rec}"
        assert jc.torn == 0, f"boundary {n_rec} counted a phantom tear"
        jc.close()
        os.unlink(cut_path)
        if n_rec == len(EVENTS):
            continue
        # torn cut mid-record: previous prefix + one counted tear
        mid = off + max(1, (bounds[n_rec + 1] - off) // 2)
        open(cut_path, "wb").write(raw[:mid])
        jc = SubmissionJournal(cut_path)
        assert _state_of(jc) == expected[n_rec], f"mid-record {n_rec}"
        assert jc.torn == 1, f"mid-record {n_rec} tear not counted"
        jc.close()
        os.unlink(cut_path)


def test_journal_crc_mismatch_ends_the_prefix(tmp_path):
    """A bit-flipped record (newline intact, CRC wrong) ends the
    authoritative prefix: later records are discarded, the tear is
    counted — a torn-then-reused disk region must not resurrect."""
    path = str(tmp_path / "wal.jsonl")
    expected = _write_tape(path)
    lines = open(path, "rb").read().splitlines(keepends=True)
    victim = 3
    rec = json.loads(lines[victim])
    rec["step"] = 999          # payload no longer matches the CRC
    lines[victim] = json.dumps(rec).encode() + b"\n"
    open(path, "wb").write(b"".join(lines))
    before = counter_total("gateway.journal_torn")
    j = SubmissionJournal(path)
    assert _state_of(j) == expected[victim]
    assert j.torn == 1
    assert counter_total("gateway.journal_torn") == before + 1
    j.close()


def test_journal_checkpoint_compacts_and_replays(tmp_path):
    """Snapshot + truncate, then more WAL records: a reopen replays
    snapshot state plus the suffix, and counts the replay."""
    path = str(tmp_path / "wal.jsonl")
    j = SubmissionJournal(path)
    for ev, fields in EVENTS[:4]:
        j.append(ev, **fields)
    j.checkpoint()
    assert os.path.getsize(path) == 0     # WAL compacted into snapshot
    for ev, fields in EVENTS[4:]:
        j.append(ev, **fields)
    full = _state_of(j)
    j.close()
    before = counter_total("gateway.journal_replays")
    j2 = SubmissionJournal(path)
    assert _state_of(j2) == full
    assert counter_total("gateway.journal_replays") == before + 1
    j2.close()
    # snapshot CRC is over canonical bytes: corrupting it is a tear,
    # and the WAL suffix still replays
    snap_path = path + SubmissionJournal.SNAPSHOT_SUFFIX
    snap = json.load(open(snap_path))
    snap["state"]["retired"] = ["forged"]
    json.dump(snap, open(snap_path, "w"))
    j3 = SubmissionJournal(path)
    assert j3.torn == 1
    assert "forged" not in j3.retired
    j3.close()


def test_journal_append_is_canonical_and_crc_stable(tmp_path):
    """Records are canonical JSON with a CRC over the sorted-key
    payload — byte-stable across processes, so replays re-verify."""
    path = str(tmp_path / "wal.jsonl")
    j = SubmissionJournal(path)
    j.append("accepted", sid="x", steps=3, tenant="t")
    j.close()
    rec = json.loads(open(path).read().strip())
    payload = {k: v for k, v in rec.items() if k != "crc"}
    assert rec["crc"] == zlib.crc32(_canon(payload))


# ------------------------------------------------- gateway (fake fleet)


class FakeProc:
    """A worker process stub: alive until killed/terminated."""

    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc

    def terminate(self):
        self.rc = 0


def fake_worker(tmp_path, wid: str) -> WorkerHandle:
    w = WorkerHandle(wid, str(tmp_path / wid), n_devices=1,
                     spawn=FakeProc)
    w.start()
    return w


def test_admission_queue_bound_and_predicted_late(tmp_path, monkeypatch):
    """The ENFORCED edge: a full queue rejects with ``queue-full``; an
    armed rate window rejects a submission whose predicted wait blows
    its own deadline budget with ``predicted-late``; decisions are
    journaled (idempotent under replay) and counted by reason."""
    monkeypatch.setenv("DCCRG_GATEWAY_QUEUE_MAX", "2")
    late0, full0 = rejected("predicted-late"), rejected("queue-full")
    w = fake_worker(tmp_path, "w0")
    # rate seam: 1 member-step per second for everyone
    gw = Gateway(str(tmp_path / "j.jsonl"), [w], rates=lambda t: 1.0)
    ok, r = gw.submit({"sid": "a0", "model": "gol", "steps": 5,
                       "tenant": "burst"})
    assert ok and r is None
    # 5 queued + 10 own steps at 1 step/s = 15 s wait > 3 s budget
    ok, r = gw.submit({"sid": "a1", "model": "gol", "steps": 10,
                       "tenant": "burst", "deadline_s": 3.0})
    assert (ok, r) == (False, "predicted-late")
    # generous budget passes the same arithmetic
    ok, r = gw.submit({"sid": "a2", "model": "gol", "steps": 10,
                       "tenant": "burst", "deadline_s": 60.0})
    assert ok
    # the queue bound is absolute — even an instant scenario bounces
    ok, r = gw.submit({"sid": "a3", "model": "gol", "steps": 1,
                       "tenant": "vip"})
    assert (ok, r) == (False, "queue-full")
    assert rejected("predicted-late") == late0 + 1
    assert rejected("queue-full") == full0 + 1
    # journaled decisions replay without re-deciding (or re-counting)
    assert gw.submit({"sid": "a1", "model": "gol", "steps": 10,
                      "tenant": "burst"}) == (False, "predicted-late")
    assert gw.submit({"sid": "a0", "model": "gol", "steps": 5,
                      "tenant": "burst"}) == (True, None)
    gw.close()


def test_admission_off_is_the_ab_baseline(tmp_path, monkeypatch):
    """``DCCRG_GATEWAY_ADMISSION=0``: predicted-late never fires (the
    starvation A/B's baseline arm); only the hard queue bound holds."""
    monkeypatch.setenv("DCCRG_GATEWAY_ADMISSION", "0")
    w = fake_worker(tmp_path, "w0")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w], rates=lambda t: 1.0)
    ok, r = gw.submit({"sid": "a0", "model": "gol", "steps": 10 ** 6,
                       "tenant": "burst", "deadline_s": 0.001})
    assert ok and r is None
    gw.close()


def test_exactly_once_retirement_dedupes_zombie_reports(tmp_path):
    """At-least-once stepping, exactly-once retirement: duplicate
    retire reports (a redispatched member's original worker coming
    back as a zombie) are counted, not double-retired."""
    w = fake_worker(tmp_path, "w0")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w])
    r0, d0 = counter_total("gateway.retired"), counter_total("gateway.retire_duplicates")
    ok0 = counter_total("gateway.deadline_ok")
    gw.submit({"sid": "s0", "model": "gol", "steps": 4, "tenant": "t",
               "deadline_s": 60.0})
    gw.tick(restart_lost=False)
    assert gw.journal.assigned == {"s0": "w0"}
    for _ in range(3):
        _append_jsonl(w.outbox, {"ev": "retired", "sid": "s0",
                                 "step": 4, "result": "/r0"})
    gw.poll_outboxes()
    assert gw.journal.retired == {"s0"}
    assert counter_total("gateway.retired") == r0 + 1
    assert counter_total("gateway.retire_duplicates") == d0 + 2
    assert counter_total("gateway.deadline_ok") == ok0 + 1
    gw.close()


def test_worker_loss_redispatches_from_watermark(tmp_path):
    """A dead worker's in-flight scenarios move to a survivor with the
    journaled watermark (step + park path) in the new assignment; the
    loss and each move are counted."""
    w0 = fake_worker(tmp_path, "w0")
    w1 = fake_worker(tmp_path, "w1")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w0, w1])
    lost0, red0 = counter_total("gateway.worker_lost"), counter_total("gateway.redispatched")
    gw.submit({"sid": "s0", "model": "gol", "steps": 10, "tenant": "t"})
    gw.submit({"sid": "s1", "model": "gol", "steps": 10, "tenant": "t"})
    gw.tick(restart_lost=False)
    assert sorted(gw.journal.assigned.values()) == ["w0", "w1"]
    (sid0,) = gw.journal.in_flight("w0")
    _append_jsonl(w0.outbox, {"ev": "watermark", "sid": sid0,
                              "step": 6, "park": "/park0",
                              "busy_s": 0.5})
    gw.poll_outboxes()
    w0.proc.rc = -9                      # SIGKILL
    gw.tick(restart_lost=False)
    assert w0.lost
    assert gw.journal.assigned[sid0] == "w1"
    assert gw.redispatches == [{"sid": sid0, "from": "w0", "to": "w1",
                                "step": 6}]
    # the survivor's inbox carries the resume point
    recs = [json.loads(ln) for ln in open(w1.inbox)]
    moved = [r for r in recs if r["sid"] == sid0]
    assert moved and moved[-1]["resume_step"] == 6
    assert moved[-1]["park"] == "/park0"
    assert counter_total("gateway.worker_lost") == lost0 + 1
    assert counter_total("gateway.redispatched") == red0 + 1
    gw.close()


def test_signature_affinity_routes_to_the_warm_worker(tmp_path):
    """A worker's ``started`` report binds its signature label; later
    same-signature submissions route to it while load allows."""
    w0 = fake_worker(tmp_path, "w0")
    w1 = fake_worker(tmp_path, "w1")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w0, w1])
    gw.submit({"sid": "s0", "model": "gol", "steps": 4, "tenant": "t"})
    gw.tick(restart_lost=False)
    owner = gw.journal.assigned["s0"]
    _append_jsonl(gw.workers[owner].outbox,
                  {"ev": "started", "sid": "s0", "sig": "SIG-A",
                   "step": 0})
    gw.poll_outboxes()
    gw.submit({"sid": "s1", "model": "gol", "steps": 4, "tenant": "t",
               "sig": "SIG-A"})
    gw.tick(restart_lost=False)
    assert gw.journal.assigned["s1"] == owner
    gw.close()


def test_gateway_crash_recovery_reroutes_unretired(tmp_path):
    """A fresh gateway incarnation over the same journal: accepted and
    retired survive replay, every unretired assignment returns to the
    backlog and re-routes to the fresh workers from its watermark."""
    w0 = fake_worker(tmp_path, "w0")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w0])
    gw.submit({"sid": "s0", "model": "gol", "steps": 10, "tenant": "t"})
    gw.submit({"sid": "s1", "model": "gol", "steps": 4, "tenant": "t"})
    gw.tick(restart_lost=False)
    _append_jsonl(w0.outbox, {"ev": "watermark", "sid": "s0", "step": 8,
                              "park": "/park0", "busy_s": 0.1})
    _append_jsonl(w0.outbox, {"ev": "retired", "sid": "s1", "step": 4,
                              "result": "/r1"})
    gw.poll_outboxes()
    gw.journal.close()                   # simulated SIGKILL (no drain)

    w0b = fake_worker(tmp_path, "w0")    # fresh incarnation, same wid
    gw2 = Gateway(str(tmp_path / "j.jsonl"), [w0b])
    assert set(gw2.journal.accepted) == {"s0", "s1"}
    assert gw2.journal.retired == {"s1"}
    assert gw2.journal.assigned == {}    # stale assignments dropped
    assert gw2.journal.backlog() == ["s0"]
    gw2.tick(restart_lost=False)
    assert gw2.journal.assigned == {"s0": "w0"}
    recs = [json.loads(ln) for ln in open(w0b.inbox)]
    assert recs[-1]["sid"] == "s0" and recs[-1]["resume_step"] == 8
    gw2.close()


def test_drain_handback_returns_parked_work_to_backlog(tmp_path):
    """A draining worker's ``handback`` unassigns the scenario and
    preserves its park watermark for the next routing pass."""
    w0 = fake_worker(tmp_path, "w0")
    gw = Gateway(str(tmp_path / "j.jsonl"), [w0])
    gw.submit({"sid": "s0", "model": "gol", "steps": 10, "tenant": "t"})
    gw.tick(restart_lost=False)
    _append_jsonl(w0.outbox, {"ev": "handback", "sid": "s0", "step": 6,
                              "park": "/park0"})
    gw.poll_outboxes()
    assert gw.journal.backlog() == ["s0"]
    assert gw.journal.watermark["s0"] == {"step": 6, "park": "/park0"}
    gw.close()


# ------------------------------------- select_k queue-wait charge


def make_adv(n=4):
    g = (
        Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(0)
        .set_periodic(True, True, True)
        .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=(1.0 / n,) * 3)
        .initialize(n_devices=2, device="cpu")
    )
    g.stop_refining()
    adv = Advection(g, dtype=np.float32, allow_dense=False)
    dt = np.float32(0.4 * adv.max_time_step(adv.initialize_state()))
    return adv, dt


def test_select_k_charges_predicted_wait_when_armed(monkeypatch):
    """With the cost model armed, the deadline-slack clamp additionally charges the earliest-deadline
    tenant's predicted queue wait; a backlog that eats the slack forces
    depth 1, and ``DCCRG_COST_MODEL=0`` restores the EMA path."""
    monkeypatch.setenv("DCCRG_COST_MIN_SAMPLES", "1")
    adv, dt = make_adv()
    ens = Ensemble(steps_per_dispatch=4)
    ens.submit(adv, adv.initialize_state(), steps=8, dt=dt, tenant="dl",
               deadline=time.perf_counter() + 30.0)
    ens.admit_pending()
    cohort = next(iter(ens.scheduler.cohorts.values()))
    g = cohort._wide_g(4)
    cost.model.observe(cohort.spec.kind, cohort.sig_label, 4, g,
                       cohort.W, 1.0)
    # armed, no backlog: 30 s slack / 1 s/step affords full depth
    assert ens.scheduler.select_k(cohort) == 4
    # 1000 backlogged member-steps at a measured 10 steps/s: 100 s of
    # predicted wait eats the whole slack
    ens.submit(adv, adv.initialize_state(), steps=1000, dt=dt,
               tenant="dl")
    cost.tracker.note({"dl": 10}, 1.0)
    assert ens.scheduler.select_k(cohort) == 1
    # the kill switch restores the EMA-only path byte-for-byte
    monkeypatch.setenv("DCCRG_COST_MODEL", "0")
    assert ens.scheduler.select_k(cohort) == 4


def test_results_byte_identical_with_queue_wait_charge(monkeypatch):
    """An armed queue-wait charge
    changes only dispatch depth, never served bytes — results with the
    cost plane on (min_samples=1, live tracker) equal the EMA run's."""
    finals = {}
    for setting in ("1", "0"):
        monkeypatch.setenv("DCCRG_COST_MODEL", setting)
        monkeypatch.setenv("DCCRG_COST_MIN_SAMPLES", "1")
        cost.model.reset()
        cost.tracker.reset()
        adv, dt = make_adv()
        ens = Ensemble(steps_per_dispatch=2)
        tickets = [
            ens.submit(adv, adv.initialize_state(), steps=4, dt=dt,
                       tenant=f"t{i}",
                       deadline=time.perf_counter() + 60.0)
            for i in range(3)
        ]
        ens.run()
        finals[setting] = [
            {k: np.asarray(v).tobytes()
             for k, v in sorted(t.result.items())}
            for t in tickets
        ]
    assert finals["1"] == finals["0"]


# ------------------------------------------ the format across packages


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal (WAL and snapshot) written by one package replays in the
    other to the same state; records are byte-identical."""
    W = SubmissionJournal if writer == "torch" else JG.SubmissionJournal
    R = JG.SubmissionJournal if writer == "torch" else SubmissionJournal
    path = str(tmp_path / "wal.jsonl")
    j = W(path)
    for ev, fields in EVENTS[:4]:
        j.append(ev, **fields)
    j.checkpoint()
    for ev, fields in EVENTS[4:]:
        j.append(ev, **fields)
    want = _state_of(j)
    j.close()
    r = R(path)
    assert _state_of(r) == want and r.torn == 0
    r.close()
    # the same appends from both packages give the same bytes
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    for cls, p in ((SubmissionJournal, pa), (JG.SubmissionJournal, pb)):
        jj = cls(p)
        for ev, fields in EVENTS:
            jj.append(ev, **fields)
        jj.close()
    assert open(pa, "rb").read() == open(pb, "rb").read()


def test_real_cpu_worker_retires_to_the_jax_solo_result(tmp_path, monkeypatch):
    """One real worker process (``python -m dccrg_tpu_torch.serve.worker
    --device cpu``) steps an assigned Game of Life scenario to retirement
    in watermarked chunks; its result park holds the alive set the JAX
    package's worker scenario reaches alone.  The stall window is the
    soak's (a loaded host can take longer than the default 10 s to start
    a worker's interpreter, which the watchdog would count as a loss)."""
    from dccrg_tpu.serve.worker import build_scenario as jax_build

    monkeypatch.setenv("DCCRG_GATEWAY_STALL_S", "300")

    w = WorkerHandle("w0", str(tmp_path / "w0"), n_devices=2, device="cpu")
    w.start()
    gw = Gateway(str(tmp_path / "j.jsonl"), [w])
    try:
        spec = {"sid": "g0", "model": "gol", "n": 6, "seed": 3, "steps": 9,
                "tenant": "t"}
        assert gw.submit(spec) == (True, None)
        deadline = time.monotonic() + 300.0
        while gw.journal.retired != {"g0"}:
            gw.tick(restart_lost=False)
            assert time.monotonic() < deadline, open(
                os.path.join(w.workdir, "worker_1.log")).read()[-2000:]
            time.sleep(0.05)
        assert counter_total("gateway.retired") >= 1
        with np.load(os.path.join(w.workdir, "result_g0.npz")) as z:
            got, step = np.asarray(z["alive"]), int(z["step"])
    finally:
        gw.drain(timeout_s=20.0)
        gw.close()
    b = jax_build(spec, 2)
    st = b["state"]
    for _ in range(9):
        st = b["model"].step(st)
    assert step == 9
    np.testing.assert_array_equal(got, np.sort(np.asarray(b["model"].alive_cells(st))))
