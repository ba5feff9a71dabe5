"""Halo exchange: ghost-row refresh over the device slots of one tensor.

The JAX package's ``parallel/halo.py::HaloExchange`` ships each device's
send rows around a per-peer ring — one step per ring distance k (device d
-> device (d+k) % D) that some pair uses, each step sized by that distance's
largest pair count (the reference's send/recv lists,
``dccrg.hpp:8590-8889``).  Here all D slots sit on one tensor, so a ring
step is a gather of the send rows of slot (d-k) % D for every receiving
slot d, and the merge another gather.  The ring tables, their bucketed
sizes and their scratch-row padding are the JAX package's; every ring
distance's rows are concatenated into one table of flat rows (``[D * R]``
indexing).  From them each schedule builds, once per epoch, two int32
tables over all ``D * R`` rows: ``full`` (a row's own flat index, or on a
ghost row the schedule refreshes its owner's) and ``merge`` (that ghost
row's payload slot, else -1).  Pad slots enter neither: they ship the
sender's scratch row in the payload, as in the JAX package, but land
nowhere, so the scratch row keeps its own value.  A ghost row holds
exactly its owner's value afterwards: the exchange moves values without
arithmetic.

Every part of the protocol is one grouped gather over all the fields
(``parallel/halo_dma.py``), by the schedule's ``backend``: kernel B9
(``pallas``, one launch for up to ``RING_MAX_FIELDS`` fields) or its
plain twin (``collective``), on the same tables.  The blocking exchange
(``__call__``) gathers through ``full``; the split-phase pair runs
``ring_start`` (the payloads, through the send table) and ``ring_finish``
(the merge, through ``merge``).  On CUDA, ``start`` launches its gather on
a side stream and ``finish`` makes the current stream wait for it, so a
caller can queue work that does not read ghost rows in between (the
reference's overlap pattern, ``dccrg.hpp:5010-5367``).

A ``cell_datatype`` policy (the reference's ``get_mpi_datatype`` seam,
``dccrg_get_cell_datatype.hpp:48-125``) gives each field its own filtered
ring schedule and tables, evaluated once per epoch; unselected ghost
copies keep their previous values.  Unlike the JAX package, which runs the
policy form on the collective transport only, the port runs it on the
schedule's backend too.

``DCCRG_HALO_VERIFY=1`` replays every non-collective exchange on the
collective form and compares bytes; checks and mismatches are counted on
the exchange object (``verify_checks``, ``verify_mismatches``) and in the
registry (``halo.verify_checks``, ``halo.verify_mismatches{field}``), never
raised.

Telemetry is the JAX package's: ``halo.backend_schedules{backend}`` per
schedule built, the per-slot ``halo.send_cells_per_exchange`` /
``recv_cells_per_exchange`` gauges (``device`` is the slot index, the JAX
mesh axis), and per exchange the message and byte counters (``_record``)
and the ``halo.exchange`` / ``halo.start`` phases.  Every recording is
host code and never synchronises: the phase seconds are host enqueue
time, and the device time of the exchange's kernels comes from the
profiler merge (``obs.merge``, label ``halo.ring_copy``).  Unlike the JAX
package, whose exchanges inside a jitted step are not recorded, every
exchange here is launched from the host and recorded.

Cohorts (``serve/ensemble.py``) exchange W member stacks ``[W, D, R,
...]`` at once through :class:`MemberExchange`: to kernel B9 the stack is
``[W * D, R, ...]``, and member w's ring tables carry the offset ``w * D *
R`` (its payload slots ``w * T``), built once per (schedule, W) and kept
by the bound cohort body.  Like the JAX package's in-trace exchanges,
these are not recorded by ``_record``: the cohort reports its own protocol
(:func:`record_dispatch_exchanges`, the ``halo.exchanges_per_step``
gauge).
"""
from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from ..obs.registry import _labels_key
from ..obs.registry import metrics as _metrics
from . import halo_dma
from .shapes import bucket_pairs

__all__ = ["HaloExchange", "HaloHandle", "MemberExchange",
           "interior_steps_per_exchange", "record_dispatch_exchanges"]


def interior_steps_per_exchange(ghost_depth: int,
                                stencil_radius: int = 1) -> int:
    """Deep-dispatch budget of one boundary sync: how many interior
    updates a ghost zone ``ghost_depth`` cells deep serves before a stencil
    of ``stencil_radius`` has consumed it, ``ghost_depth //
    stencil_radius`` (floor 1: a zero-depth hood still supports its one
    face-coupled update).  The JAX package's planning bound."""
    depth = max(int(ghost_depth), 0)
    radius = max(int(stencil_radius), 1)
    return max(depth // radius, 1)


#: model kind -> [exchanges, steps]: cumulative dispatch-level exchange
#: amortization, fed by the serving tier
_amortization: dict = {}


def record_dispatch_exchanges(kind: str, exchanges: int, steps: int) -> None:
    """Exchange-amortization ledger for deep dispatch: after each cohort
    dispatch the front-end reports its protocol (a wide-halo body at depth
    g pays ``ceil(k / g)`` exchanges for k steps, the legacy body k), and
    the cumulative ratio lands as the ``halo.exchanges_per_step{model}``
    gauge.  Pure Python ints."""
    steps = int(steps)
    if steps <= 0:
        return
    ent = _amortization.setdefault(kind, [0, 0])
    ent[0] += int(exchanges)
    ent[1] += steps
    _metrics.gauge("halo.exchanges_per_step", ent[0] / ent[1], model=kind)


def ring_args(ex, names) -> dict:
    """One member's ring tables for the fields ``names`` of the schedule
    ``ex``, as cohort arguments: ``{"ring.<name>.full" / ".send" /
    ".merge": int32 tensor}`` (nothing for a field without a ring).  A
    cohort stacks or shares them like any member table;
    :class:`MemberExchange` offsets them per member."""
    out = {}
    for name in names:
        rings = ex._rings_for_field(name)
        if rings.ks:
            out[f"ring.{name}.full"] = rings.full
            out[f"ring.{name}.send"] = rings.send
            out[f"ring.{name}.merge"] = rings.merge
    return out


class MemberExchange:
    """The ghost-row refresh of W member stacks ``[W, D, R, ...]`` (one
    schedule's protocol for every member at once).

    ``args`` holds each member's :func:`ring_args` tables under a leading
    axis of 1 (one copy every member shares) or W (one a member); the
    member-offset tables are built here once: member w's flat rows shift
    by ``w * D * R`` and its payload slots by ``w * T``.  Every field moves
    in one grouped gather a protocol step (kernel B9 on the ``pallas``
    backend, its twin on ``collective``), as the schedule's own exchange
    does; a member's rows get exactly what its own exchange would give."""

    def __init__(self, ex, args: dict, W: int):
        self.backend = ex.backend
        self.D, self.R, self.W = ex.D, ex.R, int(W)
        if self.W * self.D * self.R >= 2**31:
            raise ValueError("W * D * R rows exceed the int32 ring tables")
        self.tables = {}
        names = sorted({k.split(".")[1] for k in args if k.startswith("ring.")})
        for name in names:
            full = args[f"ring.{name}.full"]
            send = args[f"ring.{name}.send"]
            merge = args[f"ring.{name}.merge"]
            dev = full.device
            w = torch.arange(self.W, dtype=torch.int32, device=dev)[:, None]
            T = send.shape[-1]
            self.tables[name] = (
                (full + w * (self.D * self.R)).reshape(-1).contiguous(),
                (send + w * (self.D * self.R)).reshape(-1).contiguous(),
                torch.where(merge >= 0, merge + w * T, merge).reshape(-1).contiguous(),
            )

    def _gather(self, jobs):
        if not jobs:
            return []
        if self.backend == "pallas":
            return halo_dma.ring_gather(jobs)
        return halo_dma.ring_gather_plain(jobs)

    def _rows(self, x):
        return x.reshape((self.W * self.D,) + tuple(x.shape[2:]))

    def __call__(self, state: dict) -> dict:
        """``state`` with the ghost rows of every field that has a ring
        refreshed (the blocking exchange)."""
        names = [n for n in state if n in self.tables]
        got = self._gather([(self._rows(state[n]), self.tables[n][0]) for n in names])
        out = dict(state)
        out.update((n, y.view(state[n].shape)) for n, y in zip(names, got))
        return out

    def start(self, state: dict) -> dict:
        """Every moving field's payload ``[W * T, ...]`` (the send half)."""
        names = [n for n in state if n in self.tables]
        got = self._gather([(self._rows(state[n]), self.tables[n][1]) for n in names])
        return dict(zip(names, got))

    def finish(self, state: dict, payload: dict) -> dict:
        """``state`` with :meth:`start`'s payloads merged into the ghost
        rows (the merge half)."""
        names = [n for n in state if n in payload]
        got = self._gather([(self._rows(state[n]), self.tables[n][2], payload[n])
                            for n in names])
        out = dict(state)
        out.update((n, y.view(state[n].shape)) for n, y in zip(names, got))
        return out


class HaloHandle:
    """In-flight ghost payloads returned by ``HaloExchange.start``: a
    distinct type, so passing it where a state belongs (or a state where
    the handle belongs) fails loudly instead of exchanging garbage.
    ``payload`` maps field names to flat payloads (None where a field has
    no rings); ``event`` is the side stream's completion event on CUDA."""

    __slots__ = ("payload", "event")

    def __init__(self, payload, event=None):
        self.payload = payload
        self.event = event


class _Rings:
    """One ring schedule: the active distances ``ks``, their bucketed sizes,
    the concatenated flat source rows ``send`` (int32 on the device, the
    payload table) and receiving rows ``recv`` (int64 on the host, pads on
    the scratch row), ordered k, then receiving slot, then pair slot; the
    int32 device tables ``full`` and ``merge`` over all ``D * R`` rows (None
    without a ring); ``wire`` rows shipped (padding included) and ``cells``
    useful rows."""

    __slots__ = ("ks", "sizes", "send", "recv", "full", "merge", "wire", "cells")


def _flush_record_cache(cache: dict) -> None:
    """Materialize a schedule's buffered dispatch counts into the
    registry.  Shared by the registry-driven flush and the GC finalizer —
    an epoch rebuild drops its halo schedules, and the counts they
    buffered must land before the object goes away."""
    for entry in cache.values():
        pairs, n = entry
        entry[1] = 0
        if n:
            _metrics.inc_batch([(key, v * n) for key, v in pairs])


def _maybe_nan_storm(state):
    """Fault-injection seam: when the ``halo.nan`` site is armed and fires,
    poison a few random rows of every floating field with NaN *before* the
    exchange, so the storm propagates into ghost copies exactly the way a
    corrupted payload would (``resilience/inject``).  The rows are drawn in
    the JAX package's order (fields by sorted name, floating fields of
    ndim >= 2 only, ``k = min(4, R)`` slots then ``k`` rows), so a seed
    poisons the same ``(slot, row)`` pairs in both packages.  The rows of a
    copy are poisoned: the caller's tensors stay as they were.  Unarmed cost
    is one dict lookup and no device sync."""
    from ..resilience.inject import plane

    if not plane.armed("halo.nan") or not plane.fires("halo.nan"):
        return state
    rng = plane.site_rng("halo.nan")
    out = dict(state)
    n_rows = 0
    for name in sorted(state):
        x = state[name]
        if x is None or not x.is_floating_point() or x.ndim < 2:
            continue
        k = min(4, x.shape[1])
        d = rng.integers(x.shape[0], size=k)
        r = rng.integers(x.shape[1], size=k)
        y = x.clone()
        y[torch.from_numpy(d).to(y.device), torch.from_numpy(r).to(y.device)] = float("nan")
        out[name] = y
        n_rows += k
    if n_rows:
        _metrics.inc("resilience.nan_rows_poisoned", n_rows)
    return out


def _same_bytes(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


class HaloExchange:
    """Exchange schedule for one (epoch, neighborhood).

    ``exchange(state)`` returns the state with every ``[D, R, ...]`` field's
    ghost rows refreshed from their owners."""

    def __init__(self, epoch, hood, device, cell_datatype=None, hood_id=None,
                 ring_hints=None):
        self.D = epoch.n_devices
        self.R = epoch.R
        self.hood_id = hood_id
        self.device = torch.device(device)
        #: wire transport (``DCCRG_HALO_BACKEND``, resolved at construction
        #: as in the JAX package): "pallas" (kernel B9) or "collective"
        self.backend = halo_dma.resolve_backend(self.device)
        if _metrics.enabled:
            _metrics.inc("halo.backend_schedules", backend=self.backend)
        if self.D * self.R >= 2**31:
            raise ValueError("D * R rows exceed the int32 ring tables")
        #: grid-persistent ring-size hysteresis hints {(hood, field, k):
        #: bucket}, shared with the JAX package's bucket rule
        self._ring_hints = ring_hints if ring_hints is not None else {}
        #: cells moved per exchange (useful payload)
        self.cells_moved = int(hood.pair_counts.sum())
        D = self.D
        pair_lists = {}
        for i in range(D):
            for j in range(D):
                c = int(hood.pair_counts[i, j])
                if c:
                    pair_lists[(i, j)] = (
                        hood.send_rows[i, j, :c],
                        hood.recv_rows[j, i, :c],
                    )
        self._pair_lists = pair_lists
        #: per-cell payload policy ``cell_datatype(field, cell_ids, sender,
        #: receiver, hood_id) -> bool mask`` over a pair's cells; evaluated
        #: once per field per epoch (``_rings_for_field``)
        self._cell_datatype = cell_datatype
        self._sender_cell_ids = (
            {key: epoch.cell_ids[key[0]][np.asarray(sr)]
             for key, (sr, _rr) in pair_lists.items()}
            if cell_datatype is not None else None
        )
        self._field_rings = {}
        self._rings = self._ring_from_pairs(pair_lists, field=None)
        self.ring_ks = self._rings.ks
        self.ring_sizes = self._rings.sizes
        self.wire_cells = self._rings.wire
        #: per-slot cells shipped/received each exchange (telemetry;
        #: static per schedule, so recorded once here as gauges)
        self._send_per_dev = hood.pair_counts.sum(axis=1)
        self._recv_per_dev = hood.pair_counts.sum(axis=0)
        if _metrics.enabled:
            hood_label = "default" if hood_id is None else str(hood_id)
            for d in range(D):
                _metrics.gauge("halo.send_cells_per_exchange",
                               int(self._send_per_dev[d]),
                               device=d, hood=hood_label)
                _metrics.gauge("halo.recv_cells_per_exchange",
                               int(self._recv_per_dev[d]),
                               device=d, hood=hood_label)
        #: verify-oracle counts (``DCCRG_HALO_VERIFY=1``): fields checked,
        #: and mismatching exchanges per field
        self.verify_checks = 0
        self.verify_mismatches = {}
        self._side = None

    def _ring_from_pairs(self, pair_lists, field=None) -> _Rings:
        """Ring schedule from exact per-pair row lists (the JAX package's
        ``_ring_from_pairs``): step k ships d -> (d+k) % D; only distances
        some pair uses appear, each sized by its own largest pair count on
        the bucket ladder.  Pad slots ship the scratch row; the ``full`` and
        ``merge`` tables leave them out."""
        D, R, scratch = self.D, self.R, self.R - 1
        rings = _Rings()
        rings.ks, rings.sizes, rings.wire, rings.cells = [], [], 0, 0
        send, recv, real = [], [], []
        ar = np.arange(D)
        for k in range(1, D):
            S_k = max(
                (len(pair_lists[(d, (d + k) % D)][0])
                 for d in range(D) if (d, (d + k) % D) in pair_lists),
                default=0,
            )
            if S_k == 0:
                continue
            hint_key = (self.hood_id, field, k)
            S_k = bucket_pairs(S_k, self._ring_hints.get(hint_key))
            self._ring_hints[hint_key] = S_k
            st = np.full((D, S_k), scratch, np.int64)
            rt = np.full((D, S_k), scratch, np.int64)
            ok = np.zeros((D, S_k), bool)
            for d in range(D):
                sr = pair_lists.get((d, (d + k) % D))
                if sr is not None:
                    st[d, :len(sr[0])] = sr[0]
                    rings.cells += len(sr[0])
                rr = pair_lists.get(((d - k) % D, d))
                if rr is not None:
                    rt[d, :len(rr[1])] = rr[1]
                    ok[d, :len(rr[1])] = True
            # receiving slot d reads slot (d - k) % D's send rows
            src = (ar - k) % D
            send.append((src[:, None] * R + st[src]).reshape(-1))
            recv.append((ar[:, None] * R + rt).reshape(-1))
            real.append(ok.reshape(-1))
            rings.ks.append(k)
            rings.sizes.append(S_k)
            rings.wire += D * S_k
        cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0, np.int64)
        send, recv = cat(send), cat(recv)
        rings.send = torch.as_tensor(send.astype(np.int32), device=self.device)
        rings.recv = torch.as_tensor(recv)
        rings.full = rings.merge = None
        if rings.ks:
            # each refreshed ghost row has one owner, so one real slot
            slot = np.flatnonzero(cat(real))
            full = np.arange(D * R, dtype=np.int32)
            full[recv[slot]] = send[slot]
            merge = np.full(D * R, -1, np.int32)
            merge[recv[slot]] = slot
            rings.full = torch.as_tensor(full, device=self.device)
            rings.merge = torch.as_tensor(merge, device=self.device)
        return rings

    def _rings_for_field(self, name: str) -> _Rings:
        """The schedule moving ``name``: the shared full schedule without a
        policy, else the policy-filtered one (cached per field per epoch)."""
        if self._cell_datatype is None:
            return self._rings
        if name not in self._field_rings:
            filtered = {}
            for (i, j), (sr, rr) in self._pair_lists.items():
                mask = np.asarray(self._cell_datatype(
                    name, self._sender_cell_ids[(i, j)], i, j, self.hood_id
                ), dtype=bool)
                if mask.shape != (len(sr),):
                    raise ValueError(
                        f"cell_datatype mask for field {name!r} pair "
                        f"({i}->{j}) has shape {mask.shape}, want ({len(sr)},)"
                    )
                if mask.any():
                    filtered[(i, j)] = (np.asarray(sr)[mask], np.asarray(rr)[mask])
            self._field_rings[name] = self._ring_from_pairs(filtered, field=name)
        return self._field_rings[name]

    @property
    def ring_distances(self) -> tuple:
        return tuple(self.ring_ks)

    # --------------------------------------------------- wire protocol

    def _moving(self, state):
        """``[(name, x, rings)]`` of the fields of ``state`` that have rings."""
        out = []
        for name, x in state.items():
            rings = self._rings_for_field(name)
            if rings.ks:
                out.append((name, x, rings))
        return out

    def _gather(self, jobs, backend=None):
        """One grouped gather of ``jobs`` (``halo_dma.ring_gather``'s form):
        kernel B9 (``pallas``) or its plain twin (``collective``);
        ``backend`` defaults to the schedule's.  The single definition of
        the wire protocol's transport: the blocking exchange, the split pair
        and the verify oracle call it."""
        if not jobs:
            return []
        if (backend or self.backend) == "pallas":
            return halo_dma.ring_gather(jobs)
        return halo_dma.ring_gather_plain(jobs)

    def ring_start(self, state, backend=None) -> dict:
        """Every field's ring payload, ``[T, ...]`` in the order of its
        schedule's send table (None where a field has no ring), in one
        grouped gather: the send half of the wire protocol (the JAX
        package's ``ring_dma_start`` / ``make_ring_start``)."""
        moving = self._moving(state)
        got = self._gather([(x, rings.send) for _, x, rings in moving], backend)
        payload = dict.fromkeys(state)
        payload.update((name, p) for (name, _, _), p in zip(moving, got))
        return payload

    def ring_finish(self, state, payload, backend=None) -> dict:
        """``state`` with ``ring_start``'s payloads merged into the ghost
        rows their schedules refresh, in one grouped gather; a field with no
        payload is returned as it is."""
        names = [name for name in state if payload[name] is not None]
        got = self._gather([(state[name], self._rings_for_field(name).merge,
                             payload[name]) for name in names], backend)
        out = dict(state)
        out.update(zip(names, got))
        return out

    def _exchange(self, state, backend=None) -> dict:
        """The blocking exchange: every field with rings gathered through its
        ``full`` table in one grouped gather."""
        moving = self._moving(state)
        got = self._gather([(x, rings.full) for _, x, rings in moving], backend)
        out = dict(state)
        out.update((name, y.view(x.shape)) for (name, x, _), y in zip(moving, got))
        return out

    def __call__(self, state):
        if isinstance(state, HaloHandle):
            raise TypeError(
                "got a HaloHandle where a state belongs — pass the handle as "
                "wait_remote_neighbor_copy_updates(state, handle)"
            )
        state = _maybe_nan_storm(state)
        if _metrics.enabled:
            self._record(state, "blocking")
            t0 = time.perf_counter()
            out = self._exchange(state)
            _metrics.phase_add("halo.exchange", time.perf_counter() - t0)
        else:
            out = self._exchange(state)
        if self._verify_active():
            self._verify_oracle(state, out)
        return out

    # ------------------------------------------------------- split-phase

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def start(self, state) -> HaloHandle:
        """Gather every field's ghost payloads and return them in a
        ``HaloHandle``; the state is not touched.  On CUDA the gather runs
        on a side stream that first waits for the current stream, and
        ``start`` returns without waiting for it; on the CPU it runs here.
        With no ring to ship (one slot) the handle is empty: no payload, no
        event."""
        if isinstance(state, HaloHandle):
            raise TypeError("start() takes the state, not a HaloHandle")
        if _metrics.enabled:
            # timed as its own phase (not halo.exchange): the span from a
            # halo.start begin to the next halo.exchange (finish) end is
            # the in-flight window the merge's overlap fraction measures
            self._record(state, "split")
            t0 = time.perf_counter()
            out = self._start_dispatch(state)
            _metrics.phase_add("halo.start", time.perf_counter() - t0)
            return out
        return self._start_dispatch(state)

    def _start_dispatch(self, state) -> HaloHandle:
        moving = self._moving(state)
        if self.device.type != "cuda" or not moving:
            return HaloHandle(self.ring_start(state))
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            payload = self.ring_start(state)
            event = torch.cuda.Event()
            event.record(side)
        # the caching allocator must not hand out the fields' memory while
        # the side stream still reads them, nor the payloads' while the
        # current stream has yet to merge them
        for _, x, rings in moving:
            x.record_stream(side)
            rings.send.record_stream(side)
        for p in payload.values():
            if p is not None:
                p.record_stream(cur)
        return HaloHandle(payload, event)

    def finish(self, state, handle: HaloHandle):
        """Merge a ``start`` handle's payloads into the ghost rows of
        ``state`` (the state ``start`` was given); on CUDA the current
        stream first waits for the side stream's gather."""
        if not isinstance(handle, HaloHandle):
            raise TypeError("finish() expects the HaloHandle returned by start()")
        if isinstance(state, HaloHandle):
            raise TypeError("finish() takes the state first, then the HaloHandle")
        if set(handle.payload) != set(state):
            raise ValueError("finish() got a different field set than start()")
        if _metrics.enabled:
            t0 = time.perf_counter()
            out = self._finish_dispatch(state, handle)
            _metrics.phase_add("halo.exchange", time.perf_counter() - t0)
        else:
            out = self._finish_dispatch(state, handle)
        if self._verify_active():
            # the handle came from start(state) on this same state, so the
            # blocking oracle on ``state`` is the expected merge
            self._verify_oracle(state, out)
        return out

    def _finish_dispatch(self, state, handle: HaloHandle):
        if handle.event is not None:
            torch.cuda.current_stream(self.device).wait_event(handle.event)
        return self.ring_finish(state, handle.payload)

    # --------------------------------------------------- oracle verify

    def _verify_active(self) -> bool:
        return self.backend != "collective" and halo_dma.verify_enabled()

    def _verify_oracle(self, state, out) -> int:
        """Cross-check one exchange against the collective form, byte for
        byte (NaN payloads included).  Mismatching fields are counted in
        ``verify_mismatches`` and ``halo.verify_mismatches{field}``, never
        raised; returns their number."""
        t0 = time.perf_counter()
        mismatches = 0
        ref = self._exchange(state, backend="collective")
        for name in state:
            if not _same_bytes(out[name], ref[name]):
                mismatches += 1
                self.verify_mismatches[name] = self.verify_mismatches.get(name, 0) + 1
                _metrics.inc("halo.verify_mismatches", field=name)
        self.verify_checks += len(state)
        _metrics.inc("halo.verify_checks", len(state))
        _metrics.phase_add("halo.verify", time.perf_counter() - t0)
        return mismatches

    # ------------------------------------------------------- telemetry

    def _record(self, state, kind: str) -> None:
        """Host-side telemetry for one exchange dispatch: message/byte
        accounting per ring distance and field, the JAX package's series.
        Every recorded value is a pure function of the schedule and the
        state's field signature (names, shapes, dtypes), so the prepared
        batch is cached per signature and a dispatch only bumps its
        multiplicity — the batch materializes into the registry when a
        report/export flushes it (``metrics.register_flusher``).  A repeat
        dispatch costs a signature hash and one integer add.  The bare
        ``+= 1`` is not atomic across threads; a lost bump under thread
        races is accepted — this is telemetry, not accounting."""
        sig = (kind,) + tuple((n, x.shape, x.dtype) for n, x in state.items())
        cache = getattr(self, "_record_cache", None)
        if cache is None:
            cache = self._record_cache = {}
            _metrics.register_flusher(self)
            # epoch rebuilds drop their schedules (the grid's halo cache is
            # cleared); pending buffered counts must not die with them
            weakref.finalize(self, _flush_record_cache, cache)
        entry = cache.get(sig)
        if entry is None:
            hood = "default" if self.hood_id is None else str(self.hood_id)
            items = [
                ("halo.exchanges", 1, {"kind": kind, "hood": hood}),
                ("halo.cells_moved", self.cells_moved),
                ("halo.bytes_moved", self.bytes_moved(state)),
                ("halo.wire_bytes", self.wire_bytes(state)),
                ("halo.permute_steps", len(self.ring_ks)),
            ]
            # per-slot cells per dispatch (schedule rows; under a
            # cell_datatype policy this counts the full-payload schedule,
            # field-accurate bytes are in halo.field_bytes)
            items.extend(
                ("halo.send_cells", int(self._send_per_dev[d]),
                 {"device": d, "hood": hood}) for d in range(self.D)
            )
            items.extend(
                ("halo.recv_cells", int(self._recv_per_dev[d]),
                 {"device": d, "hood": hood}) for d in range(self.D)
            )
            if self._cell_datatype is None:
                per = sum(self._per_cell_bytes(x) for x in state.values())
                items.extend(
                    ("halo.ring_bytes", self.D * S * per, {"ring": k})
                    for k, S in zip(self.ring_ks, self.ring_sizes)
                )
                items.extend(
                    ("halo.field_bytes",
                     self.cells_moved * self._per_cell_bytes(x),
                     {"field": n})
                    for n, x in state.items()
                )
            else:
                items.extend(
                    ("halo.field_bytes",
                     self._rings_for_field(n).cells * self._per_cell_bytes(x),
                     {"field": n})
                    for n, x in sorted(state.items())
                )
            entry = cache[sig] = [
                [
                    ((it[0], _labels_key(it[2]) if len(it) > 2 else ()),
                     int(it[1])) for it in items
                ],
                0,
            ]
        entry[1] += 1

    def telemetry_flush(self, discard: bool = False) -> None:
        """Materialize buffered dispatch counts into the registry (or
        drop them on ``discard`` — a registry reset)."""
        cache = getattr(self, "_record_cache", None)
        if not cache:
            return
        if discard:
            for entry in cache.values():
                entry[1] = 0
            return
        _flush_record_cache(cache)

    # ------------------------------------------------------- accounting

    @staticmethod
    def _per_cell_bytes(x) -> int:
        return int(np.prod(x.shape[2:], dtype=np.int64)) * x.element_size()

    def bytes_moved(self, state) -> int:
        """Useful payload bytes (real send-list rows) per exchange."""
        return sum(self._rings_for_field(n).cells * self._per_cell_bytes(x)
                   for n, x in state.items())

    def wire_bytes(self, state) -> int:
        """Bytes each exchange gathers: each ring step moves ``D * S_k`` rows
        (its own largest pair count, padding included)."""
        return sum(self._rings_for_field(n).wire * self._per_cell_bytes(x)
                   for n, x in state.items())
