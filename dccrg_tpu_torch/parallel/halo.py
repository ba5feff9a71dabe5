"""Halo exchange: ghost-row refresh over the device slots of one tensor,
and between the slot blocks of several controllers.

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

Under several controllers (``parallel/mesh.py``) each process holds its
own block of slots, ``[len(own), R, ...]``, and builds the schedule's
tables for those slots only (:meth:`HaloExchange._controller_tables`):
for each ring distance, the pairs whose sender and receiver slots share
the controller stay local, and the others cross the ring transport
(``parallel/transport.py``).  An exchange is three steps: kernel B9's
payload mode packs one buffer a field, ``[local rows | the rows for each
peer | room for each peer's rows]``, whose slices are the messages; the
transport posts every peer's message of every field as one
``batch_isend_irecv`` (gloo stages CUDA buffers through pinned host
memory; nccl sends them as they are); B9's merge mode lands the local and
received rows in the ghost rows.  The blocking ``__call__`` runs the three
in a row, ``start`` packs and posts (no side stream), ``finish`` waits and
merges; ``DCCRG_HALO_VERIFY`` replays the same protocol with the plain
twin over the same transport.  Each controller records the per-slot
gauges and counters of its own slots, and the byte counters of the rows
its slots ship; ``transport_bytes`` counts what crossed to other
controllers.

Under the ``ipc`` transport (``parallel/ipc.py``, the counterpart of the
JAX package's ``make_async_remote_copy``) there is no pack copy and no
message: B9's remote-write form (``halo_dma.ring_put``) writes the local
rows into this controller's own arena channel and each peer's rows
straight into that peer's arena, the payload ``[local | out to peers | in
from peers]`` row for row at offsets both sides compute; B9's merge reads
the local and received rows from this controller's arena through a merge
table re-pointed at their arena rows.  ``start`` writes on the side stream
(the split steps keep their overlap), ``finish`` waits for the peers' write
events and merges on the current stream, then releases the regions.

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

import math
import time
import weakref

import numpy as np
import torch

from ..obs.events import HALO_FINISH
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
    :class:`MemberExchange` offsets them per member.

    Under several controllers there is no ``full`` table: ``send`` is this
    controller's payload table padded to the widest controller's (every
    controller's tables have the same shapes, so every controller forms the
    same cohorts) and ``ring.<name>.parts`` (int64, on the host) holds the
    payload's parts as ``(peer, start, rows)``: the local rows, then the
    rows to each other controller, then the rows from each, a row a
    controller in rank order (0 rows where a pair ships nothing)."""
    out = {}
    for name in names:
        rings = ex._rings_for_field(name)
        if not rings.ks:
            continue
        if not ex.multi:
            out[f"ring.{name}.full"] = rings.full
            out[f"ring.{name}.send"] = rings.send
            out[f"ring.{name}.merge"] = rings.merge
            continue
        T = len(rings.send)
        send = rings.send.new_zeros(rings.width)
        send[:T] = rings.send
        me, P = ex._controllers.rank, ex._controllers.size
        n_local = (rings.sends[0][1] if rings.sends else
                   rings.recvs[0][1] if rings.recvs else T)
        parts = [(me, 0, n_local)]
        for part in (rings.sends, rings.recvs):
            have = {q: (a, n) for q, a, n in part}
            parts += [(q, *have.get(q, (0, 0))) for q in range(P) if q != me]
        out[f"ring.{name}.send"] = send
        out[f"ring.{name}.merge"] = rings.merge
        out[f"ring.{name}.parts"] = torch.tensor(parts, dtype=torch.int64)
    return out


class _Direct:
    """The ``ipc`` form of an exchange's protocol (``parallel/ipc.py``) for
    :class:`HaloExchange` and :class:`MemberExchange`.  :meth:`start` places
    one batch in the arenas and writes it with one grouped put (B9's
    remote-write form): each field's local rows into this controller's own
    channel and each peer's part into that peer's arena.  It returns the
    batch, each field's payload (this controller's whole arena as the
    field's rows) and each field's merge table, whose payload slots point at
    the arena rows of the local and received parts (built once a field and
    placement)."""

    def __init__(self, transport, device):
        self.transport = transport
        self.arena = transport.arena
        self.device = device
        self._tables = {}

    def start(self, fields, need, put, stream=None):
        """``fields``: ``(name, x, send, merge_host, n_local, sends, recvs)``
        a field (``sends`` / ``recvs`` the payload's ``(peer, start, rows)``
        parts); ``need`` the largest channel of any controller;
        ``put(jobs)`` B9's put or its twin.  Returns ``(batch, payload,
        tables)``."""
        arena = self.arena
        arena.reserve(need)
        rbs = [math.prod(f[1].shape[2:]) * f[1].element_size() for f in fields]
        local, sends, recvs = [], [], []
        for (_, _, _, _, n_local, s_parts, r_parts), rb in zip(fields, rbs):
            if n_local:
                local.append((n_local * rb, rb))
            sends += [(q, n * rb, rb) for q, _, n in s_parts]
            recvs += [(q, n * rb, rb) for q, _, n in r_parts]
        batch = arena.begin(local, sends, recvs, stream)
        jobs, payload, tables = [], {}, {}
        li = si = ri = 0
        for (name, x, send, merge_host, n_local, s_parts, r_parts), rb in zip(fields, rbs):
            row = tuple(x.shape[2:])
            pos_local = None
            if n_local:
                jobs.append((x, send[:n_local],
                             batch.local_view(li, x.dtype, (n_local,) + row)))
                pos_local = batch.local_pos[li]
                li += 1
            for q, a, n in s_parts:
                jobs.append((x, send[a:a + n], batch.send_view(si, x.dtype, (n,) + row)))
                self.transport.note_sent(q, n * rb)
                si += 1
            pos_in = tuple(batch.recv_pos[ri:ri + len(r_parts)])
            ri += len(r_parts)
            tables[name] = self._merge_table(name, merge_host, n_local, s_parts, r_parts,
                                             pos_local, pos_in, rb)
            payload[name] = arena.typed(x.dtype, row)
        put(jobs)
        batch.commit()
        return batch, payload, tables

    def _merge_table(self, name, merge_host, n_local, s_parts, r_parts, pos_local,
                     pos_in, rb):
        key = (name, rb, pos_local, pos_in)
        table = self._tables.get(key)
        if table is None:
            T = max([n_local] + [a + n for _, a, n in (*s_parts, *r_parts)])
            slot = np.full(T, -1, np.int64)
            if n_local:
                slot[:n_local] = pos_local // rb + np.arange(n_local)
            for (_, a, n), pos in zip(r_parts, pos_in):
                slot[a:a + n] = pos // rb + np.arange(n)
            m = np.asarray(merge_host, np.int64)
            out = np.full(len(m), -1, np.int64)
            hit = m >= 0
            out[hit] = slot[m[hit]]
            if len(out) and out.max() >= 2**31:
                raise ValueError("the arena's rows exceed the int32 merge table")
            table = torch.as_tensor(out.astype(np.int32), device=self.device)
            if len(self._tables) >= 64:
                self._tables.clear()
            self._tables[key] = table
        return table


def _put_of(backend):
    """B9's remote-write form (``halo_dma.ring_put``) on the ``pallas``
    backend, else its twin: the ``ipc`` pack."""
    return halo_dma.ring_put if backend == "pallas" else halo_dma.ring_put_plain


def _direct_need(n_ctl, items) -> int:
    """The largest arena channel any controller fills: ``items`` are
    ``(pair_counts [P, P], row bytes)`` a field, one message a field and
    controller pair (``ipc.channel_bound``'s rule)."""
    from .ipc import channel_bound

    tot = np.zeros((n_ctl, n_ctl), np.int64)
    for counts, rb in items:
        counts = np.asarray(counts, np.int64)
        tot += np.where(counts > 0, counts * rb + channel_bound([(1, rb)]) - 1, 0)
    return int(tot.max()) if tot.size else 0


class MemberExchange:
    """The ghost-row refresh of W member stacks ``[W, D, R, ...]`` (one
    schedule's protocol for every member at once).

    ``args`` holds each member's :func:`ring_args` tables under a leading
    axis of 1 (one copy every member shares) or W (one a member); the
    member-offset tables are built here once: member w's flat rows shift
    by ``w * D * R`` and its payload slots by ``w * T``.  Every field moves
    in one grouped gather a protocol step (kernel B9 on the ``pallas``
    backend, its twin on ``collective``), as the schedule's own exchange
    does; a member's rows get exactly what its own exchange would give.

    Under several controllers the stacks are this controller's slots,
    ``[W, len(slots), R, ...]``, and the rows shift by ``w * len(slots) *
    R``.  The payload is laid out part by part (:func:`ring_args`' parts),
    each part holding every member's rows in member order, so one grouped
    gather packs all W members and the transport carries one message a
    peer and field with all W members' rows in it; the merge is one more
    grouped gather.  :meth:`start` packs and posts, :meth:`finish` waits
    and merges, as the schedule's own split pair does.  Under the ``ipc``
    transport the pack writes every member's rows straight into the arenas
    and the merge reads them from this controller's (``_Direct``), on the
    current stream."""

    def __init__(self, ex, args: dict, W: int):
        self.backend = ex.backend
        self.D, self.R, self.W = len(ex._own), ex.R, int(W)
        if self.W * self.D * self.R >= 2**31:
            raise ValueError("W * D * R rows exceed the int32 ring tables")
        self.tables = {}
        #: under several controllers: each field's ``(sends, recvs)`` as
        #: ``(peer, start, rows)`` slices of its member payload
        self.parts = {}
        #: under several controllers: each field's local payload rows, its
        #: merge table on the host and its ``[P, P]`` rows a controller
        #: pair (W members of the schedule's)
        self.local, self.merge_host, self.pair_counts = {}, {}, {}
        self._transport = ex._transport
        self._direct = (_Direct(self._transport, ex.device)
                        if self._transport is not None and self._transport.direct
                        else None)
        names = sorted({k.split(".")[1] for k in args if k.startswith("ring.")})
        for name in names:
            if ex.multi:
                self._controller_tables(name, args)
                self.pair_counts[name] = self.W * ex._rings_for_field(name).pair_counts
                continue
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

    def _controller_tables(self, name, args):
        """One field's member tables under several controllers: member w's
        payload parts (its own ``parts``, shared or stacked) laid out part
        by part, member after member, with its rows shifted by ``w * D *
        R``; the merge table sends a member's ghost row to its slot in that
        layout.  Built on the host once a bind."""
        send = args[f"ring.{name}.send"].cpu().numpy()
        merge = args[f"ring.{name}.merge"].cpu().numpy()
        parts = args[f"ring.{name}.parts"].cpu().numpy()
        DR = self.D * self.R
        of = lambda a, w: a[w if a.shape[0] > 1 else 0]
        # each member's payload slot -> its slot in the member layout
        new_of = [np.full(int(of(parts, w)[:, 2].sum()), -1, np.int64)
                  for w in range(self.W)]
        new_send, slices, at = [], [], 0
        for i in range(parts.shape[1]):
            first = at
            for w in range(self.W):
                _, a, n = (int(v) for v in of(parts, w)[i])
                new_send.append(of(send, w)[a:a + n].astype(np.int64) + w * DR)
                new_of[w][a:a + n] = np.arange(at, at + n)
                at += n
            slices.append((int(of(parts, 0)[i][0]), first, at - first))
        full_merge = np.full(self.W * DR, -1, np.int64)
        for w in range(self.W):
            m = of(merge, w).astype(np.int64)
            hit = np.flatnonzero(m >= 0)
            full_merge[w * DR + hit] = new_of[w][m[hit]]
        dev = args[f"ring.{name}.send"].device
        put = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
        self.tables[name] = (None, put(np.concatenate(new_send)), put(full_merge))
        P = (len(slices) + 1) // 2
        self.parts[name] = (slices[1:P], slices[P:])
        self.local[name] = slices[0][2]
        self.merge_host[name] = full_merge

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
        if self._transport is not None:
            return self.finish(state, self.start(state))
        names = [n for n in state if n in self.tables]
        got = self._gather([(self._rows(state[n]), self.tables[n][0]) for n in names])
        out = dict(state)
        out.update((n, y.view(state[n].shape)) for n, y in zip(names, got))
        return out

    def start(self, state: dict) -> HaloHandle:
        """Every moving field's payload ``[W * T, ...]`` (the send half) in
        a :class:`HaloHandle`; under several controllers its remote parts
        are posted on the transport, one message a peer and field."""
        names = [n for n in state if n in self.tables]
        if self._direct is not None:
            return self._direct_start(state, names)
        got = self._gather([(self._rows(state[n]), self.tables[n][1]) for n in names])
        pending = None
        if self._transport is not None:
            sends, recvs = [], []
            for n, p in zip(names, got):
                out_parts, in_parts = self.parts[n]
                sends += [(q, p[a:a + k]) for q, a, k in out_parts]
                recvs += [(q, p[a:a + k]) for q, a, k in in_parts]
            pending = self._transport.post(sends, recvs)
        return HaloHandle(dict(zip(names, got)), None, pending)

    def finish(self, state: dict, handle: HaloHandle) -> dict:
        """``state`` with :meth:`start`'s payloads merged into the ghost
        rows (the merge half; under several controllers it first waits for
        the transport)."""
        if handle.pending is not None:
            handle.pending.wait()
        payload = handle.payload
        names = [n for n in state if n in payload]
        merge = handle.tables if handle.tables is not None else {
            n: self.tables[n][2] for n in names}
        got = self._gather([(self._rows(state[n]), merge[n], payload[n]) for n in names])
        if handle.tables is not None and handle.pending is not None:
            handle.pending.release(_current_stream(state))
        out = dict(state)
        out.update((n, y.view(state[n].shape)) for n, y in zip(names, got))
        return out

    def _direct_start(self, state, names) -> HaloHandle:
        """The ``ipc`` pack of every member's rows, on the current stream."""
        if not names:
            return HaloHandle({}, None, None, {})
        fields = [(n, self._rows(state[n]), self.tables[n][1], self.merge_host[n],
                   self.local[n], *self.parts[n]) for n in names]
        rbs = [math.prod(state[n].shape[3:]) * state[n].element_size() for n in names]
        need = _direct_need(len(self.pair_counts[names[0]]),
                            [(self.pair_counts[n], rb) for n, rb in zip(names, rbs)])
        batch, payload, tables = self._direct.start(fields, need, _put_of(self.backend),
                                                    _current_stream(state))
        return HaloHandle(payload, None, batch, tables)


def _current_stream(state):
    """The current stream of a state's CUDA device (None on the CPU)."""
    for x in state.values():
        if x is not None and x.device.type == "cuda":
            return torch.cuda.current_stream(x.device)
    return None


class HaloHandle:
    """In-flight ghost payloads returned by ``HaloExchange.start``: a
    distinct type, so passing it where a state belongs (or a state where
    the handle belongs) fails loudly instead of exchanging garbage.
    ``payload`` maps field names to flat payloads (None where a field has
    no rings); ``event`` is the side stream's completion event on CUDA;
    ``pending`` the posted transport messages under several controllers
    (``parallel/transport.py``), or the ``ipc`` batch, whose ``tables`` are
    the merge tables re-pointed at this controller's arena (``payload``
    then holds the arena's typed views)."""

    __slots__ = ("payload", "event", "pending", "tables")

    def __init__(self, payload, event=None, pending=None, tables=None):
        self.payload = payload
        self.event = event
        self.pending = pending
        self.tables = tables


class _Rings:
    """One ring schedule: the active distances ``ks``, their bucketed sizes,
    the concatenated flat source rows ``send`` (int32 on the device, the
    payload table) and receiving rows ``recv`` (int64 on the host, pads on
    the scratch row), ordered k, then receiving slot, then pair slot; the
    int32 device tables ``full`` and ``merge`` over all ``D * R`` rows (None
    without a ring); ``wire`` rows shipped (padding included), ``k_wire``
    the same a ring distance, and ``cells`` useful rows.

    Under several controllers the tables are this controller's
    (:meth:`HaloExchange._controller_tables`): ``send`` gathers the payload
    ``[local | to each peer | from each peer]`` from the local rows,
    ``merge`` covers the local slots' rows, ``sends`` / ``recvs`` hold each
    peer's ``(rank, first slot, rows)`` in the payload, ``full`` is None,
    ``wire`` / ``k_wire`` / ``cells`` count the rows this controller's
    slots ship (no padding), ``width`` is the longest payload of any
    controller, ``n_local`` the payload's local rows, ``merge_host`` the
    merge table on the host and ``pair_counts`` ``[P, P]`` every controller
    pair's rows (the ``ipc`` arenas' sizes)."""

    __slots__ = ("ks", "sizes", "send", "recv", "full", "merge", "wire",
                 "k_wire", "cells", "sends", "recvs", "width", "n_local",
                 "merge_host", "pair_counts")


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
                 ring_hints=None, controllers=None):
        self.D = epoch.n_devices
        self.R = epoch.R
        self.hood_id = hood_id
        self.device = torch.device(device)
        #: the controller group (``parallel/mesh.py``); under several
        #: controllers the fields are this controller's ``[len(own), R,
        #: ...]`` slots and remote pairs cross ``_transport``
        self.multi = controllers is not None and controllers.multi
        self._controllers = controllers
        self._own = (controllers.local_slots(self.D) if self.multi
                     else range(self.D))
        self._transport = None
        if self.multi:
            from .transport import Transport

            self._transport = Transport(controllers)
        #: the ``ipc`` form of the protocol (None on the other transports)
        self._direct = (_Direct(self._transport, self.device)
                        if self._transport is not None and self._transport.direct
                        else None)
        self._direct_needs = {}
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
        #: cells moved per exchange (useful payload; this controller's
        #: slots' sends under several controllers)
        self.cells_moved = int(hood.pair_counts[self._own.start:self._own.stop].sum())
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
            for d in self._own:
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
        rings.k_wire, rings.sends, rings.recvs = [], None, None
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
            rings.k_wire.append(D * S_k)
        cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0, np.int64)
        if self.multi:
            return self._controller_tables(rings, cat(send), cat(recv),
                                           cat(real).astype(bool))
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

    def _controller_tables(self, rings, send, recv, real) -> _Rings:
        """This controller's part of the ring schedule (global flat rows
        ``send`` / ``recv`` and the ``real`` mask of ``_ring_from_pairs``,
        in its k, receiving slot, pair slot order).  A real entry whose
        sender and receiver slots are both this controller's is local; one
        from this controller's slot to another's goes out to that peer; one
        to this controller's slot from another's comes in.  The payload is
        ``[local | out to peer 0, 1, ... | in from peer 0, 1, ...]``, each
        part in the schedule's order, so a sender's part for a peer is that
        peer's part from it, row for row; the payload table reads the
        sender's local flat row (0 for an incoming slot, which the
        transport overwrites), the merge table sends a refreshed ghost row
        to its payload slot.  Pads are left out: they land nowhere."""
        D, R = self.D, self.R
        rank_of = self._controllers.slot_owner(D)
        me, lo, Dl = self._controllers.rank, self._own.start, len(self._own)
        send, recv = send[real], recv[real]
        src_rank, dst_rank = rank_of[send // R], rank_of[recv // R]
        k_of = np.repeat(np.arange(len(rings.ks)), [D * S for S in rings.sizes])[real]
        order = [np.flatnonzero((src_rank == me) & (dst_rank == me))]
        rings.sends, rings.recvs = [], []
        at = len(order[0])
        for part, mine, theirs in (("sends", src_rank, dst_rank),
                                   ("recvs", dst_rank, src_rank)):
            for q in range(self._controllers.size):
                if q == me:
                    continue
                sel = np.flatnonzero((mine == me) & (theirs == q))
                if len(sel):
                    getattr(rings, part).append((q, at, len(sel)))
                    order.append(sel)
                    at += len(sel)
        n_local = len(order[0])
        order = np.concatenate(order)
        n_ship = n_local + sum(n for _, _, n in rings.sends)
        table = np.zeros(len(order), np.int32)
        table[:n_ship] = send[order[:n_ship]] - lo * R
        # the rows that land here: local entries and incoming ones
        slots = np.concatenate([np.arange(n_local),
                                np.arange(n_ship, len(order))]).astype(np.int64)
        landed = order[slots]
        merge = np.full(Dl * R, -1, np.int32)
        merge[recv[landed] - lo * R] = slots
        rings.send = torch.as_tensor(table, device=self.device)
        rings.recv = torch.as_tensor(recv[landed] - lo * R)
        rings.merge = torch.as_tensor(merge, device=self.device)
        rings.merge_host, rings.n_local = merge, n_local
        P = self._controllers.size
        rings.pair_counts = np.bincount(src_rank * P + dst_rank,
                                        minlength=P * P).reshape(P, P)
        rings.full = None
        shipped = order[:n_ship]
        rings.cells = rings.wire = n_ship
        rings.k_wire = np.bincount(k_of[shipped], minlength=len(rings.ks)).tolist()
        # every controller's payload length (its entries as sender or
        # receiver), from the replicated schedule: the widest pads the
        # cohort tables (``ring_args``)
        P = self._controllers.size
        both = np.bincount(src_rank, minlength=P) + np.bincount(dst_rank, minlength=P)
        rings.width = int((both - np.bincount(src_rank[src_rank == dst_rank],
                                              minlength=P)).max())
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

    def ring_finish(self, state, payload, backend=None, tables=None) -> dict:
        """``state`` with ``ring_start``'s payloads merged into the ghost
        rows their schedules refresh, in one grouped gather; a field with no
        payload is returned as it is.  ``tables``: merge tables in place of
        the schedules' (the ``ipc`` arena's)."""
        names = [name for name in state if payload[name] is not None]
        merge = (lambda n: tables[n]) if tables is not None else (
            lambda n: self._rings_for_field(n).merge)
        got = self._gather([(state[name], merge(name), payload[name])
                            for name in names], backend)
        out = dict(state)
        out.update(zip(names, got))
        return out

    def _exchange(self, state, backend=None) -> dict:
        """The blocking exchange: every field with rings gathered through its
        ``full`` table in one grouped gather.  Under several controllers:
        the payloads in one grouped gather, the transport, and the merge in
        another (:meth:`_post`)."""
        if self.multi:
            return self._finish_dispatch(
                state, self._start_dispatch(state, backend, side=False), backend)
        moving = self._moving(state)
        got = self._gather([(x, rings.full) for _, x, rings in moving], backend)
        out = dict(state)
        out.update((name, y.view(x.shape)) for (name, x, _), y in zip(moving, got))
        return out

    def _post(self, moving, payloads):
        """Post every field's remote parts of its payload (the slices of
        ``_Rings.sends`` / ``recvs``) as one transport batch; fields in the
        state's order, each peer's part once a field, the same order on
        every controller."""
        sends, recvs = [], []
        for (_, _, rings), p in zip(moving, payloads):
            sends += [(q, p[a:a + n]) for q, a, n in rings.sends]
            recvs += [(q, p[a:a + n]) for q, a, n in rings.recvs]
        return self._transport.post(sends, recvs)

    @property
    def transport_bytes(self) -> int:
        """Bytes this schedule has sent to other controllers (0 under one)."""
        return 0 if self._transport is None else self._transport.bytes_sent

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

    def _start_dispatch(self, state, backend=None, side=True) -> HaloHandle:
        moving = self._moving(state)
        if self._direct is not None:
            return self._direct_start(state, moving, backend, side)
        if self.multi:
            # payloads on the current stream (the gloo transport stages
            # them through host memory before it posts), then posted
            got = self._gather([(x, rings.send) for _, x, rings in moving], backend)
            payload = dict.fromkeys(state)
            payload.update((name, p) for (name, _, _), p in zip(moving, got))
            return HaloHandle(payload, None, self._post(moving, got))
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
            _metrics.phase_add("halo.exchange", time.perf_counter() - t0, HALO_FINISH)
        else:
            out = self._finish_dispatch(state, handle)
        if self._verify_active():
            # the handle came from start(state) on this same state, so the
            # blocking oracle on ``state`` is the expected merge
            self._verify_oracle(state, out)
        return out

    def _finish_dispatch(self, state, handle: HaloHandle, backend=None):
        if handle.tables is not None:
            return self._direct_finish(state, handle, backend)
        if handle.pending is not None:
            handle.pending.wait()
        if handle.event is not None:
            torch.cuda.current_stream(self.device).wait_event(handle.event)
        return self.ring_finish(state, handle.payload, backend)

    # ------------------------------------------------ ipc (device-direct)

    def _direct_need_of(self, moving) -> int:
        """The largest arena channel any controller fills for these fields
        (from the replicated schedule, so the same on every controller)."""
        items = [(rings.pair_counts, self._per_cell_bytes(x)) for _, x, rings in moving]
        key = tuple((name, rb) for (name, _, _), (_, rb) in zip(moving, items))
        need = self._direct_needs.get(key)
        if need is None:
            need = self._direct_needs[key] = _direct_need(self._controllers.size, items)
        return need

    def _direct_start(self, state, moving, backend, side) -> HaloHandle:
        """The ``ipc`` pack: every field's local rows and every peer's part
        written into their arena regions in one grouped put, on the side
        stream for the split pair (``side``), else on the current one."""
        payload = dict.fromkeys(state)
        if not moving:
            return HaloHandle(payload, None, None, {})
        fields = [(name, x, rings.send, rings.merge_host, rings.n_local, rings.sends,
                   rings.recvs) for name, x, rings in moving]
        need = self._direct_need_of(moving)
        put = _put_of(backend or self.backend)
        if self.device.type != "cuda" or not side:
            cur = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                   else None)
            batch, got, tables = self._direct.start(fields, need, put, cur)
            payload.update(got)
            return HaloHandle(payload, None, batch, tables)
        cur = torch.cuda.current_stream(self.device)
        stream = self._side_stream()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            batch, got, tables = self._direct.start(fields, need, put, stream)
            event = torch.cuda.Event()
            event.record(stream)
        for _, x, rings in moving:
            x.record_stream(stream)
            rings.send.record_stream(stream)
        payload.update(got)
        return HaloHandle(payload, event, batch, tables)

    def _direct_finish(self, state, handle, backend):
        """The ``ipc`` merge: the peers' writes waited for, the local and
        received rows merged from this controller's arena on the current
        stream, the regions released."""
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)
        if handle.pending is not None:
            handle.pending.wait()
        if handle.event is not None:
            stream.wait_event(handle.event)
        out = self.ring_finish(state, handle.payload, backend, handle.tables)
        if handle.pending is not None:
            handle.pending.release(stream)
        return out

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
                 {"device": d, "hood": hood}) for d in self._own
            )
            items.extend(
                ("halo.recv_cells", int(self._recv_per_dev[d]),
                 {"device": d, "hood": hood}) for d in self._own
            )
            if self._cell_datatype is None:
                per = sum(self._per_cell_bytes(x) for x in state.values())
                items.extend(
                    ("halo.ring_bytes", rows * per, {"ring": k})
                    for k, rows in zip(self.ring_ks, self._rings.k_wire)
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
        """Useful payload bytes (real send-list rows) per exchange (this
        controller's slots' rows under several controllers)."""
        return sum(self._rings_for_field(n).cells * self._per_cell_bytes(x)
                   for n, x in state.items())

    def wire_bytes(self, state) -> int:
        """Bytes each exchange gathers: each ring step moves ``D * S_k`` rows
        (its own largest pair count, padding included)."""
        return sum(self._rings_for_field(n).wire * self._per_cell_bytes(x)
                   for n, x in state.items())
