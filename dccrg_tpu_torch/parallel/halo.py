"""Halo exchange: ghost-row refresh over the device slots of one tensor.

The JAX package's ``parallel/halo.py::HaloExchange`` ships each device's
send rows around a per-peer ring — one step per ring distance k (device d
-> device (d+k) % D) that some pair uses, each step sized by that distance's
largest pair count (the reference's send/recv lists,
``dccrg.hpp:8590-8889``).  Here all D slots sit on one tensor, so a ring
step is a gather of the send rows of slot (d-k) % D for every receiving
slot d, and the merge an ``index_put_`` into the receiving slot's ghost
rows.  The ring tables, their bucketed sizes and their scratch-row padding
are the JAX package's; every ring distance's rows are concatenated into one
table of flat rows (``[D * R]`` indexing), so one field's payload is one
gather and its merge one scatter.  A ghost row holds exactly its owner's
value afterwards: the exchange moves values without arithmetic.

The gather goes by the schedule's ``backend`` (``parallel/halo_dma.py``):
kernel B9 (``pallas``) or the plain gather (``collective``).  The blocking
exchange (``__call__``) and the split-phase pair ``start`` / ``finish`` run
the same protocol: ``ring_start`` (the gather) and ``ring_finish`` (the
scatter).  On CUDA, ``start`` launches the gathers on a side stream and
``finish`` makes the current stream wait for them, so a caller can queue
work that does not read ghost rows in between (the reference's overlap
pattern, ``dccrg.hpp:5010-5367``).

A ``cell_datatype`` policy (the reference's ``get_mpi_datatype`` seam,
``dccrg_get_cell_datatype.hpp:48-125``) gives each field its own filtered
ring schedule, evaluated once per epoch; unselected ghost copies keep their
previous values.  Unlike the JAX package, which runs the policy form on the
collective transport only, the port runs it on the schedule's backend too.

``DCCRG_HALO_VERIFY=1`` replays every non-collective exchange on the
collective form and compares bytes; checks and mismatches are counted on
the exchange object (``verify_checks``, ``verify_mismatches``), never
raised.  The JAX package's registry telemetry is not ported (ROADMAP.md
A14).
"""
from __future__ import annotations

import numpy as np
import torch

from . import halo_dma
from .halo_dma import AS_SIGNED
from .shapes import bucket_pairs

__all__ = ["HaloExchange", "HaloHandle"]


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
    """One ring schedule on the device: the active distances ``ks``, their
    bucketed sizes, the concatenated flat source rows ``send`` (int32, the
    B9 table) and ghost rows ``recv`` (int64), ordered k, then receiving
    slot, then pair slot; ``wire`` rows shipped (padding included) and
    ``cells`` useful rows."""

    __slots__ = ("ks", "sizes", "send", "recv", "wire", "cells")


def _signed(x):
    return x.view(AS_SIGNED[x.dtype]) if x.dtype in AS_SIGNED else x


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
        #: verify-oracle counts (``DCCRG_HALO_VERIFY=1``): fields checked,
        #: and mismatching exchanges per field
        self.verify_checks = 0
        self.verify_mismatches = {}
        self._side = None

    def _ring_from_pairs(self, pair_lists, field=None) -> _Rings:
        """Ring schedule from exact per-pair row lists (the JAX package's
        ``_ring_from_pairs``): step k ships d -> (d+k) % D; only distances
        some pair uses appear, each sized by its own largest pair count on
        the bucket ladder.  Pad slots ship the scratch row and land on it."""
        D, R, scratch = self.D, self.R, self.R - 1
        rings = _Rings()
        rings.ks, rings.sizes, rings.wire, rings.cells = [], [], 0, 0
        send, recv = [], []
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
            for d in range(D):
                sr = pair_lists.get((d, (d + k) % D))
                if sr is not None:
                    st[d, :len(sr[0])] = sr[0]
                    rings.cells += len(sr[0])
                rr = pair_lists.get(((d - k) % D, d))
                if rr is not None:
                    rt[d, :len(rr[1])] = rr[1]
            # receiving slot d reads slot (d - k) % D's send rows
            src = (ar - k) % D
            send.append((src[:, None] * R + st[src]).reshape(-1))
            recv.append((ar[:, None] * R + rt).reshape(-1))
            rings.ks.append(k)
            rings.sizes.append(S_k)
            rings.wire += D * S_k
        cat = lambda parts: np.concatenate(parts) if parts else np.zeros(0, np.int64)
        rings.send = torch.as_tensor(cat(send).astype(np.int32), device=self.device)
        rings.recv = torch.as_tensor(cat(recv), device=self.device)
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

    def ring_start(self, x, rings: _Rings, backend=None):
        """Every ring step's payload of one (signed-view) field, ``[T, ...]``
        in the order of ``rings.send``: one B9 launch (``pallas``) or one
        plain gather (``collective``); ``backend`` defaults to the
        schedule's.  The single definition of the wire protocol's send half
        (the JAX package's ``ring_dma_start`` / ``make_ring_start``): the
        blocking exchange, the split pair and the verify oracle call it."""
        if (backend or self.backend) == "pallas":
            return halo_dma.ring_copy(x, rings.send)
        return halo_dma.ring_copy_plain(x, rings.send)

    @staticmethod
    def ring_finish(x, rings: _Rings, payload):
        """Scatter ``ring_start``'s payload into a copy of ``x``'s ghost rows
        (padded slots land on the scratch row)."""
        out = x.clone(memory_format=torch.contiguous_format)
        out.view((-1,) + tuple(x.shape[2:]))[rings.recv] = payload
        return out

    def _exchange_field(self, name, x, backend=None):
        rings = self._rings_for_field(name)
        if not rings.ks:
            return x
        xs = _signed(x)
        return self.ring_finish(xs, rings, self.ring_start(xs, rings, backend)).view(x.dtype)

    def __call__(self, state):
        if isinstance(state, HaloHandle):
            raise TypeError(
                "got a HaloHandle where a state belongs — pass the handle as "
                "wait_remote_neighbor_copy_updates(state, handle)"
            )
        out = {name: self._exchange_field(name, x) for name, x in state.items()}
        if self._verify_active():
            self._verify_oracle(state, out)
        return out

    # ------------------------------------------------------- split-phase

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _payloads(self, fields):
        out = {}
        for name, x in fields.items():
            rings = self._rings_for_field(name)
            out[name] = self.ring_start(x, rings) if rings.ks else None
        return out

    def start(self, state) -> HaloHandle:
        """Gather every field's ghost payloads and return them in a
        ``HaloHandle``; the state is not touched.  On CUDA the gathers run
        on a side stream that first waits for the current stream, and
        ``start`` returns without waiting for them; on the CPU they run
        here.  With no ring to ship (one slot) the handle is empty: no
        payload, no event."""
        if isinstance(state, HaloHandle):
            raise TypeError("start() takes the state, not a HaloHandle")
        fields = {name: _signed(x) for name, x in state.items()}
        if self.device.type != "cuda" or not any(
                self._rings_for_field(name).ks for name in fields):
            return HaloHandle(self._payloads(fields))
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            payload = self._payloads(fields)
            event = torch.cuda.Event()
            event.record(side)
        # the caching allocator must not hand out the fields' memory while
        # the side stream still reads them, nor the payloads' while the
        # current stream has yet to merge them
        for name, x in fields.items():
            x.record_stream(side)
            self._rings_for_field(name).send.record_stream(side)
        for p in payload.values():
            if p is not None:
                p.record_stream(cur)
        return HaloHandle(payload, event)

    def finish(self, state, handle: HaloHandle):
        """Merge a ``start`` handle's payloads into the ghost rows of
        ``state`` (the state ``start`` was given); on CUDA the current
        stream first waits for the side stream's gathers."""
        if not isinstance(handle, HaloHandle):
            raise TypeError("finish() expects the HaloHandle returned by start()")
        if isinstance(state, HaloHandle):
            raise TypeError("finish() takes the state first, then the HaloHandle")
        if set(handle.payload) != set(state):
            raise ValueError("finish() got a different field set than start()")
        if handle.event is not None:
            torch.cuda.current_stream(self.device).wait_event(handle.event)
        out = {}
        for name, x in state.items():
            p = handle.payload[name]
            out[name] = x if p is None else self.ring_finish(
                _signed(x), self._rings_for_field(name), p).view(x.dtype)
        if self._verify_active():
            # the handle came from start(state) on this same state, so the
            # blocking oracle on ``state`` is the expected merge
            self._verify_oracle(state, out)
        return out

    # --------------------------------------------------- oracle verify

    def _verify_active(self) -> bool:
        return self.backend != "collective" and halo_dma.verify_enabled()

    def _verify_oracle(self, state, out) -> int:
        """Cross-check one exchange against the collective form, byte for
        byte (NaN payloads included).  Mismatching fields are counted in
        ``verify_mismatches``, never raised; returns their number."""
        mismatches = 0
        for name, x in state.items():
            ref = self._exchange_field(name, x, backend="collective")
            if not _same_bytes(out[name], ref):
                mismatches += 1
                self.verify_mismatches[name] = self.verify_mismatches.get(name, 0) + 1
        self.verify_checks += len(state)
        return mismatches

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
