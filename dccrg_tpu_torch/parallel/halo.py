"""Halo exchange: ghost-row refresh over the device slots of one tensor.

The JAX package's ``parallel/halo.py::HaloExchange`` ships each device's
send rows around a per-peer ring — one ``ppermute`` per ring distance k
(device d -> device (d+k) % D) that some pair uses, each step sized by that
distance's largest pair count (the reference's send/recv lists,
``dccrg.hpp:8590-8889``).  Here all D slots sit on one tensor, so a ring
step is a gather of the send rows of slot (d-k) % D for every receiving
slot d, followed by an ``index_put_`` into the receiving slot's ghost rows.
The ring tables, their bucketed sizes and their scratch-row padding are the
JAX package's, so a ghost row holds exactly its owner's value afterwards,
and the exchange moves values without arithmetic.

Only the blocking collective form is ported: the asynchronous-copy backend,
the ``cell_datatype`` policy, split-phase ``start``/``finish``, the verify
oracle and the telemetry are queued (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from .shapes import bucket_pairs

__all__ = ["HaloExchange"]

_AS_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


class HaloExchange:
    """Exchange schedule for one (epoch, neighborhood).

    ``exchange(state)`` returns the state with every ``[D, R, ...]`` field's
    ghost rows refreshed from their owners."""

    def __init__(self, epoch, hood, device, hood_id=None, ring_hints=None):
        self.D = epoch.n_devices
        self.R = epoch.R
        self.hood_id = hood_id
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
        self.ring_ks, send, recv = self._ring_from_pairs(pair_lists)
        # per ring step: (source slot of each receiving slot [D, 1], its send
        # rows [D, S_k], the receiving slot's ghost rows [D, S_k]) on device
        put = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        self._tables = []
        for k, st, rt in zip(self.ring_ks, send, recv):
            src = (np.arange(D) - k) % D
            self._tables.append((put(src[:, None]), put(st[src]), put(rt)))
        self._dst = put(np.arange(D)[:, None])

    def _ring_from_pairs(self, pair_lists):
        """Ring schedule from exact per-pair row lists (the JAX package's
        ``_ring_from_pairs``): step k ships d -> (d+k) % D; only distances
        some pair uses appear, each sized by its own largest pair count on
        the bucket ladder.  Pad slots ship the scratch row and land on it."""
        D, scratch = self.D, self.R - 1
        ks, send, recv = [], [], []
        for k in range(1, D):
            S_k = max(
                (len(pair_lists[(d, (d + k) % D)][0])
                 for d in range(D) if (d, (d + k) % D) in pair_lists),
                default=0,
            )
            if S_k == 0:
                continue
            hint_key = (self.hood_id, None, k)
            S_k = bucket_pairs(S_k, self._ring_hints.get(hint_key))
            self._ring_hints[hint_key] = S_k
            st = np.full((D, S_k), scratch, np.int32)
            rt = np.full((D, S_k), scratch, np.int32)
            for d in range(D):
                sr = pair_lists.get((d, (d + k) % D))
                if sr is not None:
                    st[d, :len(sr[0])] = sr[0]
                rr = pair_lists.get(((d - k) % D, d))
                if rr is not None:
                    rt[d, :len(rr[1])] = rr[1]
            ks.append(k)
            send.append(st)
            recv.append(rt)
        return ks, send, recv

    @property
    def ring_distances(self) -> tuple:
        return tuple(self.ring_ks)

    def exchange_field(self, x):
        """One ``[D, R, ...]`` field with its ghost rows refreshed.  Every
        ring step's payload is read from ``x`` before any is written, as
        the JAX package's ``ring_start`` / ``ring_finish`` pair does."""
        if not self.ring_ks:
            return x
        if x.dtype in _AS_SIGNED:
            # torch has no index_put_ for unsigned integers; the exchange
            # moves bits, so it runs on a same-width signed view
            return self.exchange_field(x.view(_AS_SIGNED[x.dtype])).view(x.dtype)
        payloads = [x[src, rows] for src, rows, _ in self._tables]
        out = x.clone()
        for (_, _, recv), p in zip(self._tables, payloads):
            out.index_put_((self._dst.expand_as(recv), recv), p)
        return out

    def __call__(self, state):
        return {name: self.exchange_field(x) for name, x in state.items()}
