"""Host-metadata collectives (the role of the reference's MPI support layer,
``dccrg_mpi_support.hpp``: ``All_Gather`` ``:98-231``, ``All_Reduce``
``:237-266``, ``Some_Reduce`` ``:282-377``): the JAX package's
``utils/collectives.py`` over the port's controller group
(``parallel/mesh.py``).

Every controller holds the replicated per-slot metadata, so the per-slot
helpers (``all_gather``, ``halo_peers``) are local.  Agreement between
controllers (``union_u64``, ``sync_adaptation``, ``sync_partition_inputs``,
``assert_agreement``) travels over one seam, :func:`_process_allgather`
(the gloo host group's ``all_gather``), which tests may replace with a
fake multi-process transport; ``some_reduce_p2p`` is the point-to-point
exchange among an explicit set of processes (the process group's
``batch_isend_irecv``, with the JAX socket transport's semantics).  Each
helper is the identity (or a local reduction) under one controller.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "process_count",
    "retrying",
    "fetch",
    "allgather_u64",
    "allgather_u64_multi",
    "union_u64",
    "sync_adaptation",
    "sync_partition_inputs",
    "assert_agreement",
    "from_root",
    "barrier",
    "all_gather",
    "all_reduce",
    "slot_sum",
    "some_reduce",
    "some_reduce_p2p",
    "halo_peers",
]


def _controllers():
    from ..parallel.mesh import current

    return current()


def process_count() -> int:
    """Number of controller processes (1 unless ``parallel.mesh.setup``
    joined a group)."""
    return _controllers().size


# --------------------------------------------------------------- retry plane

def _retry_budget() -> int:
    import os

    return int(os.environ.get("DCCRG_P2P_RETRIES", "4"))


def _retry_base() -> float:
    import os

    return float(os.environ.get("DCCRG_P2P_RETRY_BASE", "0.05"))


def retrying(fn, what: str, peer=None, budget: int | None = None,
             base: float | None = None, cap: float = 2.0):
    """Run ``fn()`` with bounded exponential backoff and jitter on
    transient ``OSError``s (the JAX package's retry discipline for its
    point-to-point transport).  Timeouts are not retried, nor is anything
    that is not an ``OSError``.  Each retry is counted as
    ``p2p.retries{peer}``; once the budget (``DCCRG_P2P_RETRIES``, default
    4) is spent, a ``RuntimeError`` names the operation, peer, budget and
    last error."""
    import random
    import socket
    import time

    from ..obs.registry import metrics

    budget = _retry_budget() if budget is None else int(budget)
    base = _retry_base() if base is None else float(base)
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise
            attempt += 1
            if attempt > budget:
                raise RuntimeError(
                    f"p2p {what}"
                    + (f" (peer {peer})" if peer is not None else "")
                    + f": retry budget of {budget} exhausted "
                    f"(last error: {e!r}); raise DCCRG_P2P_RETRIES if the "
                    "network is transiently flaky, or investigate the peer"
                ) from e
            metrics.inc("p2p.retries",
                        peer="?" if peer is None else str(peer))
            time.sleep(random.uniform(0.0, min(cap, base * 2 ** (attempt - 1))))


def _gather_bytes(arr: np.ndarray) -> list:
    """Every controller's copy of a same-shape host array, in rank order
    (one gloo ``all_gather`` of its bytes)."""
    import torch
    import torch.distributed as dist

    ctl = _controllers()
    arr = np.asarray(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(t) for _ in range(ctl.size)]
    dist.all_gather(parts, t, group=ctl.host_group)
    return [p.numpy().view(arr.dtype).reshape(arr.shape) for p in parts]


def fetch(x, dtype=None) -> np.ndarray:
    """Device -> host readback valid under any controller layout (numpy
    arrays pass through).  Under several controllers a tensor is a per-slot
    payload whose leading axis is this controller's slots: every controller
    gets the whole ``[D, ...]`` array, the slot blocks in rank order (the
    JAX package's ``process_allgather(tiled=True)``).  A collective: every
    controller calls it in the same order."""
    if not hasattr(x, "detach"):
        out = np.asarray(x)
    else:
        out = x.detach().cpu().numpy()
        if process_count() > 1:
            out = np.concatenate(_gather_bytes(out), axis=0)
    return out if dtype is None else out.astype(dtype, copy=False)


def slot_sum(partials):
    """The sum over every slot of per-slot partials, ``partials`` a
    ``[len(slots)]`` device tensor of this controller's slots, added in slot
    order: the same bits on any controller layout of the same slots.  Under
    several controllers the partials of all of them arrive by an all-gather
    (:func:`fetch`), never by a backend all-reduce, whose order is the
    backend's.  A collective: every controller calls it in the same
    order."""
    import torch

    if process_count() > 1:
        partials = torch.from_numpy(fetch(partials)).to(partials.device)
    acc = partials[0]
    for i in range(1, partials.shape[0]):
        acc = acc + partials[i]
    return acc


def _process_allgather(x: np.ndarray) -> np.ndarray:
    """Transport seam: gather one fixed-shape array from every process;
    returns ``[P, *x.shape]``.  Split out so tests can substitute a fake
    multi-process transport."""
    return np.stack(_gather_bytes(np.asarray(x)))


def allgather_u64_multi(arrays: list) -> list[list]:
    """Gather several variable-length uint64 arrays from every process in
    one (lengths, payload) collective pair — the wire format for all id-set
    agreement (the reference's ``All_Gather`` of cell-id lists,
    ``dccrg_mpi_support.hpp:98-231``).  Returns ``out[p][i]`` = process
    p's i-th array; single-controller: ``[arrays]``."""
    arrays = [np.ascontiguousarray(a, dtype=np.uint64) for a in arrays]
    if process_count() == 1:
        return [arrays]
    k = len(arrays)
    lens = np.asarray([len(a) for a in arrays], dtype=np.int64)
    all_lens = _process_allgather(lens)               # [P, k]
    cap = max(int(all_lens.sum(axis=1).max()), 1)
    buf = np.zeros(cap, dtype=np.uint64)
    cat = np.concatenate(arrays) if k else buf[:0]
    buf[: len(cat)] = cat
    bufs = _process_allgather(buf)                    # [P, cap]
    out = []
    for p in range(len(bufs)):
        bounds = np.concatenate(([0], np.cumsum(all_lens[p])))
        out.append([bufs[p, bounds[i] : bounds[i + 1]] for i in range(k)])
    return out


def allgather_u64(values: np.ndarray) -> list[np.ndarray]:
    """Every process's (variable-length) uint64 array, visible everywhere.
    Single-controller: ``[values]``."""
    return [row[0] for row in allgather_u64_multi([values])]


def union_u64(values) -> np.ndarray:
    """Sorted union of every process's uint64 set — how structural mutation
    requests reach agreement before a commit (reference: per-rank request
    lists merged in ``dccrg.hpp:3461-3485``)."""
    arr = (
        values
        if isinstance(values, np.ndarray)
        else np.fromiter(values, dtype=np.uint64)
    )
    parts = allgather_u64(arr)
    return np.unique(np.concatenate(parts))


def sync_adaptation(queues) -> None:
    """Merge every controller's AMR request queues in place, so the
    deterministic veto -> induce -> override -> execute commit runs on
    identical inputs everywhere.  Unions are right for requests and for
    vetoes alike (any controller's request or veto stands), as in the
    reference's cross-rank request exchange (``dccrg.hpp:3461-3485``).
    Identity with one controller."""
    if process_count() == 1:
        return
    names = ("to_refine", "to_unrefine", "not_to_refine", "not_to_unrefine")
    rows = allgather_u64_multi(
        [np.fromiter(getattr(queues, name), dtype=np.uint64) for name in names]
    )
    for i, name in enumerate(names):
        merged = np.unique(np.concatenate([row[i] for row in rows]))
        setattr(queues, name, {int(c) for c in merged})


def sync_partition_inputs(pin_requests: dict, cell_weights: dict) -> tuple:
    """The merged (pins, weights) view every controller partitions with —
    the reference's ``update_pin_requests`` All_Gather of per-rank pins
    (``dccrg.hpp:8297-8340``) and its replicated cell-weight map.

    Returns a transient merged pair; the caller's own dicts stay local, so
    a later local unpin is not resurrected by stale copies from peers.
    Merge order is process rank: when two controllers disagree about a
    cell, the highest rank's entry wins — every process applies the same
    rule.  Identity with one controller."""
    if process_count() == 1:
        return pin_requests, cell_weights
    pin_cells = np.fromiter(pin_requests.keys(), dtype=np.uint64,
                            count=len(pin_requests))
    pin_devs = np.fromiter(pin_requests.values(), dtype=np.uint64,
                           count=len(pin_requests))
    w_cells = np.fromiter(cell_weights.keys(), dtype=np.uint64,
                          count=len(cell_weights))
    w_vals = np.fromiter(cell_weights.values(), dtype=np.float64,
                         count=len(cell_weights)).view(np.uint64)
    rows = allgather_u64_multi([pin_cells, pin_devs, w_cells, w_vals])
    merged_pins, merged_weights = {}, {}
    for row in rows:                       # ascending process rank
        for c, d in zip(row[0], row[1]):
            merged_pins[int(c)] = int(d)
        for c, w in zip(row[2], row[3].view(np.float64)):
            merged_weights[int(c)] = float(w)
    return merged_pins, merged_weights


def assert_agreement(tag: str, payload: bytes) -> None:
    """Enforced multi-controller agreement for host-side mutator inputs:
    hash the local inputs and compare across every controller; a mismatch
    raises on all controllers instead of letting the grids silently
    diverge (the reference gets this from its SPMD collectives,
    ``dccrg.hpp:6383-6603``).  Identity with one controller."""
    if process_count() == 1:
        return
    import hashlib

    # the tag is part of the digest: two different mutators with equal
    # payload bytes must not falsely agree
    digest = np.frombuffer(
        hashlib.sha256(tag.encode() + b"\0" + payload).digest()[:8],
        dtype=np.uint64,
    ).copy()
    rows = allgather_u64(digest)
    mine = int(digest[0])
    bad = [p for p, r in enumerate(rows) if int(r[0]) != mine]
    if bad:
        raise RuntimeError(
            f"controllers disagree on {tag}: this process's inputs "
            f"differ from process(es) {bad} — {tag} must be called with "
            "identical arguments on every controller"
        )


def from_root(obj):
    """Controller 0's ``obj`` on every controller (a pickled broadcast over
    the host group): how a decision that only one process may take (one
    that reads a clock, a directory or a cost model) reaches the others, so
    every controller acts on the same one.  Identity with one controller.
    A collective: every controller calls it in the same order; the others'
    ``obj`` is ignored."""
    if process_count() == 1:
        return obj
    import torch.distributed as dist

    box = [obj if _controllers().rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=_controllers().host_group)
    return box[0]


def barrier(name: str = "dccrg") -> None:
    """Cross-controller synchronisation point (the role of ``MPI_Barrier``
    around the reference's collective file IO, ``dccrg.hpp:1128``).
    Identity with one controller."""
    if process_count() == 1:
        return
    import torch.distributed as dist

    dist.barrier(group=_controllers().host_group)


def all_gather(per_device_values) -> list:
    """Every device's value, visible everywhere (reference All_Gather):
    per-slot metadata is replicated, so this is the list itself."""
    return list(per_device_values)


def all_reduce(per_device_values, op=np.add):
    """Reduce all devices' values to one result (reference All_Reduce).
    Under several controllers each process reduces its slots' values
    locally, the partials are gathered, and ``op`` reduces them again in
    rank order — any associative ufunc (add, minimum, maximum, ...)."""
    local = op.reduce(np.asarray(per_device_values), axis=0)
    if process_count() == 1:
        return local
    parts = _process_allgather(np.asarray(local))
    return op.reduce(parts, axis=0)


def halo_peers(grid, device: int, hood_id=None) -> np.ndarray:
    """Devices that exchange halo cells with the given one."""
    pc = grid.epoch.hoods[hood_id].pair_counts
    return np.flatnonzero((pc[device] > 0) | (pc[:, device] > 0))


class _P2PTransport:
    """Point-to-point controller transport — the role of the reference's
    ``MPI_Isend``/``MPI_Irecv`` pairs in ``Some_Reduce``
    (``dccrg_mpi_support.hpp:282-377``) and of the JAX package's socket
    ``_P2PTransport``: per exchange, a message travels to and from each
    neighbour process individually; no process outside the set takes part
    and no collective runs.  Messages are the host group's
    ``batch_isend_irecv`` (a length, then the payload), matched by source,
    so a peer already in a later exchange that includes this process simply
    waits for it.  Byte counts per peer are kept in ``sent_to`` /
    ``received_from``."""

    _instance = None

    @classmethod
    def get(cls) -> "_P2PTransport":
        """The per-process singleton."""
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        from ..parallel.transport import Transport

        ctl = _controllers()
        self.rank = ctl.rank
        self._wire = Transport(ctl, host=True)
        self.sent_to: dict[int, int] = {}
        self.received_from: dict[int, int] = {}

    def exchange(self, payload: bytes, peers) -> dict[int, bytes]:
        """Symmetric send and receive of ``payload`` with every process in
        ``peers`` (collective among exactly those processes and this one).
        Returns ``{peer: its payload}``."""
        import torch

        from ..resilience import inject

        peers = sorted({int(p) for p in peers} - {self.rank})
        if not peers:
            return {}
        mine = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
            if payload else torch.zeros(0, dtype=torch.uint8)
        n = torch.tensor([len(payload)], dtype=torch.int64)
        lens = {p: torch.zeros(1, dtype=torch.int64) for p in peers}

        def post_lengths():
            inject.maybe_raise("p2p.recv")
            return self._wire.post([(p, n) for p in peers],
                                   [(p, lens[p]) for p in peers])

        retrying(post_lengths, "recv").wait()
        bodies = {p: torch.empty(int(lens[p][0]), dtype=torch.uint8) for p in peers}
        self._wire.exchange([(p, mine) for p in peers],
                            [(p, bodies[p]) for p in peers])
        out = {}
        for p in peers:
            out[p] = bodies[p].numpy().tobytes()
            self.sent_to[p] = self.sent_to.get(p, 0) + len(payload)
            self.received_from[p] = self.received_from.get(p, 0) + len(out[p])
        return out


def some_reduce_p2p(value, neighbor_processes, op=np.add):
    """The reference's ``Some_Reduce`` at process level
    (``dccrg_mpi_support.hpp:282-377``): symmetric point-to-point exchange
    of ``value`` with each process in ``neighbor_processes``, returning
    ``op`` over own and received values.  Collective among exactly those
    processes; identity with one controller or an empty set.  Each process
    may pass a different value and set and gets its own neighbourhood's
    result."""
    arr = np.ascontiguousarray(value)
    peers = sorted({int(p) for p in neighbor_processes})
    if process_count() == 1 or not peers:
        return arr if arr.shape else arr[()]
    t = _P2PTransport.get()
    got = t.exchange(arr.tobytes(), peers)
    stack = [arr] + [
        np.frombuffer(got[p], dtype=arr.dtype).reshape(arr.shape)
        for p in sorted(got)
    ]
    return op.reduce(np.stack(stack), axis=0)


def some_reduce(grid, per_device_values, device: int, op=np.add, hood_id=None):
    """Reduce only among a device slot and its halo peers (the reference's
    neighbour-only ``Some_Reduce``), in ascending slot order.

    Under several controllers each member process's own slots'
    contributions travel point-to-point among exactly the processes owning
    member slots; every controller (member or not) assembles the full
    member value list and reduces it in ascending slot order, so float
    results are bitwise identical everywhere.  A controller owning no
    member slot computes from its replicated metadata view."""
    peers = halo_peers(grid, device, hood_id)
    vals = np.asarray(per_device_values)
    members = np.unique(np.concatenate([[device], peers])).astype(np.int64)
    if process_count() == 1:
        return op.reduce(vals[members], axis=0)
    transport = _P2PTransport.get()
    ctl = grid.controllers
    me = ctl.rank
    owner_proc = ctl.slot_owner(grid.n_devices)[members]
    mine = members[owner_proc == me]
    member_procs = sorted({int(p) for p in owner_proc} - {me})
    if not len(mine) or not member_procs:
        return op.reduce(vals[members], axis=0)
    # ship (member slot ids, values) so peers can slot contributions into
    # the canonical ascending order
    payload = (np.uint64(len(mine)).tobytes()
               + mine.astype(np.int64).tobytes()
               + np.ascontiguousarray(vals[mine]).tobytes())
    got = transport.exchange(payload, member_procs)
    by_device = {int(d): vals[int(d)] for d in mine}
    item = vals[members[0]]
    for body in got.values():
        k = int(np.frombuffer(body[:8], np.uint64)[0])
        devs = np.frombuffer(body[8:8 + 8 * k], np.int64)
        peer_vals = np.frombuffer(
            body[8 + 8 * k:], dtype=item.dtype
        ).reshape((k,) + item.shape)
        for d, v in zip(devs, peer_vals):
            by_device[int(d)] = v
    missing = {int(d) for d in members} - set(by_device)
    if missing:
        raise RuntimeError(
            f"some_reduce missing contributions for devices "
            f"{sorted(missing)}"
        )
    ordered = np.stack([by_device[int(d)] for d in members])  # ascending
    return op.reduce(ordered, axis=0)
