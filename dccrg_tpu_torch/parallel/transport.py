"""The ring transport between controllers: point-to-point row buffers.

The JAX package's halo ships a ring step's packed ``[S_k, ...]`` payload to
another chip with a remote DMA (``parallel/halo_dma.py::ring_copy``,
``pltpu.make_async_remote_copy``).  Between the port's controllers the
payloads travel as messages of the process group: :meth:`Transport.post`
puts every (peer, buffer) send and receive of one exchange into one
``torch.distributed.batch_isend_irecv`` and returns a :class:`Pending`
whose ``wait`` completes them.  Both sides post the messages of a peer in
the same order (the order of the replicated schedule), so the k-th send to
a peer meets that peer's k-th receive from this rank.

By the group's backend (``parallel/mesh.py``):

* ``nccl`` — the device buffers themselves, on NCCL's stream, which waits
  for the current stream before it sends and which ``wait`` makes the
  current stream wait for;
* ``gloo`` — CPU tensors only: a CUDA send buffer is copied into a pinned
  host buffer and the current stream synchronised before the send is
  posted, and a CUDA receive lands in a pinned host buffer that ``wait``
  copies to the device (on the current stream).  CPU buffers travel as
  they are;
* ``ipc`` — device to device on one node, through the receive arenas of
  ``parallel/ipc.py``: each send is copied (on the current stream) straight
  into the receiving controller's arena, at the offset both sides compute
  from the batch's order, and ``wait`` waits (on the host) for the
  sender's token and write event and copies each receive out of this
  controller's arena; only small tokens cross between the processes.  No
  pinned buffer, no stream synchronisation.  The halo's ring writes into the arenas with kernel B9
  itself (``parallel/halo.py``) and uses the transport only for its arena
  and its counts.

Buffers travel as their bytes (a ``uint8`` view), so any dtype crosses
bit for bit.  The transport counts what it sends: ``bytes_sent`` and
``messages_sent`` on the object, and the registry's
``transport.bytes_sent{peer}`` / ``transport.messages{peer}``; the pinned
host bytes gloo stages and the stream synchronisations it makes are
counted for the whole process in :data:`STAGED` (0 under ``ipc`` and
``nccl``).
"""
from __future__ import annotations

import torch

from ..obs.registry import metrics as _metrics

__all__ = ["Transport", "Pending", "STAGED"]

#: the process's host staging: pinned ``bytes`` gloo staged for CUDA
#: buffers, and the stream synchronisations (``syncs``) it made first
STAGED = {"bytes": 0, "syncs": 0}


def _bytes(t):
    """A contiguous tensor's bytes as a flat ``uint8`` view."""
    if not t.is_contiguous():
        raise ValueError("transport buffers must be contiguous")
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.new_empty(0, dtype=torch.uint8)


class Pending:
    """The in-flight messages of one :meth:`Transport.post`."""

    __slots__ = ("works", "landings", "keep", "done", "batch")

    def __init__(self, works, landings, keep, batch=None):
        self.works = works
        #: (target, source) pairs copied on ``wait``: gloo's pinned host
        #: buffers, or ``ipc``'s regions of this controller's arena
        self.landings = landings
        #: host buffers that must outlive the messages
        self.keep = keep
        #: the ``ipc`` batch (``parallel/ipc.py``), None on the other
        #: backends
        self.batch = batch
        self.done = False

    def wait(self) -> None:
        """Complete every message; received CUDA buffers are on the device
        (queued on the current stream) when this returns."""
        if self.done:
            return
        for w in self.works:
            w.wait()
        if self.batch is not None:
            self.batch.wait()
        for target, src in self.landings:
            target.copy_(src, non_blocking=True)
        if self.batch is not None:
            self.batch.release(_stream_of(t for t, _ in self.landings))
        self.done = True


def _stream_of(tensors):
    """The current stream of the first CUDA tensor, else None."""
    for t in tensors:
        if t.device.type == "cuda":
            return torch.cuda.current_stream(t.device)
    return None


class Transport:
    """Point-to-point row buffers between the controllers of ``controllers``
    (a :class:`~dccrg_tpu_torch.parallel.mesh.Controllers`).  ``host=True``
    sends over its gloo host group (host metadata); otherwise over the
    default group with its payload backend."""

    def __init__(self, controllers, host: bool = False):
        self.controllers = controllers
        self.group = controllers.host_group if host else None
        self.backend = "gloo" if host else controllers.backend
        #: the receive arenas under ``ipc`` (``parallel/ipc.py``)
        self.arena = None
        if self.backend == "ipc":
            self.arena = getattr(controllers, "arena", None)
            if self.arena is None:
                raise RuntimeError("the ipc transport needs the controllers' arena "
                                   "(mesh.setup(backend='ipc')); it never falls back "
                                   "to another backend")
        self.bytes_sent = 0
        self.messages_sent = 0

    @property
    def direct(self) -> bool:
        """Whether payloads cross device to device through the arenas
        (``ipc``)."""
        return self.arena is not None

    def note_sent(self, peer: int, nbytes: int) -> None:
        """Count one message of ``nbytes`` to ``peer`` (also the halo's
        ``ipc`` writes, which B9 makes without :meth:`post`)."""
        self.bytes_sent += int(nbytes)
        self.messages_sent += 1
        if _metrics.enabled:
            _metrics.inc("transport.bytes_sent", int(nbytes), peer=str(peer))
            _metrics.inc("transport.messages", peer=str(peer))

    def _stage(self, t):
        """Whether ``t`` must cross through host memory."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def post(self, sends, recvs, need=None) -> Pending:
        """Post ``sends`` and ``recvs``, lists of ``(peer rank, contiguous
        tensor)``, as one batch; the receive tensors are filled by the
        returned :class:`Pending`'s ``wait``.  Empty buffers send nothing.

        Under ``ipc`` every controller calls it at the same point (the
        arenas may grow, a collective), and ``need`` is the largest channel
        (``ipc.channel_bound``) any controller's batch fills, from the
        replicated schedule; None means this controller's own largest,
        for a batch whose sizes are the same on every controller."""
        import torch.distributed as dist

        sends = [(int(p), t) for p, t in sends if t.numel()]
        recvs = [(int(p), t) for p, t in recvs if t.numel()]
        if self.arena is not None:
            return self._post_ipc(sends, recvs, need)
        ops, landings, keep = [], [], []
        staged = [self._stage(t) for _, t in sends]
        if any(staged):
            hosts = []
            for (p, t), st in zip(sends, staged):
                if st:
                    h = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                                    pin_memory=True)
                    h.copy_(_bytes(t), non_blocking=True)
                    hosts.append(h)
                else:
                    hosts.append(_bytes(t))
            # gloo reads host memory on its own threads: the copies must
            # have landed before the sends are posted
            torch.cuda.current_stream(sends[staged.index(True)][1].device).synchronize()
            STAGED["syncs"] += 1
            STAGED["bytes"] += sum(h.numel() for h, st in zip(hosts, staged) if st)
        else:
            hosts = [_bytes(t) for _, t in sends]
        for (p, t), h in zip(sends, hosts):
            ops.append(dist.P2POp(dist.isend, h, p, group=self.group))
            keep.append(h)
            self.note_sent(p, h.numel())
        for p, t in recvs:
            if self._stage(t):
                h = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                                pin_memory=True)
                landings.append((_bytes(t), h))
                STAGED["bytes"] += h.numel()
            else:
                h = _bytes(t)
            ops.append(dist.P2POp(dist.irecv, h, p, group=self.group))
            keep.append(h)
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(works, landings, keep)

    def _post_ipc(self, sends, recvs, need) -> Pending:
        """:meth:`post` under ``ipc``: each send copied into its receiver's
        arena on the current stream; the receives copied out by ``wait``."""
        from .ipc import channel_bound

        out = [(p, _bytes(t)) for p, t in sends]
        inc = [(p, _bytes(t)) for p, t in recvs]
        if need is None:
            chans = {}
            for key, items in (("out", out), ("in", inc)):
                for p, b in items:
                    chans.setdefault((key, p), []).append((b.numel(), 1))
            need = max((channel_bound(m) for m in chans.values()), default=0)
        self.arena.reserve(need)
        if not out and not inc:
            return Pending([], [], [])
        stream = _stream_of(b for _, b in out + inc)
        batch = self.arena.begin((), [(p, b.numel(), 1) for p, b in out],
                                 [(p, b.numel(), 1) for p, b in inc], stream)
        for i, (p, b) in enumerate(out):
            batch.send_view(i, torch.uint8, (b.numel(),)).copy_(b, non_blocking=True)
            self.note_sent(p, b.numel())
        batch.commit()
        landings = [(b, batch.recv_view(i, torch.uint8, (b.numel(),)))
                    for i, (_, b) in enumerate(inc)]
        return Pending([], landings, [], batch)

    def exchange(self, sends, recvs, need=None) -> None:
        """:meth:`post` and wait."""
        self.post(sends, recvs, need).wait()
