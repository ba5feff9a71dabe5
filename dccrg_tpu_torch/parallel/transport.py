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
  they are.

Buffers travel as their bytes (a ``uint8`` view), so any dtype crosses
bit for bit.  The transport counts what it sends: ``bytes_sent`` and
``messages_sent`` on the object, and the registry's
``transport.bytes_sent{peer}`` / ``transport.messages{peer}``.
"""
from __future__ import annotations

import torch

from ..obs.registry import metrics as _metrics

__all__ = ["Transport", "Pending"]


def _bytes(t):
    """A contiguous tensor's bytes as a flat ``uint8`` view."""
    if not t.is_contiguous():
        raise ValueError("transport buffers must be contiguous")
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.new_empty(0, dtype=torch.uint8)


class Pending:
    """The in-flight messages of one :meth:`Transport.post`."""

    __slots__ = ("works", "landings", "keep", "done")

    def __init__(self, works, landings, keep):
        self.works = works
        #: (device target, pinned host buffer) pairs copied on ``wait``
        self.landings = landings
        #: host buffers that must outlive the messages
        self.keep = keep
        self.done = False

    def wait(self) -> None:
        """Complete every message; received CUDA buffers are on the device
        (queued on the current stream) when this returns."""
        if self.done:
            return
        for w in self.works:
            w.wait()
        for target, host in self.landings:
            target.copy_(host, non_blocking=True)
        self.done = True


class Transport:
    """Point-to-point row buffers between the controllers of ``controllers``
    (a :class:`~dccrg_tpu_torch.parallel.mesh.Controllers`).  ``host=True``
    sends over its gloo host group (host metadata); otherwise over the
    default group with its payload backend."""

    def __init__(self, controllers, host: bool = False):
        self.controllers = controllers
        self.group = controllers.host_group if host else None
        self.backend = "gloo" if host else controllers.backend
        self.bytes_sent = 0
        self.messages_sent = 0

    def _stage(self, t):
        """Whether ``t`` must cross through host memory."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def post(self, sends, recvs) -> Pending:
        """Post ``sends`` and ``recvs``, lists of ``(peer rank, contiguous
        tensor)``, as one batch; the receive tensors are filled by the
        returned :class:`Pending`'s ``wait``.  Empty buffers send nothing."""
        import torch.distributed as dist

        sends = [(int(p), t) for p, t in sends if t.numel()]
        recvs = [(int(p), t) for p, t in recvs if t.numel()]
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
        else:
            hosts = [_bytes(t) for _, t in sends]
        for (p, t), h in zip(sends, hosts):
            ops.append(dist.P2POp(dist.isend, h, p, group=self.group))
            keep.append(h)
            self.bytes_sent += h.numel()
            self.messages_sent += 1
            if _metrics.enabled:
                _metrics.inc("transport.bytes_sent", h.numel(), peer=str(p))
                _metrics.inc("transport.messages", peer=str(p))
        for p, t in recvs:
            if self._stage(t):
                h = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                                pin_memory=True)
                landings.append((_bytes(t), h))
            else:
                h = _bytes(t)
            ops.append(dist.P2POp(dist.irecv, h, p, group=self.group))
            keep.append(h)
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(works, landings, keep)

    def exchange(self, sends, recvs) -> None:
        """:meth:`post` and wait."""
        self.post(sends, recvs).wait()
