"""The device-direct ring transport's receive arenas (``ipc``).

The JAX package's ring step writes its packed payload straight into the
receiving chip's buffer (``parallel/halo_dma.py::ring_copy``,
``pltpu.make_async_remote_copy``) and waits on DMA semaphores.  Under
``DCCRG_TORCH_DIST_BACKEND=ipc`` (``parallel/mesh.py``) the port's
controllers on one node do the same: every controller owns one receive
arena, every peer maps it, and a sender writes its rows for a peer
straight into that peer's arena (kernel B9's remote-write form,
``halo_dma.ring_put``, or a device-to-device copy).  Only small tokens
cross between the processes, never the payload: a generation and its
bytes, or an ack.  They travel over local stream sockets, one a controller
pair (Linux's abstract namespace: no file, gone with the process), set up
through the gloo group with the arenas, because every exchange waits for
one token and gloo's point-to-point round trip is the slower
(``chip_smoke.py`` phase 34 logs both on the card).

**Layout.**  An arena holds a channel a sending controller (its own rank
included: the halo's local rows), each of two parity regions of ``cap``
bytes: channel c, parity p lies at ``(2 c + p) * cap``.  The k-th batch a
controller sends to a peer is that pair's generation k (both sides count
the batches with rows between them); it lands in parity ``k % 2``, its
messages one after the other in batch order, each at an arena offset
aligned to ``lcm(16, row bytes)``, so a row of any message is a whole row
of the arena read as that dtype (the merge reads one typed view of the
whole arena).  Both sides compute every offset from the batch's message
sizes and the shared ``cap``.

**Ordering** (the invariants the tests hold):

* (a) no read before the write landed: the sender records its write event
  for the pair and parity after its writes, then sends ``(generation,
  bytes)``; the receiver waits on that event only after the token has
  arrived (an event not yet recorded would not hold a wait), and queues its
  reads after it;
* (b) no overwrite while the receiver may still read: after its reads the
  receiver records its read event for the pair and parity and sends an
  ack; before generation k + 2 the sender waits for ack k and then for that
  event.  A controller holds at most two batches in flight
  (a third raises: two controllers each waiting for the other's ack would
  otherwise hang);
* (d) arenas grow collectively (:meth:`Arena.reserve`): every controller
  computes the same need from the replicated schedule, so all grow at the
  same point, with no batch in flight; handles are exported and opened
  anew;
* (f) nothing waits on device memory: a controller blocks in the socket's
  receive (with the group's timeout: a peer that died raises) and then in
  the peer's event, on the host; its own streams never wait on another
  process (the processes sharing a card run in time slices).

On the card the arena is a ``cudaMalloc`` of its own (``csrc/ipc.cu``:
never the caching allocator, whose handles name whole segments), opened by
the peers with lazy peer access, and the events are interprocess events.
On CPU tensors it is a shared file mapping
(``torch.UntypedStorage.from_file(..., shared=True)``) under
``DCCRG_TORCH_IPC_DIR`` (default: the temporary directory), unlinked as
soon as every peer has mapped it, so a killed controller leaves nothing
behind; writes and reads are synchronous there, so the tokens alone order
them.  Each tensor's device decides; nothing falls back: an arena that
cannot be made, exported or opened raises on every controller.
"""
from __future__ import annotations

import collections
import ctypes
import math
import os
import socket
import struct
import tempfile
import uuid

import torch

__all__ = ["Arena", "Batch", "IpcError", "ENV_DIR", "channel_bound"]

#: the directory of the CPU arenas' files
ENV_DIR = "DCCRG_TORCH_IPC_DIR"
#: the tokens' kinds: a sender's generation landed (with its bytes), a
#: receiver's generation read
DONE, ACK = 1, 2
_TOKEN = struct.Struct("<qqq")
#: the first channel of an arena, bytes, by device type: on the card
#: large enough that the bench's exchanges (up to a 16.8 MB cohort step a
#: pair) never grow it mid-run, since a growth synchronises the card and
#: reallocates and reopens every arena (2 x P channels of it a controller)
FIRST_CAP = {"cuda": 32 << 20, "cpu": 64 << 10}
#: channel sizes are a multiple of this
CAP_QUANTUM = 4096
#: batches one controller may hold in flight (posted, not yet released)
MAX_IN_FLIGHT = 2


def _peer_wait(ev) -> None:
    """Wait on the host for a peer's event (its writes or its reads), not
    on a stream: the processes sharing a card run in time slices, and a
    stream blocked on another process's event keeps its slice.  On an
    H100 (``kernel_probe.py ipc-wait``: 2 controllers x 4 slots, phase 34's
    twenty cases, controller 0's wall ms summed) host waits took 123.76 and
    125.42 ms, stream waits 132.14 and 136.44."""
    _ok("event synchronise", _cuda().ipc_event_sync(ev))


class IpcError(RuntimeError):
    """The device-direct transport cannot go on (no arena, a handle that
    does not open, a token that does not match)."""


def _align(rb: int) -> int:
    return math.lcm(16, max(int(rb), 1))


def channel_bound(msgs) -> int:
    """Bytes a channel needs for ``msgs``, ``(bytes, row bytes)`` pairs,
    wherever the channel starts: each message plus its alignment."""
    return sum(int(n) + _align(rb) for n, rb in msgs if int(n))


_lib = None


def _cuda():
    """The compiled ``csrc/ipc.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("ipc")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sig = {"ipc_handle_bytes": [], "ipc_alloc": [ci, ll, vp, vp],
               "ipc_free": [ci, vp], "ipc_open": [ci, vp, vp], "ipc_close": [ci, vp],
               "ipc_event_create": [ci, vp, vp], "ipc_event_open": [ci, vp, vp],
               "ipc_event_destroy": [ci, vp], "ipc_record": [vp, vp],
               "ipc_wait": [vp, vp], "ipc_event_sync": [vp], "ipc_sync": [ci]}
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ci
        _lib = lib
    return _lib


def _ok(what: str, err: int) -> None:
    if err:
        raise IpcError(f"ipc: {what} failed (cudaError_t {err})")


class _DevicePointer:
    """A device address as ``__cuda_array_interface__`` bytes, for a tensor
    that views it without owning it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (int(nbytes),), "typestr": "|u1",
                                         "data": (int(ptr), False), "version": 2}


def _view_device(ptr: int, nbytes: int) -> torch.Tensor:
    t = torch.as_tensor(_DevicePointer(ptr, nbytes))
    if t.device.type != "cuda" or t.data_ptr() != ptr:
        raise IpcError("ipc: a mapped arena did not become a device tensor in place")
    return t


def _handle_buf():
    return ctypes.create_string_buffer(_cuda().ipc_handle_bytes())


class _Tokens:
    """The tokens between this controller and each peer: a connected
    ``AF_UNIX`` stream socket a pair, each message ``(kind, generation,
    bytes)``.  :meth:`recv` keeps what arrives for another kind until it is
    asked for; every receive carries ``timeout_s``."""

    def __init__(self, rank, size, all_gather, timeout_s):
        self.rank = rank
        self.socks = {}
        self.held = collections.defaultdict(collections.deque)
        lis = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        name = f"\0dccrg-ipc-{uuid.uuid4().hex}"
        lis.bind(name)
        lis.listen(size)
        try:
            names = all_gather(name)
            # each controller dials every lower rank and answers every higher
            for q in range(rank):
                c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                c.settimeout(timeout_s)
                c.connect(names[q])
                c.sendall(struct.pack("<q", rank))
                self.socks[q] = c
            lis.settimeout(timeout_s)
            for _ in range(rank + 1, size):
                c, _ = lis.accept()
                c.settimeout(timeout_s)
                self.socks[struct.unpack("<q", self._read(c, 8))[0]] = c
        finally:
            lis.close()

    @staticmethod
    def _read(c, n):
        out = b""
        while len(out) < n:
            try:
                got = c.recv(n - len(out))
            except socket.timeout as e:
                raise IpcError("ipc: a peer's token did not come in time") from e
            if not got:
                raise IpcError("ipc: a peer closed its token socket (did it die?)")
            out += got
        return out

    def send(self, q, kind, gen, nbytes=0) -> None:
        self.socks[q].sendall(_TOKEN.pack(kind, gen, nbytes))

    def recv(self, r, kind):
        """The next ``(generation, bytes)`` of ``kind`` from peer ``r``."""
        held = self.held[(r, kind)]
        while not held:
            k, gen, nbytes = _TOKEN.unpack(self._read(self.socks[r], _TOKEN.size))
            self.held[(r, k)].append((gen, nbytes))
        return held.popleft()

    def close(self) -> None:
        for c in self.socks.values():
            c.close()
        self.socks.clear()


class Batch:
    """One transport batch's place in the arenas (:meth:`Arena.begin`):
    the byte offsets of its local messages and receives in this
    controller's arena and of its sends in each peer's, and its
    generations.  :meth:`commit` after the writes, :meth:`wait` before the
    reads, :meth:`release` after them."""

    __slots__ = ("arena", "stream", "send_peers", "recv_peers", "gens_out", "gens_in",
                 "gen_own", "send_pos", "recv_pos", "local_pos", "send_bytes",
                 "recv_bytes")

    def _stream_ptr(self, stream):
        return 0 if stream is None else stream.cuda_stream

    def commit(self) -> None:
        """The writes are queued (on :meth:`Arena.begin`'s stream): record
        each peer's write event and send each its token."""
        a = self.arena
        for q in self.send_peers:
            g = self.gens_out[q]
            if a.cuda:
                _ok("event record", _cuda().ipc_record(a._ev_write[(q, g % 2)],
                                                       self._stream_ptr(self.stream)))
            a._tokens.send(q, DONE, g, self.send_bytes[q])

    def wait(self) -> None:
        """Every peer's rows for this batch have landed when this returns
        (its tokens arrived, its write events waited on, on the host)."""
        a = self.arena
        for r in self.recv_peers:
            g = self.gens_in[r]
            got, nbytes = a._tokens.recv(r, DONE)
            if got != g or nbytes != self.recv_bytes[r]:
                raise IpcError(f"ipc: controller {r} sent generation {got} of {nbytes} "
                               f"bytes where {g} of {self.recv_bytes[r]} were expected "
                               "(the batches do not match)")
            if a.cuda:
                _peer_wait(a._peer_write[(r, g % 2)])

    def release(self, stream=None) -> None:
        """The reads are queued on ``stream``: record each sender's read
        event and send it its ack (the sender may then reuse the parity)."""
        a = self.arena
        for r in self.recv_peers:
            g = self.gens_in[r]
            if a.cuda:
                _ok("event record", _cuda().ipc_record(a._ev_read[(r, g % 2)],
                                                       self._stream_ptr(stream)))
            a._tokens.send(r, ACK, g)
        if self.gen_own is not None and a.cuda:
            _ok("event record", _cuda().ipc_record(a._ev_own[self.gen_own % 2],
                                                   self._stream_ptr(stream)))
        a._in_flight -= 1

    # -------------------------------------------------------- views

    def send_view(self, i, dtype, shape) -> torch.Tensor:
        q, pos = self.send_pos[i]
        return self.arena._view(self.arena.peers[q], pos, dtype, shape)

    def recv_view(self, i, dtype, shape) -> torch.Tensor:
        return self.arena._view(self.arena.mine, self.recv_pos[i], dtype, shape)

    def local_view(self, i, dtype, shape) -> torch.Tensor:
        return self.arena._view(self.arena.mine, self.local_pos[i], dtype, shape)


class Arena:
    """This controller's receive arena, its peers' mapped arenas, the
    events and the per-pair generations (see the module docstring).  Made
    by ``mesh.setup(backend="ipc")`` on every controller at once, closed by
    ``mesh.teardown``; both are collectives of the host group."""

    def __init__(self, ctl, device, cap: int | None = None, timeout_s: float = 120.0):
        self.rank, self.size = ctl.rank, ctl.size
        self.group = ctl.host_group
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.dev = self.device.index if self.cuda else -1
        if self.cuda and self.dev is None:
            self.dev = torch.cuda.current_device()
            self.device = torch.device("cuda", self.dev)
        self.cap = 0
        #: growths so far (the first allocation is 1)
        self.epoch = 0
        self.mine = None
        self.peers = {}
        self._ptr = None
        self._peer_ptrs = {}
        self._path = None
        peers = [q for q in range(self.size) if q != self.rank]
        self._gen_out = dict.fromkeys(peers, 0)
        self._gen_in = dict.fromkeys(peers, 0)
        self._gen_own = 0
        self._in_flight = 0
        self._ev_write, self._ev_read, self._ev_own = {}, {}, {}
        self._peer_write, self._peer_read = {}, {}
        self._tokens = _Tokens(self.rank, self.size, self._all_gather, timeout_s)
        if self.cuda:
            self._make_events()
        self._remap(cap or FIRST_CAP[self.device.type])

    # -------------------------------------------------- collectives

    def _all_gather(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def _agree(self, err) -> None:
        """Raise on every controller if any failed (so none waits for the
        others in a later collective)."""
        errs = self._all_gather(None if err is None else str(err))
        bad = [(q, e) for q, e in enumerate(errs) if e is not None]
        if bad:
            raise IpcError("ipc: arena set-up failed: " + "; ".join(
                f"controller {q}: {e}" for q, e in bad))

    def _make_events(self) -> None:
        lib = _cuda()
        mine, err = {}, None
        try:
            for q in self._gen_out:
                for p in (0, 1):
                    for kind, table in (("w", self._ev_write), ("r", self._ev_read)):
                        ev, h = ctypes.c_void_p(), _handle_buf()
                        _ok("interprocess event", lib.ipc_event_create(
                            self.dev, ctypes.byref(ev), h))
                        table[(q, p)] = ev.value
                        mine[(kind, q, p)] = h.raw
            for p in (0, 1):
                ev, h = ctypes.c_void_p(), _handle_buf()
                _ok("interprocess event", lib.ipc_event_create(self.dev, ctypes.byref(ev), h))
                self._ev_own[p] = ev.value
        except IpcError as e:
            err = e
        self._agree(err)
        every = self._all_gather(mine)
        err = None
        try:
            for r, theirs in enumerate(every):
                if r == self.rank:
                    continue
                for p in (0, 1):
                    for kind, table in (("w", self._peer_write), ("r", self._peer_read)):
                        ev = ctypes.c_void_p()
                        _ok("opening a peer's event", lib.ipc_event_open(
                            self.dev, theirs[(kind, self.rank, p)], ctypes.byref(ev)))
                        table[(r, p)] = ev.value
        except IpcError as e:
            err = e
        self._agree(err)

    def _allocate(self, nbytes: int):
        """This controller's new arena: ``(tensor, handle)``."""
        if self.cuda:
            ptr, h = ctypes.c_void_p(), _handle_buf()
            _ok("arena cudaMalloc / cudaIpcGetMemHandle",
                _cuda().ipc_alloc(self.dev, nbytes, ctypes.byref(ptr), h))
            self._ptr = ptr.value
            return _view_device(self._ptr, nbytes), h.raw
        root = os.environ.get(ENV_DIR) or tempfile.gettempdir()
        path = os.path.join(root, f"dccrg-ipc-{os.getpid()}-{self.rank}-{self.epoch}")
        try:
            st = torch.UntypedStorage.from_file(path, shared=True, nbytes=nbytes)
        except (RuntimeError, OSError) as e:
            raise IpcError(f"ipc: cannot map the arena file {path}: {e}") from e
        self._path = path
        return torch.empty(0, dtype=torch.uint8).set_(st), path

    def _open(self, q: int, handle, nbytes: int) -> torch.Tensor:
        if self.cuda:
            ptr = ctypes.c_void_p()
            _ok(f"opening controller {q}'s arena",
                _cuda().ipc_open(self.dev, handle, ctypes.byref(ptr)))
            self._peer_ptrs[q] = ptr.value
            return _view_device(ptr.value, nbytes)
        try:
            st = torch.UntypedStorage.from_file(handle, shared=True, nbytes=nbytes)
        except (RuntimeError, OSError) as e:
            raise IpcError(f"ipc: cannot map controller {q}'s arena {handle}: {e}") from e
        return torch.empty(0, dtype=torch.uint8).set_(st)

    def _unmap(self) -> None:
        """Close the peers' arenas and free this one (after a barrier that
        every controller reaches with its device work done)."""
        if self.cuda:
            _ok("device synchronise", _cuda().ipc_sync(self.dev))
        self._barrier()
        self.peers.clear()
        for q, ptr in list(self._peer_ptrs.items()):
            _ok("closing a peer's arena", _cuda().ipc_close(self.dev, ptr))
        self._peer_ptrs.clear()
        self._barrier()
        self.mine = None
        if self._ptr is not None:
            _ok("freeing the arena", _cuda().ipc_free(self.dev, self._ptr))
            self._ptr = None
        self._drop_file()

    def _drop_file(self) -> None:
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None

    def _remap(self, cap: int) -> None:
        if self.mine is not None:
            self._unmap()
        self.epoch += 1
        cap = -(-int(cap) // CAP_QUANTUM) * CAP_QUANTUM
        nbytes = 2 * self.size * cap
        mine = handle = err = None
        try:
            mine, handle = self._allocate(nbytes)
        except IpcError as e:
            err = e
        self._agree(err)
        handles = self._all_gather(handle)
        err = None
        try:
            for q, h in enumerate(handles):
                if q != self.rank:
                    self.peers[q] = self._open(q, h, nbytes)
        except IpcError as e:
            err = e
        self._agree(err)
        # every peer has mapped it: the file's name can go
        self._drop_file()
        self.mine, self.cap = mine, cap

    def reserve(self, need: int) -> None:
        """Grow every arena so a channel holds ``need`` bytes.  A collective
        where it grows: every controller calls it with the same ``need``
        (from the replicated schedule) at the same point, with no batch in
        flight; a no-op (and no collective) where the channels are large
        enough."""
        need = int(need)
        if need <= self.cap:
            return
        if self._in_flight:
            raise IpcError(f"ipc: the arena must grow to {need} bytes a channel with "
                           f"{self._in_flight} batch(es) in flight")
        self._remap(max(need, 2 * self.cap))

    # ------------------------------------------------------- batches

    def _layout(self, channel: int, parity: int, msgs) -> list:
        base = (2 * int(channel) + int(parity)) * self.cap
        at, out = base, []
        for n, rb in msgs:
            a = _align(rb)
            pos = -(-at // a) * a
            out.append(pos)
            at = pos + int(n)
        if at > base + self.cap:
            raise IpcError(f"ipc: a batch of {at - base} bytes overflows the arena's "
                           f"channel of {self.cap} (the caller's reserve was too small)")
        return out

    def begin(self, local=(), sends=(), recvs=(), stream=None) -> Batch:
        """Place one batch: ``local`` ``(bytes, row bytes)`` messages into
        this controller's own channel, ``sends`` ``(peer, bytes, row
        bytes)`` into each peer's arena, ``recvs`` likewise from each peer,
        each in the order given (a peer's sends here meet its receives
        there).  Waits (on the host, for acks; on ``stream``, for events)
        until no region it returns can still be read by an earlier
        generation.  Zero-byte messages are left out of every list."""
        if self._in_flight >= MAX_IN_FLIGHT:
            raise IpcError(f"ipc: at most {MAX_IN_FLIGHT} batches may be in flight a "
                           "controller")
        b = Batch()
        b.arena, b.stream = self, stream
        by_peer = lambda items: {q: [(n, rb) for p, n, rb in items if p == q]
                                 for q in dict.fromkeys(p for p, _, _ in items)}
        out, inc = by_peer(sends), by_peer(recvs)
        b.send_peers, b.recv_peers = list(out), list(inc)
        b.gens_out = {q: self._gen_out[q] for q in out}
        b.gens_in = {r: self._gen_in[r] for r in inc}
        b.gen_own = self._gen_own if local else None
        b.send_bytes = {q: sum(n for n, _ in m) for q, m in out.items()}
        b.recv_bytes = {r: sum(n for n, _ in m) for r, m in inc.items()}
        sp = None if stream is None else stream.cuda_stream
        for q in out:
            g = b.gens_out[q]
            if g >= 2:
                got, _ = self._tokens.recv(q, ACK)
                if got != g - 2:
                    raise IpcError(f"ipc: controller {q} acknowledged generation {got} "
                                   f"where {g - 2} was expected")
                if self.cuda:
                    _peer_wait(self._peer_read[(q, g % 2)])
        if b.gen_own is not None and b.gen_own >= 2 and self.cuda:
            _ok("stream wait", _cuda().ipc_wait(self._ev_own[b.gen_own % 2], sp))
        pos = {q: iter(self._layout(self.rank, b.gens_out[q] % 2, m)) for q, m in out.items()}
        b.send_pos = [(q, next(pos[q])) for q, _, _ in sends]
        pos = {r: iter(self._layout(r, b.gens_in[r] % 2, m)) for r, m in inc.items()}
        b.recv_pos = [next(pos[r]) for r, _, _ in recvs]
        b.local_pos = (self._layout(self.rank, b.gen_own % 2, local) if local else [])
        for q in out:
            self._gen_out[q] += 1
        for r in inc:
            self._gen_in[r] += 1
        if local:
            self._gen_own += 1
        self._in_flight += 1
        return b

    @staticmethod
    def _view(buf, pos, dtype, shape) -> torch.Tensor:
        n = math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
        return buf[pos:pos + n].view(dtype).view(shape)

    def typed(self, dtype, row) -> torch.Tensor:
        """This controller's whole arena as rows of ``row`` elements of
        ``dtype`` (``[N, *row]``): a row at byte offset ``pos`` (a multiple
        of the row bytes) is row ``pos // row bytes``."""
        rb = math.prod(row) * torch.empty(0, dtype=dtype).element_size()
        n = self.mine.numel() // rb
        return self.mine[:n * rb].view(dtype).view((n,) + tuple(row))

    def close(self) -> None:
        """Collective: close the peers' arenas, free this one, destroy the
        events, close the token sockets."""
        if self.mine is not None:
            self._unmap()
        if self.cuda:
            lib = _cuda()
            for ev in (*self._peer_write.values(), *self._peer_read.values(),
                       *self._ev_write.values(), *self._ev_read.values(),
                       *self._ev_own.values()):
                lib.ipc_event_destroy(self.dev, ev)
            self._peer_write.clear()
            self._peer_read.clear()
            self._ev_write.clear()
            self._ev_read.clear()
            self._ev_own.clear()
        self._barrier()
        self._tokens.close()
