"""Controllers: one process per GPU on a ``torch.distributed`` group.

The JAX package shards cell payloads over a 1-D ``jax.sharding.Mesh`` axis
named ``"shard"`` (its ``parallel/mesh.py``), the analogue of the
reference's MPI rank space (``dccrg.hpp:7622-7687``); under
``jax.distributed`` the mesh spans the devices of several controller
processes, ordered by process.  The port's form is a group of processes,
one a controller, each holding a contiguous block of the grid's D slots on
its own device: with P controllers, rank p holds slots ``[p * D / P, (p +
1) * D / P)`` (the JAX mesh's device order), and D must divide by P.  Every
controller builds the same leaves, epoch and tables for all D slots (the
replicated-metadata invariant) and keeps payload tensors only for its own
slots, ``[D / P, R, ...]``.

:func:`setup` joins the group from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  The
payload transport is chosen explicitly, by argument or by
``DCCRG_TORCH_DIST_BACKEND``, and never switched on failure:

* ``gloo`` (default) — payloads cross through pinned host buffers (gloo's
  point-to-point ops take CPU tensors only); any number of controllers may
  share one card;
* ``nccl`` — device to device, one card per controller (NCCL refuses two
  ranks on one GPU).

Host metadata (agreement, ``fetch``) always travels over a gloo group.  A
single controller (no group) is :data:`SINGLE`, and every entry point
taking ``controllers=None`` means :func:`current`: the group this process
joined, else :data:`SINGLE`.

:func:`launch` spawns P controllers of one command on a free ``127.0.0.1``
port, each under a hard timeout, kills every child in a ``finally`` and
returns each child's ``RESULT {json}`` line (:func:`result` prints one).
The JAX package's ``put_table`` has no counterpart: the port copies host
tables to its own device.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import tempfile
import time
from datetime import timedelta

import numpy as np

__all__ = ["BACKENDS", "ENV_BACKEND", "Controllers", "SINGLE", "current",
           "launch", "result", "setup", "teardown"]

#: the environment variable naming the payload transport
ENV_BACKEND = "DCCRG_TORCH_DIST_BACKEND"
#: legal transports
BACKENDS = ("gloo", "nccl")


class Controllers:
    """This process's place in the controller group: ``rank`` of ``size``,
    the payload ``backend`` (None without a group), the ``device`` its
    slots live on (None: the grid's own choice) and the gloo ``host_group``
    for host metadata (None: the default group)."""

    __slots__ = ("rank", "size", "backend", "device", "host_group")

    def __init__(self, rank=0, size=1, backend=None, device=None,
                 host_group=None):
        self.rank, self.size = int(rank), int(size)
        self.backend, self.device = backend, device
        self.host_group = host_group

    @property
    def multi(self) -> bool:
        return self.size > 1

    def local_slots(self, n_slots: int) -> range:
        """This controller's slots of a grid of ``n_slots``: a contiguous
        block in rank order.  Raises unless the controllers divide the
        slots evenly (the JAX mesh's rule)."""
        n_slots = int(n_slots)
        if n_slots % self.size:
            raise ValueError(
                f"{n_slots} slots do not divide over {self.size} controllers"
            )
        per = n_slots // self.size
        return range(self.rank * per, (self.rank + 1) * per)

    def slot_owner(self, n_slots: int) -> np.ndarray:
        """The controller rank of every slot, ``[n_slots]`` int64."""
        self.local_slots(n_slots)
        return np.arange(int(n_slots), dtype=np.int64) // (int(n_slots) // self.size)

    def __repr__(self):
        return (f"Controllers(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


#: the single controller: no group, today's one-process port
SINGLE = Controllers()

_current = None


def current() -> Controllers:
    """The controllers :func:`setup` joined in this process, else
    :data:`SINGLE`."""
    return _current if _current is not None else SINGLE


def _env_backend() -> str:
    v = os.environ.get(ENV_BACKEND, "gloo").strip().lower() or "gloo"
    if v not in BACKENDS:
        raise ValueError(f"{ENV_BACKEND}={v!r}: expected one of {BACKENDS}")
    return v


def setup(backend: str | None = None, device=None,
          timeout_s: float = 120.0) -> Controllers:
    """Join the controller group from ``torchrun``'s environment and return
    this process's :class:`Controllers` (also :func:`current` from now on).

    ``backend``: ``"gloo"`` or ``"nccl"`` (default ``DCCRG_TORCH_DIST_BACKEND``,
    else gloo).  ``device``: where this controller's slots live; default
    ``cuda:LOCAL_RANK`` under nccl, and under gloo ``cuda:(LOCAL_RANK mod
    the visible cards)`` (several controllers may share a card).  Every
    collective carries ``timeout_s``, so a controller that misses one fails
    instead of hanging its peers for ever."""
    global _current
    import torch
    import torch.distributed as dist

    if _current is not None:
        raise RuntimeError("controllers are already set up in this process")
    backend = _env_backend() if backend is None else str(backend).lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ["MASTER_PORT"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run controllers "
                "on the CPU"
            )
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"nccl needs one card a controller: local rank {local_rank} "
                f"of {n_cards} visible cards"
            )
        device = torch.device("cuda", local_rank % n_cards)
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl transport moves CUDA tensors only")
        torch.cuda.set_device(device)
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=float(timeout_s))
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=size, timeout=timeout, **kw)
    host_group = None
    if backend == "nccl":
        host_group = dist.new_group(backend="gloo", timeout=timeout)
        # the first point-to-point batch of an NCCL group must include
        # every rank; a collective first sets the communicator up
        dist.barrier(device_ids=[device.index])
    dist.barrier(group=host_group)
    _current = Controllers(rank, size, backend, device, host_group)
    return _current


def teardown() -> None:
    """Leave the group (a barrier first, so no peer is left mid-exchange)."""
    global _current
    import torch.distributed as dist

    if _current is None:
        return
    try:
        dist.barrier(group=_current.host_group)
    finally:
        _current = None
        dist.destroy_process_group()


def result(obj) -> None:
    """Print the one ``RESULT {json}`` line a controller reports to
    :func:`launch`."""
    print("RESULT " + json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, nproc: int, timeout_s: float = 120.0, env=None,
           cwd=None) -> list:
    """Run ``argv`` as ``nproc`` controllers on ``127.0.0.1`` (``torchrun``'s
    environment, a fresh free port) and return each rank's last ``RESULT``
    object, in rank order.

    Each child's output goes to a file, so no pipe can fill while another
    child is awaited.  A child that exits non-zero, a missing ``RESULT``
    line, or the hard ``timeout_s`` (from the start, for all children
    together) raises ``RuntimeError`` with the children's log tails; every
    child still running is killed in a ``finally``.  All children run on
    this host, so ``LOCAL_RANK`` is the rank."""
    port = _free_port()
    procs, logs = [], []
    try:
        for rank in range(int(nproc)):
            e = dict(os.environ)
            e.update(env or {})
            e.update(RANK=str(rank), WORLD_SIZE=str(nproc),
                     LOCAL_RANK=str(rank),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            e.setdefault("GLOO_SOCKET_IFNAME", "lo")
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(list(argv), stdout=log,
                                          stderr=subprocess.STDOUT, env=e,
                                          cwd=cwd))
        deadline = time.monotonic() + float(timeout_s)
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() is not None and p.returncode != 0]
            if bad:
                failed = f"controller {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"controllers still running after {timeout_s} s"
                break
            time.sleep(0.02)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"controller {bad[0]} exited with {procs[bad[0]].returncode}"
        texts = []
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            texts.append(log.read())
        if failed is not None:
            tails = "\n".join(f"--- controller {r} ---\n{t[-3000:]}"
                              for r, t in enumerate(texts))
            raise RuntimeError(f"{failed}\n{tails}")
        out = []
        for rank, text in enumerate(texts):
            lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            if not lines:
                raise RuntimeError(f"controller {rank} printed no RESULT line:\n"
                                   f"{text[-3000:]}")
            out.append(json.loads(lines[-1][len("RESULT "):]))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()

