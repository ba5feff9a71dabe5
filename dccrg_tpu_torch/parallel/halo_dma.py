"""The halo's device-side transport: the grouped row gather (CUDA).

The JAX package's ``parallel/halo_dma.py`` ships each ring step's packed
``[S_k, ...]`` payload with a Pallas kernel that issues an asynchronous
remote DMA to device ``(d + k) % D`` (its ``ring_copy``, reached through
``ring_dma_start``), and ``parallel/halo.py`` scatters the payload into the
ghost rows outside the kernel.  Here all D device slots sit on one tensor
on one card, so both halves are row gathers, and one kernel, B9
(``csrc/halo_dma.cu``), carries the whole protocol: :func:`ring_gather`
takes every field of an exchange in one launch, each field a job

* ``(x, table)`` -> ``x.flatten(0, 1)[table]``: the ring payload (``table``
  the schedule's flat send rows, B9's JAX function ``ring_copy``) or the
  whole blocking exchange (``table`` the schedule's ``full`` table over all
  ``D * R`` rows);
* ``(x, table, payload)`` -> row r is ``payload[table[r]]`` where
  ``table[r] >= 0``, else ``x``'s own row: the merge of a payload into the
  ghost rows (``table`` the schedule's ``merge`` table).

``HaloExchange`` builds the tables once per epoch and field schedule and
picks the kernel or its twin by the schedule's backend.  Between
controllers (one process a card or a block of slots, ``parallel/mesh.py``)
the same two modes surround the ring transport (``parallel/transport.py``):
each controller packs its payload with ``(x, send)`` on its own device,
the transport carries the slices bound for other controllers, and ``(x,
merge, payload)`` lands them, so B9 is launched by every controller around
every exchange.  The kernel moves
bytes with no arithmetic, so ghost copies stay bit-exact for every dtype.

Backend selection (``DCCRG_HALO_BACKEND``, the JAX package's values and
meanings):

* ``collective`` — the plain advanced-indexing gather
  (:func:`ring_gather_plain`, the port's form of the ``ppermute`` ring, on
  the same tables; always available, and the bit-identity oracle for the
  kernel);
* ``pallas`` — the device-side gather: kernel B9 through :func:`ring_gather`
  (on CPU tensors its plain twin).  Unlike the JAX package, an explicit
  ``pallas`` never degrades to ``collective``: on CUDA it builds and launches
  the kernel or raises;
* ``auto`` (default) — ``pallas`` for a grid on CUDA, ``collective`` for a
  grid on the CPU.

``DCCRG_HALO_VERIFY=1`` makes every non-collective exchange replay on the
collective oracle and compare bytes (``HaloExchange._verify_oracle``);
mismatches are counted on the exchange object, never raised.

Launches count in ``ops.LAUNCHES["ring_copy"]`` (one a launch, whatever its
field count), twin calls in ``ops.PLAIN_CALLS["ring_copy"]`` (one a grouped
call).
"""
from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from ..ops import PLAIN_CALLS
from ..ops.dense_advection import _launched, _on_cpu

__all__ = ["AS_SIGNED", "BACKENDS", "RING_MAX_FIELDS", "resolve_backend", "ring_gather",
           "ring_gather_plain", "ring_gather_plan", "verify_enabled"]

#: legal DCCRG_HALO_BACKEND values
BACKENDS = ("collective", "pallas", "auto")

#: torch has no CUDA indexing (and no CPU index_put_) for unsigned integers;
#: a halo moves bits, so unsigned fields travel as the same-width signed view
AS_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64}


def _env_backend() -> str:
    v = os.environ.get("DCCRG_HALO_BACKEND", "auto").strip().lower()
    if not v:
        return "auto"
    if v not in BACKENDS:
        raise ValueError(f"DCCRG_HALO_BACKEND={v!r}: expected one of {BACKENDS}")
    return v


def resolve_backend(device) -> str:
    """The transport a new halo schedule on ``device`` uses: the env choice,
    with ``auto`` meaning ``pallas`` (kernel B9) for a CUDA device and
    ``collective`` for the CPU.  An explicit choice is kept as it is."""
    env = _env_backend()
    if env == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "collective"
    return env


def verify_enabled() -> bool:
    """Whether every non-collective exchange cross-checks against the
    collective oracle (``DCCRG_HALO_VERIFY=1``)."""
    return os.environ.get("DCCRG_HALO_VERIFY", "0").lower() not in (
        "", "0", "false", "no",
    )


# ------------------------------------------------------------- plain twin

def _gather_plain(x, table, payload=None):
    """One job of :func:`ring_gather_plain`, uncounted."""
    if x.dtype in AS_SIGNED:
        s = AS_SIGNED[x.dtype]
        p = None if payload is None else payload.view(s)
        return _gather_plain(x.view(s), table, p).view(x.dtype)
    rows = x.flatten(0, 1)
    if payload is None:
        return rows[table]
    keep = (table < 0).view((-1,) + (1,) * (rows.dim() - 1))
    return torch.where(keep, rows, payload[table.clamp(min=0)]).view(x.shape)


def ring_gather_plain(jobs):
    """Twin of :func:`ring_gather`: each job's advanced-indexing gather (and,
    for a merge, a select), the collective backend's form."""
    PLAIN_CALLS["ring_copy"] += 1
    return [_gather_plain(*job) for job in jobs]


# ----------------------------------------------------------------- kernel

#: fields one launch carries (``kMaxFields`` in ``csrc/halo_dma.cu``); a
#: larger exchange takes several launches of the kernel
RING_MAX_FIELDS = 8

_lib = None


def _kernels():
    """The compiled ``csrc/halo_dma.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("halo_dma")
        for fn in (lib.ring_gather, lib.ring_gather_plan):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _descriptors(jobs):
    """Check the jobs, allocate their outputs, and return ``(outputs,
    descriptors)``: a row of six int64 a job with rows to move (first or 0,
    second, dst, table, rows, row bytes).  A gather over all of ``x``'s rows
    (a blocking exchange) passes ``x`` as first too: the kernel then reads a
    row whose entry is its own index beside the entry, not after it."""
    outs, desc = [], []
    for job in jobs:
        if len(job) not in (2, 3):
            raise ValueError("a job is (x, table) or (x, table, payload)")
        x, table = job[0], job[1]
        payload = job[2] if len(job) == 3 else None
        if x.dim() < 2:
            raise ValueError(f"x must be [D, R, ...], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("x: must be contiguous")
        if table.dtype != torch.int32 or table.dim() != 1 or not table.is_contiguous():
            raise ValueError("table: must be a contiguous 1-D int32 tensor")
        if table.device != x.device:
            raise ValueError(f"table on {table.device}, x on {x.device}")
        row = tuple(x.shape[2:])
        if payload is None:
            out = torch.empty((table.numel(),) + row, dtype=x.dtype, device=x.device)
            second = x.data_ptr()
            first = second if table.numel() == x.shape[0] * x.shape[1] else 0
        else:
            if table.numel() != x.shape[0] * x.shape[1]:
                raise ValueError(f"merge table of {table.numel()} rows for x of "
                                 f"{x.shape[0] * x.shape[1]}")
            if (payload.dtype != x.dtype or tuple(payload.shape[1:]) != row
                    or not payload.is_contiguous() or payload.device != x.device):
                raise ValueError("payload: must be a contiguous [T, ...] tensor of "
                                 "x's dtype, row shape and device")
            out = torch.empty_like(x)
            first, second = x.data_ptr(), payload.data_ptr()
        outs.append(out)
        if out.numel():
            desc.append((first, second, out.data_ptr(), table.data_ptr(), table.numel(),
                         math.prod(row) * x.element_size()))
    return outs, desc


def ring_gather(jobs):
    """Every job's rows in one launch of kernel B9 (``RING_MAX_FIELDS`` jobs
    a launch): ``(x, table)`` gives ``x.flatten(0, 1)[table]``,
    ``[T, *x.shape[2:]]``; ``(x, table, payload)`` gives ``x``'s shape, row r
    ``payload[table[r]]`` where ``table[r] >= 0``, else ``x``'s row r.  Any
    dtype; contiguous ``x [D, R, ...]`` and payloads; int32 tables whose
    entries lie in range (the halo schedule builds them so).  Launches on
    the current stream; on CPU tensors runs the twin."""
    if not jobs:
        return []
    if _on_cpu(*(t for job in jobs for t in job)):
        return ring_gather_plain(jobs)
    outs, desc = _descriptors(jobs)
    stream = torch.cuda.current_stream(outs[0].device).cuda_stream
    lib = _kernels()
    for at in range(0, len(desc), RING_MAX_FIELDS):
        part = np.array(desc[at:at + RING_MAX_FIELDS], dtype=np.int64)
        err = lib.ring_gather(part.ctypes.data, len(part), stream)
        _launched("ring_copy", err)
    return outs


def ring_gather_plan(jobs):
    """The split :func:`ring_gather` launches for ``jobs`` (CUDA tensors),
    without launching: a dict a job with its ``word`` bytes, ``lanes``
    (threads a row), ``rows`` (rows a thread), ``cta_begin`` and ``ctas``
    (CTAs of its launch).  For logs."""
    _, desc = _descriptors(jobs)
    plans = []
    for at in range(0, len(desc), RING_MAX_FIELDS):
        part = np.array(desc[at:at + RING_MAX_FIELDS], dtype=np.int64)
        out = np.zeros((len(part), 5), dtype=np.int32)
        err = _kernels().ring_gather_plan(part.ctypes.data, len(part), out.ctypes.data)
        if err:
            raise RuntimeError(f"ring_gather_plan: cudaError_t {err}")
        plans += [dict(zip(("word", "lanes", "rows", "cta_begin", "ctas"), map(int, r)))
                  for r in out]
    return plans
