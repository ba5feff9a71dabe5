"""The halo's device-side transport: the ring-step payload copy (CUDA).

The JAX package's ``parallel/halo_dma.py`` ships each ring step's packed
``[S_k, ...]`` payload with a Pallas kernel that issues an asynchronous
remote DMA to device ``(d + k) % D`` (its ``ring_copy``, reached through
``ring_dma_start``).  Here all D device slots sit on one tensor on one card,
so that remote copy becomes an in-device gather, kernel B9
(``csrc/halo_dma.cu``): for every ring distance k, receiving slot d and
``i < S_k``, ``payload_k[d, i] = x[(d - k) % D, send_k[(d - k) % D, i]]``.
One launch covers every ring distance of a field, from the schedule's
concatenated table of flat source rows (``HaloExchange`` builds it once per
epoch); the ghost-row scatter stays outside the kernel, as in the JAX
package; ``HaloExchange.ring_start`` picks the kernel or its twin by the
schedule's backend (the JAX package's ``ring_dma_start``).  The kernel moves
bytes with no arithmetic, so ghost copies stay bit-exact for every dtype.

Backend selection (``DCCRG_HALO_BACKEND``, the JAX package's values and
meanings):

* ``collective`` — the plain advanced-indexing gather (:func:`ring_copy_plain`,
  the port's form of the ``ppermute`` ring; always available, and the
  bit-identity oracle for the kernel);
* ``pallas`` — the device-side ring copy: kernel B9 through :func:`ring_copy`
  (on CPU tensors its plain twin).  Unlike the JAX package, an explicit
  ``pallas`` never degrades to ``collective``: on CUDA it builds and launches
  the kernel or raises;
* ``auto`` (default) — ``pallas`` for a grid on CUDA, ``collective`` for a
  grid on the CPU.

``DCCRG_HALO_VERIFY=1`` makes every non-collective exchange replay on the
collective oracle and compare bytes (``HaloExchange._verify_oracle``);
mismatches are counted on the exchange object, never raised.

Launches count in ``ops.LAUNCHES["ring_copy"]``, twin calls in
``ops.PLAIN_CALLS["ring_copy"]``.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..ops import PLAIN_CALLS
from ..ops.dense_advection import _launched, _on_cpu

__all__ = ["AS_SIGNED", "BACKENDS", "resolve_backend", "ring_copy",
           "ring_copy_plain", "verify_enabled"]

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

def ring_copy_plain(x, index):
    """Twin of :func:`ring_copy`: the collective form's advanced-indexing
    gather of the flat source rows ``index`` from ``x [D, R, ...]``."""
    PLAIN_CALLS["ring_copy"] += 1
    if x.dtype in AS_SIGNED:
        return ring_copy_plain(x.view(AS_SIGNED[x.dtype]), index).view(x.dtype)
    return x.flatten(0, 1)[index]


# ----------------------------------------------------------------- kernel

_lib = None


def _kernels():
    """The compiled ``csrc/halo_dma.cu`` (built at first use)."""
    global _lib
    if _lib is None:
        from ..cuda_build import load

        lib = load("halo_dma")
        lib.ring_copy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ring_copy.restype = ctypes.c_int
        _lib = lib
    return _lib


def ring_copy(x, index):
    """Every ring step's payload of one field in one launch: returns
    ``x.flatten(0, 1)[index]``, ``[T, *x.shape[2:]]``, for a contiguous
    ``x [D, R, ...]`` of any dtype and an int32 table ``index [T]`` of flat
    source rows.  Launches on the current stream."""
    if _on_cpu(x, index):
        return ring_copy_plain(x, index)
    if x.dim() < 2:
        raise ValueError(f"x must be [D, R, ...], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if index.dtype != torch.int32 or index.dim() != 1 or not index.is_contiguous():
        raise ValueError("index: must be a contiguous 1-D int32 tensor")
    if index.device != x.device:
        raise ValueError(f"index on {index.device}, x on {x.device}")
    out = torch.empty((index.numel(),) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = int(np.prod(x.shape[2:], dtype=np.int64)) * x.element_size()
    err = _kernels().ring_copy(
        x.data_ptr(), out.data_ptr(), index.data_ptr(), index.numel(),
        row_bytes, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _launched("ring_copy", err)
    return out

