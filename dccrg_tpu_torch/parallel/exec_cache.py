"""Compile accounting and the kernel-label table of the device timeline.

The JAX package's ``parallel/exec_cache.py`` counts every trace of a
``traced_jit`` kernel (``note_trace``, ``trace_counts``), times the
dispatches that compiled into the ``compile`` phase, counts them as
``epoch.recompiles{kernel}``, and keeps the table that maps a compiled
program's name back to its kernel label (``kernel_labels``) for the
device-timeline merge.  This is that accounting for the port.

The port's only compile is the build of a CUDA library at first use
(``cuda_build.build``): each library compiled counts one
``epoch.recompiles{kernel=<source stem>}`` and one :func:`note_trace`
under the stem, and its ``nvcc`` seconds go into the ``compile`` phase.
The kernels take their shapes at run time, so an AMR commit or a load
balance compiles nothing: ``epoch.recompiles`` stays 0 across them, where
the JAX package counts the retraces a new shape signature causes.

:func:`kernel_labels` maps each ``__global__`` symbol of ``csrc/*.cu`` to
the label its device time is attributed to in ``obs.merge``
(``device.kernel_time_us{kernel}``): the wrapper's key in
``ops.LAUNCHES``, except B9's, whose label starts with ``halo`` so that
the merge counts the ring copy as halo work, not interior compute.

The executable cache, the step specs and the persistent compilation cache
of the JAX module serve its serving plane and are not here.
"""
from __future__ import annotations

import threading

__all__ = [
    "KERNEL_SYMBOLS",
    "note_trace",
    "trace_counts",
    "reset_trace_counts",
    "kernel_labels",
]

#: ``__global__`` symbol in ``csrc/*.cu`` -> attribution label
KERNEL_SYMBOLS = {
    "dense_fused_run_kernel": "fused_run",
    # one kernel behind both per-step wrappers (flux_update and
    # flux_update_blocked)
    "dense_step_kernel": "flux_update",
    "flat_amr_run_kernel": "flat_amr_run",
    "flat_ml_run_kernel": "flat_ml_run",
    "flat_ml_plain_run_kernel": "flat_ml_run",
    "gol_run_kernel": "gol_run",
    "vlasov_tile_kernel": "vlasov_step",
    "bicg_box_kernel": "bicg_solve",
    "bicg_l2_kernel": "bicg_solve",
    "ring_gather_kernel": "halo.ring_copy",
}

_trace_lock = threading.Lock()
#: label -> number of times a kernel with that label was compiled
_TRACE_COUNTS: dict = {}


def note_trace(label: str) -> None:
    """Record one compile of the kernel ``label``."""
    with _trace_lock:
        _TRACE_COUNTS[label] = _TRACE_COUNTS.get(label, 0) + 1


def trace_counts() -> dict:
    """Snapshot of per-kernel compile counts since process start (or the
    last :func:`reset_trace_counts`)."""
    with _trace_lock:
        return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    with _trace_lock:
        _TRACE_COUNTS.clear()


def kernel_labels() -> dict:
    """Snapshot of the ``kernel symbol -> label`` table."""
    return dict(KERNEL_SYMBOLS)
