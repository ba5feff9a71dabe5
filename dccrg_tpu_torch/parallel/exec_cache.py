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

The serving half is the JAX module's too:

* :class:`BatchStepSpec` / :class:`WideStepSpec` — a model's step in
  cohort form (``serve/ensemble.py``).  Where the JAX spec gives a member
  program that ``jax.vmap`` batches, the port's is batched over members by
  construction: ``bind(args, W)`` returns ``body(state, dts)`` stepping a
  ``[W, ...]`` member stack (``dts [W]``), with ``args`` the member tables
  under a leading axis of 1 (one shared copy, the JAX ``in_axes=None``) or
  W (a per-member stack).  The body runs the kernels with a member axis
  (B2, B3 and B7 in one launch a step for all members; B9 on member-offset
  ring tables), so a member computes what it computes alone.
* :func:`cohort_key`, :func:`default_steps_per_dispatch`,
  :func:`max_steps_per_dispatch`, :func:`run_donate_enabled` and
  :func:`record_run_donation`, the same knobs and series.
* :class:`ExecutableCache` — the Grid's record (``grid.exec_cache``,
  shared across epoch rebuilds) of the cohort bodies built, with the
  ``epoch.cache_*`` counters.  The port compiles nothing at run time, so
  it records keys: nothing is held and nothing is evicted.
* The persistent compilation cache is the CUDA build directory of
  ``cuda_build.py``: a kernel library found there loads without ``nvcc``
  (``epoch.persistent_cache{result=hit}``), one built counts a miss and
  one ``epoch.recompiles``.  :func:`enable_persistent_cache` points it at
  ``DCCRG_COMPILE_CACHE_DIR`` when that is set.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple

from ..obs.registry import metrics as _metrics

__all__ = [
    "KERNEL_SYMBOLS",
    "ExecutableCache",
    "BatchStepSpec",
    "WideStepSpec",
    "run_donate_enabled",
    "record_run_donation",
    "cohort_key",
    "args_key",
    "default_steps_per_dispatch",
    "max_steps_per_dispatch",
    "note_trace",
    "trace_counts",
    "reset_trace_counts",
    "kernel_labels",
    "enable_persistent_cache",
    "persistent_cache_dir",
    "persistent_cache_counts",
    "note_persistent",
]


class BatchStepSpec(NamedTuple):
    """A model's step entry point in cohort-batchable form.

    * ``kind`` — short model tag (``"gol"``, ``"advection.dense"``, ...).
    * ``kernel_key`` — hashable identity of the member program: two models
      with equal keys run the same body, so a cohort may step every
      member with the template member's ``bind``.
    * ``bind`` — ``bind(args, W) -> body``; ``body(state, dts) -> state``
      steps a ``[W, ...]`` member stack once, member w by ``dts[w]`` (a
      ``[W]`` tensor of ``dt_dtype`` on the grid's device; ignored by
      models that take no dt).  ``args`` is ``args`` below with a leading
      axis of 1 (shared) or W (stacked).  A bound body holds whatever it
      derives from ``args`` once (the member-offset ring tables).
    * ``args`` — this member's tables, a dict of tensors (``{}`` for the
      dense paths, whose tables are functions of the kernel key).
    * ``dt_dtype`` — numpy dtype of dt (None = unused).
    * ``steps_per_dispatch`` — the default deep-dispatch depth
      (``DCCRG_ENSEMBLE_K``).
    * ``wide`` — an optional :class:`WideStepSpec`.
    """

    kind: str
    kernel_key: tuple
    bind: object
    args: dict = {}
    dt_dtype: object = None
    steps_per_dispatch: int = 1
    wide: object = None

    def call(self, args, state, dts):
        """One member-batched step: ``bind(args, W)(state, dts)`` with W
        from ``dts`` (the solo form is W = 1 with ``args`` under a leading
        axis of 1)."""
        return self.bind(args, int(dts.shape[0]))(state, dts)


class WideStepSpec(NamedTuple):
    """Exchange-amortized split of a member step (the JAX module's).

    * ``bind`` — ``bind(args, wargs, W) -> (exchange, interior)``:
      ``exchange(state)`` refills the default-hood ghost zone of a
      ``[W, ...]`` stack once; ``interior(state, dts, j)`` is one interior
      step at loop index j since that exchange, updating every row whose
      ``steps_ok`` exceeds j and freezing the stale fringe.
    * ``budget`` — interior steps one exchange funds before owned rows go
      stale.
    * ``args`` — the wide tables (dict of tensors), shared or stacked
      like ``BatchStepSpec.args``.
    * ``local_mask`` — host ``(D, R)`` bool of owner rows: what the
      solo-replay oracle compares.
    """

    bind: object
    budget: int
    args: dict = {}
    local_mask: object = None


def args_key(args: dict) -> tuple:
    """The shapes and dtypes of a member's tables: part of every kernel
    key, so members of one cohort can always be stacked."""
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(args.items()))


def run_donate_enabled() -> bool:
    """The JAX package's ``DCCRG_RUN_DONATE`` knob (default off), read
    the same way.  Nothing in this package calls it: a solo ``run()``
    here never consumes its input state."""
    return os.environ.get("DCCRG_RUN_DONATE", "0").lower() in (
        "1", "true", "on",
    )


def record_run_donation(model: str, probe) -> None:
    """Gauge ``run.donate_effective{model}`` from ``probe``, a callable
    (or an object with ``is_deleted()``) that says whether a run's input
    storage was given up, as the JAX package does after a donated solo
    run.  No solo run here donates, so nothing here calls it.  Telemetry
    never raises."""
    try:
        gone = probe() if callable(probe) else probe.is_deleted()
        eff = 1.0 if gone else 0.0
    except Exception:  # noqa: BLE001 — telemetry must never raise
        eff = 0.0
    _metrics.gauge("run.donate_effective", eff, model=model)


def max_steps_per_dispatch() -> int:
    """Cap on the deep-dispatch depth k (``DCCRG_ENSEMBLE_K_MAX``,
    default 64)."""
    try:
        cap = int(os.environ.get("DCCRG_ENSEMBLE_K_MAX", 64))
    except ValueError:
        return 64
    return max(cap, 1)


def default_steps_per_dispatch() -> int:
    """The process-default deep-dispatch depth (``DCCRG_ENSEMBLE_K``,
    default 1), clamped to [1, :func:`max_steps_per_dispatch`]."""
    try:
        k = int(os.environ.get("DCCRG_ENSEMBLE_K", 1))
    except ValueError:
        return 1
    return max(1, min(k, max_steps_per_dispatch()))


def cohort_key(spec: "BatchStepSpec", width: int,
               steps_per_dispatch: int | None = None,
               shared_args: bool = False, donate: bool = False,
               wide_g: int = 0) -> tuple:
    """Executable-cache key of a cohort body: the member program's
    identity, the width W, the depth k, shared or stacked tables, donation
    and the wide-halo exchange depth g (the JAX key, field for field)."""
    k = int(spec.steps_per_dispatch if steps_per_dispatch is None
            else steps_per_dispatch)
    return ("ensemble.step", spec.kind, spec.kernel_key, int(width),
            max(k, 1), bool(shared_args), bool(donate), int(wide_g))

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


#: the persistent kernel cache: hits (a library loaded from the build
#: directory without nvcc) and misses (a library built)
_PERSISTENT = {"hits": 0, "misses": 0}


def note_persistent(hit: bool) -> None:
    """Count one kernel library served from the build directory (``hit``)
    or built (a miss): ``epoch.persistent_cache{result}``."""
    with _trace_lock:
        _PERSISTENT["hits" if hit else "misses"] += 1
    _metrics.inc("epoch.persistent_cache", result="hit" if hit else "miss")


def persistent_cache_counts() -> dict:
    """Process totals ``{"hits": n, "misses": n}`` of the kernel cache."""
    with _trace_lock:
        return dict(_PERSISTENT)


def persistent_cache_dir() -> str:
    """The directory the kernel libraries persist in (``cuda_build``'s
    build directory)."""
    from .. import cuda_build

    return str(cuda_build.BUILD_DIR)


def enable_persistent_cache(path: str | None = None) -> str | None:
    """Point the kernel build directory at ``path`` (default
    ``DCCRG_COMPILE_CACHE_DIR``; no-op returning None when neither is
    set), so processes that share it build each library once."""
    if path is None:
        path = os.environ.get("DCCRG_COMPILE_CACHE_DIR") or None
    if not path:
        return None
    import pathlib

    from .. import cuda_build

    os.makedirs(path, exist_ok=True)
    cuda_build.BUILD_DIR = pathlib.Path(path)
    return str(path)


class ExecutableCache:
    """The record of the cohort bodies a grid has built, keyed by
    :func:`cohort_key` and shared across epoch rebuilds, with the JAX
    class's ``epoch.cache_hits`` / ``epoch.cache_misses`` counters and
    ``epoch.cache_size`` gauge.  The port compiles nothing at run time and
    a body is two ints (``serve/ensemble.py::_Body``), so the record holds
    keys, not bodies, and never evicts: a miss is the first build of a
    key, where the JAX package traces and compiles a program."""

    def __init__(self):
        self._seen: set = set()

    def note(self, key) -> bool:
        """Count a body built under ``key``: a hit when the key was seen
        before, else a miss that records it.  Returns whether it hit."""
        if key in self._seen:
            _metrics.inc("epoch.cache_hits")
            return True
        self._seen.add(key)
        _metrics.inc("epoch.cache_misses")
        _metrics.gauge("epoch.cache_size", len(self._seen))
        return False

    def __len__(self) -> int:
        return len(self._seen)

    def __contains__(self, key) -> bool:
        return key in self._seen

    def clear(self) -> None:
        self._seen.clear()


# the kernel build directory from the environment at import (no-op when
# DCCRG_COMPILE_CACHE_DIR is unset): child processes share it that way
if os.environ.get("DCCRG_COMPILE_CACHE_DIR"):
    enable_persistent_cache()
