"""Elastic rescale as a first-class mechanism (a copy of the JAX
package's ``resilience/elastic.py``).

The reference dccrg's operational claim is that a restart file written
on N processes loads on *any* M (Honkonen et al., CPC 2013).  This module
makes it a scaling mechanism:

* :func:`rescale` — commit one checkpoint-lineage generation (crash-safe
  anchor: a kill mid-rescale leaves a resumable lineage), re-land grid +
  state on ``n_devices`` slots through the restart-on-any-count loader,
  re-verify the restored grid (``utils.verify.verify_grid`` inside
  ``latest_valid``), and count ``elastic.rescales{direction=up|down|same}``
  under the ``elastic.rescale`` phase.  The re-landed grid is a *fresh*
  build of the same leaf set, and its kernels are the same libraries
  (``cuda_build``: one per source, whatever the slot count), so a re-landing
  compiles nothing once the libraries are on disk.

* :class:`ElasticPolicy` — the load-driven half: maps a utilization
  signal (HBM gauges via :func:`utilization_signal`, step-latency phase
  means via :func:`step_latency_signal`, backlog via
  :func:`queue_depth_signal`) to a target count with **hysteresis**
  (``patience`` consecutive readings beyond a watermark before acting) and
  a **cooldown** after every committed rescale, so an oscillating load
  never flaps.  Decisions are counted as
  ``elastic.policy_decisions{direction}``.

Slots against devices — the one behaviour that differs from the JAX
package.  There a slot is a device of the mesh, so ``available_devices``
is ``len(jax.devices())`` and a rescale to more devices than exist is a
lost device.  Here all D slots of a grid live on one tensor on one device,
and ``Grid.initialize`` bounds no slot count.  So
:func:`available_devices` counts physical devices
(``torch.cuda.device_count()``, or 1 on the CPU), :func:`rescale` raises
:class:`DeviceLostError` when the *target device* is not visible (``cuda:1``
on a one-card machine, any CUDA device where CUDA is absent), never for a
slot count, and an :class:`ElasticPolicy` without ``max_devices`` never
grows past its current count.  :func:`rescale` lands on the grid's own
device unless the caller names another.

Degraded mode (losing devices rather than choosing to shrink) is the
supervisor's escalation path (``resilience/supervisor.py``, counted
``elastic.degraded``); the ``device.lost`` injection site
(:func:`available_devices`, or ``inject.maybe_raise`` at step
boundaries) exists to prove that branch.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

from ..obs.registry import metrics
from . import inject
from .manager import CheckpointLineage

__all__ = [
    "DeviceLostError",
    "RescaleResult",
    "available_devices",
    "rescale",
    "ElasticPolicy",
    "utilization_signal",
    "step_latency_signal",
    "queue_depth_signal",
]


class DeviceLostError(RuntimeError):
    """A device the fleet was counting on is gone (or the ``device.lost``
    fault site injected exactly that).  Handlers rescale DOWN in degraded
    mode or restart from ``latest_valid()`` — never continue on a mesh
    that no longer exists."""


def available_devices() -> int:
    """How many physical devices this process can place a grid on: the
    visible CUDA devices, or 1 (the CPU) where there are none.  A grid's
    slot count is not bounded by it.  The ``device.lost`` injection site
    fires here: an armed plane makes discovery itself report the loss,
    which is how the escalation ladder's degraded branch is driven in
    tests and soaks."""
    if inject.fires("device.lost", where="discovery"):
        raise DeviceLostError("injected fault at site 'device.lost'")
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _visible(device) -> bool:
    """Whether ``device`` (a ``torch.device``) exists in this process."""
    import torch

    if device.type == "cpu":
        return True
    if device.type != "cuda" or not torch.cuda.is_available():
        return False
    index = 0 if device.index is None else device.index
    return 0 <= index < torch.cuda.device_count()


class RescaleResult(NamedTuple):
    """What :func:`rescale` hands back: the relanded grid/state pair plus
    the evidence a harness asserts on."""

    grid: object
    state: object
    user_header: bytes
    generation: int
    n_devices_before: int
    n_devices_after: int
    direction: str        # "up" | "down" | "same"
    commit_s: float       # checkpoint-lineage commit wall time
    reland_s: float       # scan + load + verify on the new slot count


def rescale(grid, state, spec, n_devices: int, *, lineage=None,
            directory: str | None = None, keep: int = 3,
            user_header: bytes = b"", ragged=None, verify: bool = True,
            device=None) -> RescaleResult:
    """Re-land ``grid`` + ``state`` on ``n_devices`` slots of ``device``
    (default: the grid's own device) through a committed
    checkpoint-lineage generation.

    The sequence is commit → scan/load → verify: the commit makes the
    rescale crash-safe (a SIGKILL at any point leaves a lineage
    ``latest_valid()`` resumes from, at ANY slot count), the load is the
    restart-on-any-count path (``io/checkpoint.py`` leaf-set rebuild +
    repartition under the grid's load-balancing method), and ``verify``
    re-runs the grid invariant oracle on the result.  Pass an open
    :class:`CheckpointLineage` as ``lineage`` or a ``directory`` to open one
    (``keep`` generations).

    A target device that is not visible raises :class:`DeviceLostError`
    (the same error a mid-flight device loss produces), so policy bugs
    and hardware loss land in one handler.

    Under several controllers (``parallel/mesh.py``) every controller
    calls it: the commit and the re-landing are the lineage's collectives,
    and the grid re-lands on ``n_devices`` slots over the same
    controllers, each on its own device.  ``n_devices`` must then be a
    multiple of the controller count (the ``ValueError`` of
    ``Controllers.local_slots`` names both numbers).  A process group does
    not shrink, so a rescale to fewer controllers is not what this does:
    that is a relaunch from :meth:`CheckpointLineage.latest_valid`.
    """
    import torch

    controllers = getattr(grid, "controllers", None)
    if controllers is not None and controllers.multi:
        controllers.local_slots(int(n_devices))
    if lineage is None:
        if directory is None:
            raise ValueError("rescale needs a lineage= or directory=")
        lineage = CheckpointLineage(directory, keep=keep)
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"cannot rescale to {n_devices} devices")
    device = grid.device if device is None else torch.device(device)
    with metrics.phase("elastic.rescale"):
        avail = available_devices()
        if not _visible(device):
            raise DeviceLostError(
                f"rescale onto {device} requested but only {avail} "
                "device(s) are visible"
            )
        before = int(grid.n_devices)
        direction = ("up" if n_devices > before
                     else "down" if n_devices < before else "same")
        t0 = time.perf_counter()
        gen = lineage.commit(grid, state, spec,
                             user_header=user_header, ragged=ragged)
        t1 = time.perf_counter()
        new_grid, new_state, hdr, rgen = lineage.latest_valid(
            spec, n_devices=n_devices, device=device, ragged=ragged,
            load_balancing_method=grid.get_load_balancing_method(),
            verify=verify,
        )
        t2 = time.perf_counter()
        metrics.inc("elastic.rescales", direction=direction)
        metrics.gauge("elastic.n_devices", int(new_grid.n_devices))
        # refresh the per-device memory gauges after the re-landing — the
        # policy loop reads them (nothing is recorded without CUDA)
        from ..obs.hbm import sample_hbm

        sample_hbm()
    return RescaleResult(
        grid=new_grid, state=new_state, user_header=hdr, generation=rgen,
        n_devices_before=before, n_devices_after=int(new_grid.n_devices),
        direction=direction, commit_s=t1 - t0, reland_s=t2 - t1,
    )


# --------------------------------------------------------------- signals


def utilization_signal(registry=None) -> float | None:
    """Worst-device HBM utilization in [0, 1] from the ``hbm.*`` gauges
    (``obs/hbm.py``), or None without allocator stats (a process without
    CUDA) — the policy then runs on latency alone."""
    reg = registry if registry is not None else metrics
    rep = reg.report()
    used = rep["gauges"].get("hbm.bytes_in_use", {})
    limit = rep["gauges"].get("hbm.bytes_limit", {})
    fracs = [used[d] / limit[d] for d in used
             if limit.get(d) and limit[d] > 0]
    return max(fracs) if fracs else None


def step_latency_signal(target_s: float, phase: str = "halo.exchange",
                        registry=None) -> float | None:
    """The ``phase`` mean latency as a fraction of ``target_s`` (1.0 =
    exactly on target, >1 over budget) — None until the phase has
    recorded.  Phase means are cumulative, so drive this from a registry
    the workload resets per policy window, or treat it as a slow EMA."""
    reg = registry if registry is not None else metrics
    rep = reg.report()
    rec = rep["phases"].get(phase)
    if not rec or target_s <= 0:
        return None
    return rec["mean_s"] / float(target_s)


def queue_depth_signal(source, target_depth: int | None = None,
                       registry=None) -> float | None:
    """Ensemble-backlog load signal: the serving scheduler's queue depth
    as a fraction of ``target_depth``.  1.0 = exactly the backlog the fleet
    is sized for; the policy's watermark-gap + patience hysteresis then
    applies unchanged, so an oscillating queue never flaps the fleet.

    ``source`` is anything that can yield a depth: a serving scheduler
    or ensemble (``queue_depth()`` is called), a bare callable, a plain
    number, or None — None falls back to the ``ensemble.queue_depth``
    gauge in ``registry`` (default: the process registry), which the
    scheduler refreshes on every submit/admit tick.  Returns None when
    no depth is observable (the policy then holds), and
    ``target_depth`` defaults to ``DCCRG_ELASTIC_QUEUE_TARGET`` (8)."""
    if target_depth is None:
        target_depth = _env_int("DCCRG_ELASTIC_QUEUE_TARGET", 8)
    if target_depth <= 0:
        return None
    depth = None
    if source is None:
        reg = registry if registry is not None else metrics
        depth = reg.gauge_value("ensemble.queue_depth")
    elif callable(getattr(source, "queue_depth", None)):
        depth = source.queue_depth()
    elif callable(source):
        depth = source()
    elif isinstance(source, (int, float)):
        depth = source
    if depth is None:
        return None
    return float(depth) / float(target_depth)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class ElasticPolicy:
    """Hysteresis + cooldown rescale policy.

    Feed it one scalar **load** per control tick (utilization fraction,
    latency ratio, or the max of both — anything where >``high`` means
    "too hot" and <``low`` means "wasteful").  :meth:`observe` returns a
    target device count when a rescale is warranted, else None; after
    actually performing the rescale the caller reports it with
    :meth:`committed`, which starts the cooldown.

    Flap-proofing, in order:

    * **watermark gap** — ``low < high``, so one load level can never
      satisfy both directions;
    * **patience** — a watermark must be breached on ``patience``
      *consecutive* ticks before a decision; an oscillating load resets
      the streak every flip and never acts;
    * **cooldown** — after a committed rescale, no decision for
      ``cooldown_s`` seconds, bounding the worst-case rescale rate even
      under adversarial load.

    Env defaults: ``DCCRG_ELASTIC_HIGH`` (0.85), ``DCCRG_ELASTIC_LOW``
    (0.35), ``DCCRG_ELASTIC_PATIENCE`` (3), ``DCCRG_ELASTIC_COOLDOWN``
    (30 s).  Grow doubles, shrink halves (the restart-on-any-count
    loader accepts anything, but halving keeps shard-count churn — and
    with it fresh ShapeSignatures — geometric).
    """

    def __init__(self, n_devices: int, *, min_devices: int = 1,
                 max_devices: int | None = None, high: float | None = None,
                 low: float | None = None, patience: int | None = None,
                 cooldown_s: float | None = None):
        self.n_devices = int(n_devices)
        self.min_devices = max(int(min_devices), 1)
        self.max_devices = (int(max_devices) if max_devices is not None
                            else None)
        self.high = (_env_float("DCCRG_ELASTIC_HIGH", 0.85)
                     if high is None else float(high))
        self.low = (_env_float("DCCRG_ELASTIC_LOW", 0.35)
                    if low is None else float(low))
        if not self.low < self.high:
            raise ValueError(
                f"watermarks must satisfy low < high, got "
                f"low={self.low} high={self.high}"
            )
        self.patience = max(
            _env_int("DCCRG_ELASTIC_PATIENCE", 3)
            if patience is None else int(patience), 1)
        self.cooldown_s = (
            _env_float("DCCRG_ELASTIC_COOLDOWN", 30.0)
            if cooldown_s is None else float(cooldown_s))
        self._streak_high = 0
        self._streak_low = 0
        self._cooldown_until = float("-inf")

    def _max(self) -> int:
        if self.max_devices is not None:
            return self.max_devices
        try:
            return available_devices()
        except DeviceLostError:
            raise
        except Exception:  # noqa: BLE001 — no backend: stay put
            return self.n_devices

    def observe(self, load: float | None, now: float | None = None
                ) -> int | None:
        """One control tick: returns the target device count to rescale
        to, or None.  ``now`` is injectable for deterministic tests
        (defaults to ``time.monotonic()``)."""
        if load is None:
            return None
        now = time.monotonic() if now is None else float(now)
        load = float(load)
        if load > self.high:
            self._streak_high += 1
            self._streak_low = 0
        elif load < self.low:
            self._streak_low += 1
            self._streak_high = 0
        else:
            self._streak_high = self._streak_low = 0
        if now < self._cooldown_until:
            return None
        if self._streak_high >= self.patience:
            target = min(self.n_devices * 2, self._max())
            if target > self.n_devices:
                metrics.inc("elastic.policy_decisions", direction="up")
                return target
        if self._streak_low >= self.patience:
            target = max(self.n_devices // 2, self.min_devices)
            if target < self.n_devices:
                metrics.inc("elastic.policy_decisions", direction="down")
                return target
        return None

    def committed(self, n_devices: int, now: float | None = None) -> None:
        """Report a performed rescale: updates the current count, clears
        the streaks, and starts the cooldown window."""
        now = time.monotonic() if now is None else float(now)
        self.n_devices = int(n_devices)
        self._streak_high = self._streak_low = 0
        self._cooldown_until = now + self.cooldown_s
