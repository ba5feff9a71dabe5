"""Ensemble serving: many independent scenarios stepped as member stacks.

A port of the JAX package's ``serve/ensemble.py``.  Many independent
simulation instances (parameter sweeps, per-user scenarios, Monte Carlo
ensembles) are multiplexed onto one card, the "rapid and flexible
simulation development" use case the dccrg paper targets (Honkonen et al.,
CPC 2013).  Bucketed table shapes make independent grids land on a shared
:class:`~dccrg_tpu_torch.parallel.shapes.ShapeSignature`, so one member
program serves a whole fleet:

* **Cohorts** group admitted scenarios by signature and the member
  program's :class:`~dccrg_tpu_torch.parallel.exec_cache.BatchStepSpec`
  ``kernel_key``, and step every member through one cohort body over a
  leading member axis: the state is ``[W, ...]`` stacks, ``dts`` ``[W]``,
  the tables one shared copy (a leading axis of 1) or a ``[W, ...]``
  stack.  Where the JAX package batches its member program with
  ``jax.vmap``, the port's member programs are batched by construction:
  the dense kernels (B2, B3, B7) take the member axis in one launch a step,
  the halo's grouped gather (B9) moves every member's ghost rows on
  member-offset ring tables, and the gather steps broadcast their tables
  over the member axis.  Members may carry different table contents at
  one signature (different AMR patterns) without a new body.

* **Admission and retirement never rebuild a body**: widths ride a
  power-of-two ladder with shrink hysteresis, inactive slots are frozen by
  the occupancy mask, and admitting or retiring a member writes or copies
  one slot of the stacks.  A body is built once a cohort and noted under
  :func:`~dccrg_tpu_torch.parallel.exec_cache.cohort_key` in the grid's
  executable cache.

* **Scheduler** runs the request queue: scenarios are admitted into the
  matching cohort, cohorts step round-robin or by earliest member
  deadline, finished members retire without disturbing the rest, and the
  backlog depth feeds :func:`~dccrg_tpu_torch.resilience.elastic.
  queue_depth_signal`.

* **Telemetry** is the JAX package's: counters ``ensemble.admitted`` /
  ``retired`` / ``rejected{reason}`` / ``steps_served{tenant}``, gauges
  ``ensemble.queue_depth`` and ``ensemble.cohort_occupancy{signature}``,
  the request-latency histograms ``ensemble.queue_wait_s{tenant}`` /
  ``service_s{tenant, model}`` / ``e2e_s{tenant}`` at
  ``obs.slo.SLO_RESOLUTION``, the ``request.*`` timeline spans and the
  flight recorder's in-flight table, deadline misses
  (``ensemble.deadline_miss{tenant}``, ``ensemble.slo_violations{class}``,
  with ``DCCRG_SLO_QUEUE_S`` / ``DCCRG_SLO_E2E_S``) counted, never raised,
  and the ``ensemble.admit`` / ``ensemble.step`` / ``ensemble.verify``
  phases.

* **Deep dispatch**: one host dispatch advances a cohort k steps
  (``DCCRG_ENSEMBLE_K``, capped by ``DCCRG_ENSEMBLE_K_MAX``).  The body is
  a Python loop of k member-batched steps; per-member ``remaining``
  budgets freeze a member mid-block the moment its budget is spent, as
  the occupancy mask freezes empty slots (``torch.where``, as the JAX
  ``freeze_tree``; a step where every slot is live skips the select).
  :meth:`Scheduler.select_k` clamps k to the deepest step any member can
  use and to the earliest deadline's slack.

* **Exchange amortization**: when a member program ships a
  :class:`~dccrg_tpu_torch.parallel.exec_cache.WideStepSpec`
  (``parallel/wide_halo.py``), the body becomes ``ceil(k/g)`` blocks of
  [one wide exchange, then up to g interior steps]; owned rows stay
  bitwise equal to exchange-every-step stepping, and
  ``halo.exchanges_per_step`` records the amortization.

* **Donation**: each step's output replaces the cohort's stacks and the
  previous buffers are dropped at once, so no second copy of the fleet
  state outlives a step (``DCCRG_ENSEMBLE_DONATE=0`` keeps the
  pre-dispatch stacks alive until the dispatch ends).  Whether the
  pre-dispatch buffers were really released is measured (a weak reference
  to one of them) and feeds the per-member HBM gauge.

* **Shared tables**: a cohort starts with one copy of the member tables
  (a leading axis of 1, broadcast); a joiner whose tables differ by
  content promotes the cohort to a per-member stack
  (``ensemble.cohort_promotions``).  ``ensemble.hbm_bytes_per_member
  {model}`` counts what torch holds: unique table storage, the
  member-offset ring tables of the bound body and the stacked state, over
  the width.

* **Several controllers** (``parallel/mesh.py``): every controller runs
  the same scheduler over its own slots of every member (stacks ``[W,
  len(slots), ...]``), submits the same scenarios in the same order and so
  forms the same cohorts (their keys are asserted equal when a cohort
  forms).  What reads a clock or the cost model — the tick's cohort order,
  :meth:`Scheduler.select_k`'s depth and the admission advice — is decided
  on controller 0 and reaches the others in one small message a tick
  (``utils.collectives.from_root``), so every controller issues the same
  collectives in the same order.  Readbacks of a member's result are the
  grid's collectives; the solo-replay oracle replays the same member on
  every controller.

Correctness anchor: a cohort-stepped scenario is **bit-identical** to the
same member stepped alone.  ``DCCRG_ENSEMBLE_VERIFY=1`` (or
``Ensemble(verify=True)``) replays one sampled active member per dispatch
through the member program at W = 1 and byte-compares every field
(``ensemble.verify_mismatches{field}``, counted, never raised).
"""
from __future__ import annotations

import itertools
import os
import time
import weakref
from collections import deque

import numpy as np
import torch

from ..obs import cost as obs_cost
from ..obs import stream as obs_stream
from ..obs.events import timeline
from ..obs.flightrec import recorder as flightrec
from ..obs.hbm import sample_ensemble_hbm
from ..obs.registry import metrics
from ..obs.slo import SLO_RESOLUTION
from ..parallel.exec_cache import (
    BatchStepSpec,
    cohort_key,
    max_steps_per_dispatch,
)
from ..parallel.halo import record_dispatch_exchanges
from ..parallel.halo_dma import AS_SIGNED
from ..parallel.wide_halo import halo_depth_cap, wide_enabled

# the request-latency series resolve finer than the octave default so
# exported p99 estimates sit within one ~9% bucket (obs/slo.py); the same
# registration in every serving process keeps cross-process merges exact
for _h in ("ensemble.queue_wait_s", "ensemble.service_s",
           "ensemble.e2e_s", "ensemble.queue_latency"):
    metrics.set_histogram_resolution(_h, SLO_RESOLUTION)

__all__ = [
    "Scenario",
    "Cohort",
    "Scheduler",
    "Ensemble",
    "cohort_width",
    "verify_enabled",
    "donation_enabled",
    "shared_tables_enabled",
]


def verify_enabled() -> bool:
    """Whether the solo-replay oracle is armed process-wide
    (``DCCRG_ENSEMBLE_VERIFY=1``)."""
    return os.environ.get("DCCRG_ENSEMBLE_VERIFY", "0") == "1"


def donation_enabled() -> bool:
    """Whether cohort bodies drop the pre-dispatch stacks as each step
    replaces them (``DCCRG_ENSEMBLE_DONATE``, default on)."""
    return os.environ.get("DCCRG_ENSEMBLE_DONATE", "1") != "0"


def shared_tables_enabled() -> bool:
    """Whether cohorts start with ONE shared copy of the member tables
    instead of a per-member stack (``DCCRG_ENSEMBLE_SHARED``, default on).
    A joiner with different tables promotes the cohort to the stack."""
    return os.environ.get("DCCRG_ENSEMBLE_SHARED", "1") != "0"


def _slo_target(name: str) -> float | None:
    """Optional SLO target in seconds (``DCCRG_SLO_QUEUE_S`` /
    ``DCCRG_SLO_E2E_S``); None when unset or unparsable."""
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _shrink() -> float:
    try:
        s = float(os.environ.get("DCCRG_ENSEMBLE_SHRINK", 0.5))
    except ValueError:
        return 0.5
    return min(max(s, 0.0), 1.0)


def cohort_width(n: int, prev: int | None = None) -> int:
    """Cohort slot budget for ``n`` members: the next power of two, with
    shrink hysteresis against the held width ``prev`` (occupancy wiggling
    around a ladder boundary must not flap the stacked shapes).
    Idempotent: ``cohort_width(w, w) == w``."""
    n = max(int(n), 1)
    w = 1
    while w < n:
        w *= 2
    if prev is not None and prev >= w:
        if w == prev or n >= _shrink() * prev:
            return prev
    return w


# ------------------------------------------------------------ pytrees
# a member's state is a dict of tensors; a cohort's tables are a dict, or
# the (legacy, wide) pair of dicts when wide halos engage

def _tmap(fn, tree, *rest):
    if isinstance(tree, tuple):
        return tuple(_tmap(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree[k] for k in sorted(tree)]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors`` (a shared table's
    broadcast view counts once)."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += st.nbytes()
    return total


class Scenario:
    """One admitted (or pending) simulation instance.

    ``model`` is a bound workload instance (``Advection`` / ``GameOfLife``
    / ``Vlasov``) exposing ``batch_step_spec()``; ``state`` its state
    dict; ``steps`` how many steps to serve; ``dt`` the member's own
    timestep (ignored by models that take none); ``deadline`` an optional
    absolute ``time.perf_counter()`` stamp used by the deadline policy.

    Lifecycle: ``queued`` -> ``active`` -> ``done`` (``result`` holds the
    final state), or ``rejected`` (``reject_reason`` says why — counted,
    never raised).  ``id`` is the request id every lifecycle span,
    histogram sample and flight-recorder entry carries."""

    _ids = itertools.count()

    def __init__(self, model, state, steps: int, dt=None,
                 tenant: str = "default", deadline: float | None = None):
        self.id = next(Scenario._ids)
        self.model = model
        self.state = state
        self.steps = int(steps)
        self.dt = dt
        self.tenant = str(tenant)
        self.deadline = deadline
        self.status = "queued"
        self.reject_reason = None
        self.steps_done = 0
        self.result = None
        self.submitted_at = time.perf_counter()
        self.admitted_at = None
        self.retired_at = None
        #: filled at submit: the member program + per-member tables
        self.spec: BatchStepSpec | None = None
        self.signature = None

    @property
    def remaining(self) -> int:
        return max(self.steps - self.steps_done, 0)


def _wide_of(spec):
    """The spec's :class:`WideStepSpec` when exchange amortization engages
    for it, else None: a wide plan, the ``DCCRG_ENSEMBLE_WIDE`` switch and
    a budget of at least 2 interior steps."""
    wide = getattr(spec, "wide", None)
    if wide is not None and wide_enabled() and int(wide.budget) >= 2:
        return wide
    return None


def _state_sig(state) -> tuple:
    """Hashable field/shape/dtype identity of a state dict."""
    return tuple((k, tuple(state[k].shape), str(state[k].dtype))
                 for k in sorted(state))


class _Body:
    """A cohort body: ``k`` member-batched steps (``g >= 2``: ``ceil(k/g)``
    blocks of one wide exchange and up to g interior steps), every slot
    frozen once its budget is spent.  What the grid's executable cache
    holds under :func:`cohort_key`; the member tables come bound."""

    __slots__ = ("k", "g")

    def __init__(self, k: int, g: int):
        self.k, self.g = int(k), int(g)

    def __call__(self, bound, state, remaining, dts, mask, live_of):
        k, g = self.k, self.g
        if g >= 2:
            exchange, interior = bound[1], bound[2]
            for lo in range(0, k, g):
                live = mask & (remaining > lo)
                if not live.any():
                    break
                state = _freeze(live_of(live), exchange(state), state)
                for i in range(min(g, k - lo)):
                    live = mask & (remaining > lo + i)
                    if not live.any():
                        break
                    state = _freeze(live_of(live), interior(state, dts, i), state)
            return state
        body = bound[0]
        for i in range(k):
            live = mask & (remaining > i)
            if not live.any():
                break
            state = _freeze(live_of(live), body(state, dts), state)
        return state


def _freeze(live, new, old):
    """``new`` where the slot is live, else ``old`` (the JAX package's
    ``freeze_tree``); ``live`` None means every slot is live, and a field
    the step did not replace is taken as it is.  Unsigned fields select
    through their signed view (CUDA has no ``where`` for uint32)."""
    if live is None:
        return new
    out = {}
    for k, n in new.items():
        o = old[k]
        if n is o:
            out[k] = n
            continue
        m = live.view((-1,) + (1,) * (n.dim() - 1))
        s = AS_SIGNED.get(n.dtype)
        out[k] = (torch.where(m, n, o) if s is None
                  else torch.where(m, n.view(s), o.view(s)).view(n.dtype))
    return out


def _bound_tables(bound) -> list:
    """The member-offset ring tables a bound member program holds (its
    closures' :class:`~dccrg_tpu_torch.parallel.halo.MemberExchange`)."""
    from ..parallel.halo import MemberExchange

    out = []
    for fn in bound:
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                obj = cell.cell_contents
            except ValueError:
                continue
            if isinstance(obj, MemberExchange):
                out += [t for ts in obj.tables.values() for t in ts
                        if t is not None]
    return out


class Cohort:
    """A fleet of same-program scenarios stepping as one stacked batch.

    Holds ``[W, ...]``-stacked member state (and tables: one shared copy
    under a leading axis of 1, or a ``[W, ...]`` stack), host-side
    occupancy bookkeeping, and the cohort bodies from the template grid's
    executable cache.  Admission writes a member into a free slot;
    retirement copies its final state out; neither touches a body."""

    def __init__(self, scenario: Scenario, width: int | None = None,
                 shared: bool | None = None, k: int | None = None):
        spec = scenario.spec
        self.spec = spec
        self.signature = scenario.signature
        self.sig_label = (self.signature.label()
                          if self.signature is not None else "unknown")
        grid = scenario.model.grid
        self.device = grid.device
        self.exec_cache = grid.exec_cache
        self.W = cohort_width(1) if width is None else int(width)
        self.state_sig = _state_sig(scenario.state)
        self.dt_dtype = np.dtype(spec.dt_dtype if spec.dt_dtype is not None
                                 else np.float32)
        #: default dispatch depth
        self.k = max(int(k if k is not None else spec.steps_per_dispatch), 1)
        self._donate = donation_enabled()
        #: None until the first donated dispatch measures whether the
        #: pre-dispatch stacks were released
        self._donate_effective: bool | None = None
        self.members: list = [None] * self.W
        self._remaining = np.zeros(self.W, np.int64)
        self._occupied = np.zeros(self.W, bool)
        self._dts = np.zeros(self.W, self.dt_dtype)
        self._dts_dev = None
        #: the member program's wide-halo plan when exchange amortization
        #: engages for this cohort, else None
        self._wide = _wide_of(spec)
        #: min exchange budget over admitted members
        self._wide_budget = (int(self._wide.budget)
                             if self._wide is not None else 0)
        #: the template member's tables as submitted (the content key
        #: joiners are checked against, and the stacking source on
        #: promotion): ``(legacy, wide)`` when wide halos engage
        self._args_src = self._combined_args(spec)
        self.shared_args = (shared_tables_enabled() if shared is None
                            else bool(shared))
        if self.shared_args:
            self._args = _tmap(lambda x: x[None], self._args_src)
        else:
            self._args = _tmap(lambda x: torch.stack([x] * self.W), self._args_src)
        # stacked state: slot 0's values repeated as padding (pad slots
        # are frozen; their contents only need to be finite)
        self._state = _tmap(lambda x: torch.stack([x] * self.W), scenario.state)
        #: the member program bound to the current tables (rebuilt after a
        #: stacked admission or a promotion)
        self._bound = None
        self._kernels: dict = {}
        self._verify_rr = 0
        #: EMA of wall seconds per interior step (dispatch-side)
        self.step_s_ema: float | None = None
        #: highest occupied fraction this cohort ever reached
        self.peak_occupancy = 0.0
        self._member_bytes_cache = None
        self._sample_hbm()

    def _combined_args(self, spec):
        """The tables one member contributes: the legacy dict, or the
        ``(legacy, wide)`` pair when this cohort runs wide bodies."""
        if self._wide is None:
            return spec.args
        return (spec.args, spec.wide.args)

    def _bind(self):
        """The member program bound to the cohort's tables at width W:
        ``(body, exchange, interior)`` (the last two None without wide
        halos); built once per table set."""
        if self._bound is None:
            if self._wide is None:
                self._bound = (self.spec.bind(self._args, self.W), None, None)
            else:
                largs, wargs = self._args
                ex, it = self._wide.bind(largs, wargs, self.W)
                self._bound = (self.spec.bind(largs, self.W), ex, it)
            self._member_bytes_cache = None
        return self._bound

    def _wide_g(self, k: int) -> int:
        """Exchange depth for a depth-``k`` dispatch: clamped to the
        member-min budget and ``DCCRG_HALO_DEPTH``; 0 below 2."""
        if self._wide is None:
            return 0
        g = min(int(k), self._wide_budget, halo_depth_cap())
        return g if g >= 2 else 0

    def _kernel_for(self, k: int):
        """The depth-``k`` cohort body, built once a cohort and noted in
        the grid's executable cache under (kernel_key, W, k, shared,
        donate, wide_g)."""
        k = max(int(k), 1)
        g = self._wide_g(k)
        kern = self._kernels.get((k, g))
        if kern is None:
            # a wide cohort's legacy-depth body must not share a key with
            # a plain cohort's body at the same (kernel_key, W, k)
            key_g = g if g else (-1 if self._wide is not None else 0)
            self.exec_cache.note(cohort_key(self.spec, self.W, k, self.shared_args,
                                            self._donate, wide_g=key_g))
            kern = self._kernels[(k, g)] = _Body(k, g)
        return kern

    # ------------------------------------------------- runtime tables

    def _args_match(self, args) -> bool:
        """Whether a joiner's tables are content-identical to the shared
        copy: object identity first, a byte compare otherwise."""
        a, b = _leaves(self._args_src), _leaves(args)
        if len(a) != len(b):
            return False
        for x, y in zip(a, b):
            if x is y:
                continue
            if (x.shape != y.shape or x.dtype != y.dtype
                    or not torch.equal(x, y.to(x.device))):
                return False
        return True

    def promote_to_stacked(self) -> None:
        """Re-land the shared tables as a per-member ``[W, ...]`` stack so
        a joiner with different tables can occupy a slot (loss-free: every
        current member shares the template tables).  Counted
        ``ensemble.cohort_promotions``."""
        if not self.shared_args:
            return
        self._args = _tmap(lambda x: torch.stack([x] * self.W), self._args_src)
        self.shared_args = False
        self._kernels = {}
        self._bound = None
        metrics.inc("ensemble.cohort_promotions")
        self._member_bytes_cache = None
        self._sample_hbm()

    # --------------------------------------------------------- memory

    def member_hbm_bytes(self, in_flight: bool | None = None) -> int:
        """Device bytes per member that torch holds for this cohort: the
        distinct table storage (shared tables count once), the bound
        body's member-offset ring tables and the stacked state, over W.
        ``in_flight`` prices one step's output beside the state (2x state)
        unless donation was measured effective."""
        cached = self._member_bytes_cache
        if cached is None:
            tabs = _leaves(self._args)
            if self._bound is not None:
                tabs += _bound_tables(self._bound)
            args_b = _storage_bytes(tabs)
            state_b = sum(x.numel() * x.element_size() for x in self._state.values())
            cached = self._member_bytes_cache = (args_b, state_b)
        args_b, state_b = cached
        factor = 1 if (in_flight is False or self._donate_effective) else 2
        return int((args_b + state_b * factor) / max(self.W, 1))

    def member_hbm_bytes_stacked_tables(self) -> int:
        """What a per-member table stack without donation would hold per
        member: the full table set plus the double-buffered state over W
        (the baseline the shared tables and donation are measured
        against)."""
        args_b = sum(x.numel() * x.element_size() for x in _leaves(self._args_src))
        if self._member_bytes_cache is None:
            self.member_hbm_bytes()
        _args, state_b = self._member_bytes_cache
        return int(args_b + state_b * 2 / max(self.W, 1))

    def _sample_hbm(self) -> None:
        sample_ensemble_hbm(self.spec.kind, self.member_hbm_bytes())

    # -------------------------------------------------------- membership

    def compatible(self, scenario: Scenario) -> bool:
        return (scenario.spec is not None
                and scenario.spec.kind == self.spec.kind
                and scenario.spec.kernel_key == self.spec.kernel_key
                and _state_sig(scenario.state) == self.state_sig
                and (_wide_of(scenario.spec) is None) == (self._wide is None))

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self._occupied)

    @property
    def occupancy(self) -> int:
        return int(self._occupied.sum())

    def admit(self, scenario: Scenario, slot: int) -> None:
        """Write one member into ``slot``: its state and dt land in the
        stacks; its tables land in the stack (stacked mode) or are
        content-checked against the shared copy (a different joiner first
        promotes the cohort).  Shapes never change."""
        slot = int(slot)
        if self._occupied[slot]:
            raise ValueError(f"slot {slot} already occupied")
        joiner_args = self._combined_args(scenario.spec)
        if self.shared_args and not self._args_match(joiner_args):
            self.promote_to_stacked()
        if self._wide is not None:
            self._wide_budget = min(self._wide_budget,
                                    int(scenario.spec.wide.budget))
        self.members[slot] = scenario
        self._occupied[slot] = True
        self._remaining[slot] = scenario.remaining
        self._dts[slot] = (self.dt_dtype.type(scenario.dt)
                           if scenario.dt is not None else 0)
        self._dts_dev = None

        def set_slot(S, x):
            S[slot] = x.to(S.device)
            return S

        if not self.shared_args:
            _tmap(set_slot, self._args, joiner_args)
            self._bound = None
        _tmap(set_slot, self._state, scenario.state)
        scenario.status = "active"
        if scenario.admitted_at is None:
            scenario.admitted_at = time.perf_counter()
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.occupancy / max(self.W, 1))

    def member_state(self, slot: int):
        """A copy of one slot's current state."""
        return {k: S[int(slot)].clone() for k, S in self._state.items()}

    def retire(self, slot: int) -> Scenario:
        """Free one slot: copy the member's final state out of the stacks
        and hand the finished scenario back."""
        slot = int(slot)
        scn = self.members[slot]
        scn.result = self.member_state(slot)
        scn.status = "done"
        scn.retired_at = time.perf_counter()
        self.members[slot] = None
        self._occupied[slot] = False
        self._remaining[slot] = 0
        return scn

    def finished_slots(self) -> np.ndarray:
        return np.flatnonzero(self._occupied & (self._remaining <= 0))

    def min_deadline(self) -> float:
        dls = [m.deadline for m in self.members
               if m is not None and m.deadline is not None]
        return min(dls) if dls else float("inf")

    def min_deadline_tenant(self) -> str | None:
        """Tenant of the earliest-deadline member (None without one)."""
        best, tenant = float("inf"), None
        for m in self.members:
            if m is not None and m.deadline is not None and m.deadline < best:
                best, tenant = m.deadline, m.tenant
        return tenant

    # -------------------------------------------------------------- step

    def active_mask(self) -> np.ndarray:
        return self._occupied & (self._remaining > 0)

    def _live_of(self, live: np.ndarray):
        """The device mask of ``live`` slots, or None when every slot is
        live (the step's output is taken whole)."""
        if live.all():
            return None
        return torch.as_tensor(live, device=self.device)

    def step(self, k: int | None = None) -> int:
        """One cohort dispatch advancing every occupied slot with remaining
        work by up to ``k`` steps (default: the cohort's depth) of its own
        dt; inactive, exhausted and mid-block-exhausted slots are frozen.
        Returns the member-steps served."""
        mask = self.active_mask()
        n = int(mask.sum())
        if n == 0:
            return 0
        k = self.k if k is None else max(int(k), 1)
        g = self._wide_g(k)
        kernel = self._kernel_for(k)
        bound = self._bind()
        advanced = np.where(mask, np.minimum(self._remaining, k), 0)
        # the oracle samples its member before the dispatch: the stacks
        # are replaced as the dispatch steps
        verify_slot = pre_member = None
        if self._verify_active():
            slots = np.flatnonzero(mask)
            verify_slot = int(slots[self._verify_rr % len(slots)])
            self._verify_rr += 1
            pre_member = self.member_state(verify_slot)
        if self._dts_dev is None:
            self._dts_dev = torch.as_tensor(self._dts, device=self.device)
        probe = None
        if self._donate and self._donate_effective is None:
            probe = weakref.ref(next(iter(self._state.values())))
        remaining = np.where(mask, self._remaining, 0)
        t0 = time.perf_counter()
        with timeline.context(cohort=self.sig_label, width=self.W):
            with metrics.phase("ensemble.step"):
                state = self._state
                if self._donate:
                    # the stacks go with the loop: no second copy outlives
                    # a step
                    self._state = None
                self._state = kernel(bound, state, remaining, self._dts_dev,
                                     mask, self._live_of)
                del state
        dt_wall = time.perf_counter() - t0
        record_dispatch_exchanges(
            self.spec.kind, (k + g - 1) // g if g else k, k)
        if probe is not None:
            self._donate_effective = probe() is None
            self._member_bytes_cache = None
        if timeline.enabled or flightrec.enabled:
            args = {
                "cohort": self.sig_label, "members": n,
                "steps_per_dispatch": k,
                "member_steps": int(advanced.sum()),
                "requests": [self.members[s].id
                             for s in np.flatnonzero(mask)[:8]],
            }
            timeline.add("request.step", t0, dt_wall, args)
            flightrec.add_span("request.step", t0, dt_wall, args)
        self._remaining -= advanced
        per_step = dt_wall / k
        self.step_s_ema = (per_step if self.step_s_ema is None
                           else 0.5 * self.step_s_ema + 0.5 * per_step)
        if obs_cost.enabled():
            obs_cost.record_dispatch(self.spec.kind, self.sig_label,
                                     k, g, self.W, dt_wall)
        served: dict = {}
        for slot in np.flatnonzero(mask):
            scn = self.members[slot]
            adv = int(advanced[slot])
            scn.steps_done += adv
            served[scn.tenant] = served.get(scn.tenant, 0) + adv
        self._served_last = served
        if metrics.enabled:
            metrics.inc_many([
                ("ensemble.steps_served", v, {"tenant": t})
                for t, v in served.items()
            ])
            # per-tenant device-seconds: the dispatch held the one card
            # for dt_wall, split by the member-steps each tenant advanced
            total_adv = sum(served.values())
            if total_adv > 0:
                device_total = dt_wall * 1
                metrics.inc_many([
                    ("ensemble.device_s", device_total * v / total_adv,
                     {"tenant": t, "model": self.spec.kind})
                    for t, v in served.items()
                ])
                metrics.inc("ensemble.device_s_total", device_total)
            metrics.gauge("ensemble.steps_per_dispatch", k,
                          model=self.spec.kind)
            self._sample_hbm()
        if verify_slot is not None:
            self._verify(pre_member, verify_slot, int(advanced[verify_slot]))
        return int(advanced.sum())

    # ------------------------------------------------------------ oracle

    def _verify_active(self) -> bool:
        return self._verify_on if hasattr(self, "_verify_on") \
            else verify_enabled()

    def _verify(self, member_pre, slot: int, nsteps: int) -> int:
        """Replay the pre-sampled member ``nsteps`` steps through its
        member program alone (W = 1, exchange every step) and
        byte-compare every field of its cohort row; with wide halos, the
        owned rows of the per-row fields (ghost rows may hold block-stale
        values).  Mismatches are counted, never raised; the sample rotates
        over the active slots.  Returns the mismatch count."""
        t0 = time.perf_counter()
        if self.shared_args:
            member_args = self._args
        else:
            member_args = _tmap(lambda S: S[slot:slot + 1], self._args)
        local_mask = None
        if self._wide is not None:
            member_args = member_args[0]
            member = self.members[slot]
            wide = member.spec.wide if member is not None else self._wide
            local_mask = np.asarray(wide.local_mask)
        body = self.spec.bind(member_args, 1)
        dt = torch.as_tensor(self._dts[slot:slot + 1], device=self.device)
        solo = {k: v[None] for k, v in member_pre.items()}
        for _ in range(max(nsteps, 1)):
            solo = body(solo, dt)
        names = sorted(solo)
        mismatches = 0
        for name in names:
            av = solo[name][0].cpu().numpy()
            bv = self._state[name][slot].cpu().numpy()
            if local_mask is not None and av.shape[:2] == local_mask.shape:
                av, bv = av[local_mask], bv[local_mask]
            if av.tobytes() != bv.tobytes():
                mismatches += 1
                metrics.inc("ensemble.verify_mismatches", field=name)
        metrics.inc("ensemble.verify_checks", len(names))
        metrics.phase_add("ensemble.verify", time.perf_counter() - t0)
        if mismatches and not getattr(self, "_fr_dumped", False):
            # one postmortem per cohort, naming the audited request
            self._fr_dumped = True
            flightrec.note("ensemble.verify_mismatch",
                           cohort=self.sig_label,
                           request=self.members[slot].id
                           if self.members[slot] is not None else None,
                           fields=mismatches)
            flightrec.dump(reason="ensemble.verify_mismatch")
        return mismatches


class Scheduler:
    """Admission/retirement loop over signature-keyed cohorts.

    ``submit`` enqueues; :meth:`admit` drains the queue into matching
    cohorts (creating or growing them along the width ladder);
    :meth:`step_once` steps every cohort with active members in policy
    order (``round_robin`` or ``deadline`` — earliest member deadline
    first) and retires finished members.  :meth:`queue_depth` is the
    backlog signal the elastic policy consumes
    (:func:`~dccrg_tpu_torch.resilience.elastic.queue_depth_signal`)."""

    def __init__(self, policy: str = "round_robin",
                 max_width: int | None = None,
                 max_cohorts: int | None = None,
                 verify: bool | None = None,
                 steps_per_dispatch: int | None = None):
        if policy not in ("round_robin", "deadline"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.policy = policy
        self.max_width = (int(max_width) if max_width is not None
                          else _env_int("DCCRG_ENSEMBLE_MAX_COHORT", 1024))
        self.max_cohorts = max_cohorts
        self.verify = verify
        #: deep-dispatch depth override; None defers to each cohort's
        #: spec default (DCCRG_ENSEMBLE_K via the model providers)
        self.steps_per_dispatch = (
            max(int(steps_per_dispatch), 1)
            if steps_per_dispatch is not None else None)
        self._queue: deque = deque()
        self.cohorts: dict = {}
        self._rr = 0
        self.completed: list = []
        #: held width per cohort key (the hysteresis hints of the
        #: width ladder — survive cohort teardown like grid ring hints)
        self._width_hints: dict = {}
        #: tenants that ever had a gauged backlog: drained tenants get
        #: one more zero write so stale gauges never freeze into live
        #: windows
        self._gauged_tenants: set = set()
        #: admission wall-seconds not yet charged to a scheduling tick —
        #: stacking joiners (and compiling their bodies) is drain work
        #: the queue-wait service rate must pay for
        self._admit_busy_s: float = 0.0
        #: under several controllers: controller 0's admission verdicts
        #: since the last tick, sent with the tick's plan
        self._advice: list = []

    # ---------------------------------------------------------- requests

    def submit(self, scenario: Scenario) -> Scenario:
        """Enqueue one scenario, resolving its batch spec and signature.
        Invalid or unsupported requests are REJECTED (counted under
        ``ensemble.rejected{reason}``), never raised — the serving loop
        must survive any single bad request."""
        reason = None
        if scenario.steps <= 0:
            reason = "invalid"
        elif not hasattr(scenario.model, "batch_step_spec"):
            reason = "unsupported"
        else:
            try:
                scenario.spec = scenario.model.batch_step_spec()
                scenario.signature = scenario.model.grid.shape_signature()
            except Exception:  # noqa: BLE001 — unsupported path/model
                reason = "unsupported"
        if reason is not None:
            scenario.status = "rejected"
            scenario.reject_reason = reason
            metrics.inc("ensemble.rejected", reason=reason)
            flightrec.note("request.rejected", request=scenario.id,
                           tenant=scenario.tenant, reason=reason)
            return scenario
        self._queue.append(scenario)
        metrics.gauge("ensemble.queue_depth", self.queue_depth())
        if metrics.enabled and obs_cost.enabled() and _controller().rank == 0:
            self._advise_admission(scenario)
        self._gauge_backlog()
        # the black box tracks the request from the moment it exists:
        # a postmortem names queued victims too, not just active ones
        flightrec.begin_request(scenario.id, tenant=scenario.tenant,
                                status="queued", steps=scenario.steps,
                                model=scenario.spec.kind,
                                deadline=scenario.deadline)
        flightrec.note("request.queued", request=scenario.id,
                       tenant=scenario.tenant)
        return scenario

    def queue_depth(self) -> int:
        """Backlog: submitted-but-not-admitted scenarios.  This is the
        load signal the elastic policy reads."""
        return len(self._queue)

    def _queued_steps(self) -> dict:
        """Backlog member-steps per tenant (submitted, not admitted) —
        the numerator of the predicted queue-wait estimate."""
        out: dict = {}
        for scn in self._queue:
            out[scn.tenant] = out.get(scn.tenant, 0) + int(scn.steps)
        return out

    def _gauge_backlog(self) -> None:
        """Per-tenant backlog and predicted queue-wait gauges
       : ``ensemble.queue_depth_steps{tenant}`` is the
        member-step backlog, ``cost.predicted_queue_wait_s{tenant}``
        divides it by the measured service rate
        (:class:`~dccrg_tpu_torch.obs.cost.ServiceRateTracker`).  Tenants
        whose backlog drained are written once more at zero, so a dead
        backlog never freezes a stale prediction into live windows."""
        if not metrics.enabled:
            return
        queued = self._queued_steps()
        tenants = self._gauged_tenants | set(queued)
        if not tenants:
            return
        waits = (obs_cost.predicted_wait(queued)
                 if obs_cost.enabled() else {})
        for t in sorted(tenants):
            metrics.gauge("ensemble.queue_depth_steps",
                          queued.get(t, 0), tenant=t)
            metrics.gauge("cost.predicted_queue_wait_s",
                          float(waits.get(t, 0.0)), tenant=t)
        # drained tenants just got their zero write — drop them so an
        # idle fleet stops paying per-tick gauge writes for every
        # tenant it ever served
        self._gauged_tenants = set(queued)

    def _advise_admission(self, scn: Scenario) -> None:
        """Counted-never-raised cost-based admission ADVICE:
        estimate the request's completion — predicted queue-wait for
        its tenant plus its steps at the model's per-step estimate —
        against its deadline, and count the verdict under
        ``ensemble.admission_estimates{verdict}``.  ``ok``: fits at the
        target quantile; ``at_risk``: fits at the mean but not the
        quantile; ``late``: predicted past the deadline even at the
        mean; ``unknown``: no deadline, or the model is still cold.
        This is the estimate plumbing a future reject-with-reason
        admission policy will gate on — today nothing is refused."""
        with metrics.phase("cost.estimate"):
            verdict = "unknown"
            est = obs_cost.model.predict(scn.spec.kind)
            if (scn.deadline is not None and est is not None
                    and est.n >= obs_cost.min_samples()):
                wait = obs_cost.predicted_wait(
                    self._queued_steps()).get(scn.tenant, 0.0)
                slack = scn.deadline - time.perf_counter() - wait
                steps = max(int(scn.steps), 0)
                if slack < steps * est.mean:
                    verdict = "late"
                elif slack < steps * est.q_value:
                    verdict = "at_risk"
                else:
                    verdict = "ok"
            metrics.inc("ensemble.admission_estimates", verdict=verdict)
            if _controller().multi:
                self._advice.append(verdict)
            if verdict not in ("unknown", "ok"):
                flightrec.note("request.admission_estimate",
                               request=scn.id, tenant=scn.tenant,
                               verdict=verdict)

    def _cohort_id(self, scn: Scenario) -> tuple:
        return (scn.signature, scn.spec.kind, scn.spec.kernel_key,
                _state_sig(scn.state))

    # --------------------------------------------------------- admission

    def _grow(self, key, cohort: Cohort, need: int) -> Cohort:
        """Re-land a full cohort at the next ladder width: members keep
        their CURRENT stacked state (extracted per slot and re-admitted),
        so growth mid-flight is loss-free.  The wider body compiles once
        per (kernel_key, width) and is itself cached."""
        new_w = cohort_width(need, self._width_hints.get(key))
        if new_w <= cohort.W:
            new_w = cohort.W * 2
        if new_w > self.max_width:
            return cohort
        self._width_hints[key] = new_w
        members = [(s, cohort.members[s])
                   for s in np.flatnonzero(cohort._occupied)]
        template = members[0][1] if members else None
        if template is None:
            return cohort
        fresh = Cohort(template, width=new_w, shared=cohort.shared_args,
                       k=cohort.k)
        if self.verify is not None:
            fresh._verify_on = self.verify
        for new_slot, (old_slot, scn) in enumerate(members):
            scn.state = cohort.member_state(old_slot)
            fresh.admit(scn, new_slot)
        self.cohorts[key] = fresh
        metrics.inc("ensemble.cohort_grows")
        return fresh

    def admit(self) -> int:
        """Drain the queue into cohorts; returns how many scenarios were
        admitted this pass.  Scenarios whose cohort is full (and at the
        width cap) stay queued — that backlog IS the queue-depth signal."""
        admitted = 0
        if not self._queue:
            return 0
        _admit_t0 = time.perf_counter()
        with metrics.phase("ensemble.admit"):
            # size new (and grown) cohorts by the whole pending backlog
            # for their key, not one member at a time — a burst of 256
            # submissions lands in ONE width-256 cohort body instead of
            # walking the ladder through every intermediate width
            pending: dict = {}
            for scn in self._queue:
                key = self._cohort_id(scn)
                pending[key] = pending.get(key, 0) + 1
            still: deque = deque()
            while self._queue:
                scn = self._queue.popleft()
                key = self._cohort_id(scn)
                cohort = self.cohorts.get(key)
                if cohort is None:
                    if (self.max_cohorts is not None
                            and len(self.cohorts) >= self.max_cohorts):
                        scn.status = "rejected"
                        scn.reject_reason = "capacity"
                        metrics.inc("ensemble.rejected", reason="capacity")
                        pending[key] -= 1
                        continue
                    if _controller().multi:
                        from ..utils.collectives import assert_agreement

                        assert_agreement("cohort key", repr(key).encode())
                    width = cohort_width(
                        min(pending.get(key, 1), self.max_width),
                        self._width_hints.get(key),
                    )
                    self._width_hints[key] = width
                    cohort = Cohort(scn, width=width,
                                    k=self.steps_per_dispatch)
                    if self.verify is not None:
                        cohort._verify_on = self.verify
                    self.cohorts[key] = cohort
                free = cohort.free_slots()
                if len(free) == 0:
                    cohort = self._grow(
                        key, cohort,
                        cohort.occupancy + pending.get(key, 1),
                    )
                    free = cohort.free_slots()
                if len(free) == 0:
                    still.append(scn)     # width cap: stays in backlog
                    continue
                t_admit = time.perf_counter()
                cohort.admit(scn, int(free[0]))
                pending[key] -= 1
                admitted += 1
                metrics.inc("ensemble.admitted")
                # queue wait from the already-stamped submit/admit pair
                #: the per-tenant histogram the SLO report
                # quantiles, plus the lifecycle spans — request.queued
                # covers the whole wait retroactively (both stamps are
                # perf_counter, the timeline's native timebase)
                wait = scn.admitted_at - scn.submitted_at
                metrics.observe("ensemble.queue_latency", wait)
                metrics.observe("ensemble.queue_wait_s", wait,
                                tenant=scn.tenant)
                target = _slo_target("DCCRG_SLO_QUEUE_S")
                if target is not None and wait > target:
                    metrics.inc("ensemble.slo_violations",
                                **{"class": "queue_wait"})
                if timeline.enabled or flightrec.enabled:
                    args = {"request": scn.id, "tenant": scn.tenant}
                    timeline.add("request.queued", scn.submitted_at,
                                 wait, args)
                    done = time.perf_counter()
                    timeline.add("request.admit", t_admit,
                                 done - t_admit, args)
                    flightrec.add_span("request.queued",
                                       scn.submitted_at, wait, args)
                flightrec.begin_request(scn.id, tenant=scn.tenant,
                                        status="active",
                                        model=scn.spec.kind,
                                        cohort=cohort.sig_label,
                                        deadline=scn.deadline)
                flightrec.note("request.admit", request=scn.id,
                               tenant=scn.tenant,
                               cohort=cohort.sig_label,
                               queue_wait_s=round(wait, 6))
            self._queue = still
        self._admit_busy_s += time.perf_counter() - _admit_t0
        self._update_gauges()
        return admitted

    def _update_gauges(self) -> None:
        if not metrics.enabled:
            return
        metrics.gauge("ensemble.queue_depth", self.queue_depth())
        for cohort in self.cohorts.values():
            metrics.gauge(
                "ensemble.cohort_occupancy",
                cohort.occupancy / max(cohort.W, 1),
                signature=cohort.sig_label,
            )
            metrics.gauge(
                "ensemble.cohort_peak_occupancy",
                cohort.peak_occupancy,
                signature=cohort.sig_label,
            )
        self._gauge_backlog()

    # ---------------------------------------------------------- stepping

    def _ordered_cohorts(self) -> list:
        live = [c for c in self.cohorts.values() if c.occupancy]
        if not live:
            return []
        if self.policy == "deadline":
            return sorted(live, key=Cohort.min_deadline)
        self._rr += 1
        k = self._rr % len(live)
        return live[k:] + live[:k]

    def select_k(self, cohort: Cohort, now: float | None = None) -> int:
        """Dispatch depth for this cohort's next step: the
        configured depth (scheduler override, else the cohort's spec
        default), clamped three ways —

        * to ``DCCRG_ENSEMBLE_K_MAX`` (compile-cache cardinality);
        * to the deepest step any active member can still USE
          (``max(remaining)`` — the in-kernel budgets already stop each
          member overshooting, this clamp stops the loop burning frozen
          iterations every member would discard);
        * to the earliest member deadline's slack over the per-step
          service-time estimate (a tight-deadline member must not sit
          out a deep block it only needed the first steps of — depth
          trades dispatch overhead against retirement latency, and
          slack is the budget for that trade).  The estimate is the
          fleet cost model's ``DCCRG_COST_QUANTILE`` (default p95 —
          a clamp sized to the mean overshoots half the time) for this
          cohort's compiled-body key once ``DCCRG_COST_MIN_SAMPLES``
          samples exist at the answering fallback level; below that, or
          with ``DCCRG_COST_MODEL=0``, the cohort-local EMA exactly as
          before;
        * to the cohort's exchange budget when wide halos engage
          — a scheduled dispatch then pays exactly ONE
          exchange (``ceil(k/g) == 1``), which is the whole point of
          the amortization.  A direct ``cohort.step(k)`` past the
          budget still works (the body runs multiple exchange blocks);
          this clamp is the scheduler preferring more dispatches at
          full amortization over fewer at partial.
        """
        k = (self.steps_per_dispatch
             if self.steps_per_dispatch is not None else cohort.k)
        k = max(1, min(int(k), max_steps_per_dispatch()))
        if cohort._wide is not None:
            k = min(k, max(1, min(cohort._wide_budget,
                                  halo_depth_cap())))
        active = cohort.active_mask()
        if active.any():
            k = min(k, int(cohort._remaining[active].max()))
        deadline = cohort.min_deadline()
        per_step = cohort.step_s_ema
        queue_wait = 0.0
        if obs_cost.enabled():
            est = obs_cost.model.predict(
                cohort.spec.kind, sig=cohort.sig_label, k=k,
                g=cohort._wide_g(k), w=cohort.W)
            if est is not None and est.n >= obs_cost.min_samples():
                per_step = est.q_value
                # an ARMED cost plane spends the slack clamp from the
                # admission estimates, not just the body's cost — the
                # earliest-deadline member's usable slack is reduced by
                # its tenant's predicted queue wait (backlog it must
                # still drain behind).  Cold model or
                # DCCRG_COST_MODEL=0 keeps the EMA path untouched, and
                # either way k only changes dispatch granularity — the
                # oracle holds results byte-identical at every depth.
                tenant = cohort.min_deadline_tenant()
                if tenant is not None and deadline != float("inf"):
                    waits = obs_cost.predicted_wait(self._queued_steps())
                    queue_wait = float(waits.get(tenant, 0.0))
        if deadline != float("inf") and per_step and per_step > 0:
            now = time.perf_counter() if now is None else now
            slack = deadline - now - queue_wait
            k = 1 if slack <= 0 else min(k, max(1, int(slack / per_step)))
        return max(k, 1)

    def _tick_plan(self) -> list:
        """This tick's ``[(cohort, k)]`` in stepping order.  Under several
        controllers controller 0 decides (the order and :meth:`select_k`
        read clocks and the cost model) and sends the plan, with its
        admission verdicts since the last tick, to the others in one
        message; they count those verdicts as their own."""
        ctl = _controller()
        plan = None
        if ctl.rank == 0:
            plan = [(c, self.select_k(c)) for c in self._ordered_cohorts()]
        if not ctl.multi:
            return plan
        from ..utils.collectives import from_root

        cohorts = list(self.cohorts.values())
        msg = None
        if ctl.rank == 0:
            index = {id(c): i for i, c in enumerate(cohorts)}
            msg = ([(index[id(c)], k) for c, k in plan], self._advice)
            self._advice = []
        order, advice = from_root(msg)
        if ctl.rank != 0:
            for verdict in advice:
                metrics.inc("ensemble.admission_estimates", verdict=verdict)
        return [(cohorts[i], k) for i, k in order]

    def step_once(self) -> int:
        """One scheduling tick: step every cohort with active members
        (policy order) at its selected dispatch depth, then retire
        finished members.  Returns total member-steps served."""
        tick_t0 = time.perf_counter()
        served = 0
        tick_served: dict = {}
        for cohort, k in self._tick_plan():
            served += cohort.step(k)
            for t, v in getattr(cohort, "_served_last", {}).items():
                tick_served[t] = tick_served.get(t, 0) + v
            for slot in cohort.finished_slots():
                scn = cohort.retire(int(slot))
                self.completed.append(scn)
                metrics.inc("ensemble.retired")
                self._account_retirement(scn, cohort)
        self._update_gauges()
        # step-boundary stream flush: live tailers see windows move
        # even between the periodic ticker's beats (no-op when no
        # stream is active or DCCRG_STREAM_FLUSH_S <= 0)
        obs_stream.maybe_flush()
        if tick_served and obs_cost.enabled():
            # capacity window: charge the FULL tick wall —
            # dispatches plus retirement/gauge overhead plus any
            # admission seconds carried since the last tick — because
            # that is the rate a queued backlog actually drains at;
            # the step-cost model above keeps the bare dispatch wall
            # (it prices the compiled body, not the scheduler)
            busy = (time.perf_counter() - tick_t0) + self._admit_busy_s
            self._admit_busy_s = 0.0
            obs_cost.tracker.note(tick_served, busy)
        return served

    def _account_retirement(self, scn: Scenario, cohort: Cohort) -> None:
        """Request-level SLO accounting at retirement:
        service/e2e latency histograms, deadline-miss counting (misses
        are counted, never raised — deadlines only affected scheduling
        order before), the closing lifecycle spans, and the flight
        recorder's in-flight table."""
        if not (metrics.enabled or flightrec.enabled):
            return
        service = scn.retired_at - scn.admitted_at
        e2e = scn.retired_at - scn.submitted_at
        missed = (scn.deadline is not None
                  and scn.retired_at > scn.deadline)
        metrics.observe("ensemble.service_s", service,
                        tenant=scn.tenant, model=cohort.spec.kind)
        metrics.observe("ensemble.e2e_s", e2e, tenant=scn.tenant)
        if missed:
            metrics.inc("ensemble.deadline_miss", tenant=scn.tenant)
            metrics.inc("ensemble.slo_violations",
                        **{"class": "deadline"})
        target = _slo_target("DCCRG_SLO_E2E_S")
        if target is not None and e2e > target:
            metrics.inc("ensemble.slo_violations", **{"class": "e2e"})
        if timeline.enabled or flightrec.enabled:
            args = {"request": scn.id, "tenant": scn.tenant,
                    "model": cohort.spec.kind, "steps": scn.steps_done,
                    "deadline_missed": bool(missed)}
            timeline.add("request.retire", scn.retired_at, 0.0, args)
            timeline.add("request.e2e", scn.submitted_at, e2e, args)
            flightrec.add_span("request.e2e", scn.submitted_at, e2e,
                               args)
        flightrec.end_request(scn.id, tenant=scn.tenant,
                              status="done", steps=scn.steps_done,
                              e2e_s=round(e2e, 6),
                              deadline_missed=bool(missed))

    def run(self, max_ticks: int | None = None) -> int:
        """Admit + step until every submitted scenario finishes (or
        ``max_ticks`` scheduling ticks elapse).  Returns total
        member-steps served."""
        total = 0
        ticks = 0
        while True:
            self.admit()
            served = self.step_once()
            total += served
            ticks += 1
            idle = (served == 0 and not self._queue)
            if idle or (max_ticks is not None and ticks >= max_ticks):
                return total


def _controller():
    """This process's controllers (``parallel.mesh.current``)."""
    from ..parallel.mesh import current

    return current()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class Ensemble:
    """User-facing serving front-end over :class:`Scheduler`.

    >>> ens = Ensemble()
    >>> t = ens.submit(model, state, steps=10, dt=dt, tenant="alice")
    >>> ens.run()
    >>> final = t.result          # bit-identical to solo stepping

    ``verify=True`` (or ``DCCRG_ENSEMBLE_VERIFY=1``) arms the
    solo-replay oracle; ``policy="deadline"`` steps cohorts by earliest
    member deadline instead of round-robin; ``steps_per_dispatch=k``
    makes every scheduling tick advance cohorts k simulation steps per
    host dispatch (deep dispatch — default is each model's
    ``DCCRG_ENSEMBLE_K`` spec depth)."""

    def __init__(self, policy: str = "round_robin",
                 max_width: int | None = None,
                 max_cohorts: int | None = None,
                 verify: bool | None = None,
                 steps_per_dispatch: int | None = None):
        self.scheduler = Scheduler(policy=policy, max_width=max_width,
                                   max_cohorts=max_cohorts, verify=verify,
                                   steps_per_dispatch=steps_per_dispatch)

    def submit(self, model, state, steps: int, dt=None,
               tenant: str = "default",
               deadline: float | None = None) -> Scenario:
        scn = Scenario(model, state, steps, dt=dt, tenant=tenant,
                       deadline=deadline)
        return self.scheduler.submit(scn)

    def admit_pending(self) -> int:
        return self.scheduler.admit()

    def step(self) -> int:
        return self.scheduler.step_once()

    def run(self, max_ticks: int | None = None) -> int:
        return self.scheduler.run(max_ticks=max_ticks)

    def queue_depth(self) -> int:
        return self.scheduler.queue_depth()

    @property
    def completed(self) -> list:
        return self.scheduler.completed

    @property
    def cohorts(self) -> dict:
        return self.scheduler.cohorts
