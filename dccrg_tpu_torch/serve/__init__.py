"""Ensemble serving front-end and fleet gateway (the JAX package's
``serve``).

See :mod:`dccrg_tpu_torch.serve.ensemble` for the single-process design;
the short version:

* :class:`Ensemble` — submit ``(model, state, steps)`` scenarios, run
  the loop, read bit-identical-to-solo results;
* :class:`Scheduler` — the admission/retirement engine beneath it,
  whose :meth:`~Scheduler.queue_depth` feeds the elastic policy;
* :class:`Cohort` — one signature's stacked member fleet and its
  member-batched step body;
* ``DCCRG_ENSEMBLE_VERIFY=1`` — the solo-replay byte-compare oracle.

:mod:`dccrg_tpu_torch.serve.gateway` scales that loop across per-worker
failure domains:

* :class:`Gateway` — crash-durable submissions
  (:class:`SubmissionJournal`), enforced admission, signature-affinity
  routing, worker-loss redispatch with exactly-once retirement;
* :class:`WorkerHandle` — one supervised worker process
  (:mod:`dccrg_tpu_torch.serve.worker` is its loop).
"""
from .ensemble import (
    Cohort,
    Ensemble,
    Scenario,
    Scheduler,
    cohort_width,
    donation_enabled,
    shared_tables_enabled,
    verify_enabled,
)
from .gateway import (
    Gateway,
    SubmissionJournal,
    WorkerHandle,
    admission_enabled,
    gateway_queue_max,
)

__all__ = [
    "Cohort",
    "Ensemble",
    "Gateway",
    "Scenario",
    "Scheduler",
    "SubmissionJournal",
    "WorkerHandle",
    "admission_enabled",
    "cohort_width",
    "donation_enabled",
    "gateway_queue_max",
    "shared_tables_enabled",
    "verify_enabled",
]
