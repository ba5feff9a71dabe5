"""Per-device memory gauges from the CUDA caching allocator.

A grid that barely fits device memory today silently stops fitting after
a refinement change.  ``sample_hbm`` snapshots each CUDA device's
allocator statistics into ``hbm.*{device=d}`` gauges — called at every
epoch rebuild (``parallel/epoch.py``, the moment payload tensors are
re-laid-out).  The series names are the JAX package's:

* ``hbm.bytes_in_use`` — ``torch.cuda.memory_stats(d)
  ["allocated_bytes.all.current"]`` (``torch.cuda.memory_allocated``);
* ``hbm.peak_bytes_in_use`` — ``["allocated_bytes.all.peak"]``
  (``torch.cuda.max_memory_allocated``);
* ``hbm.bytes_limit`` — the device's total memory from
  ``torch.cuda.mem_get_info(d)``.

The JAX package's fourth gauge, ``hbm.largest_free_block_bytes``, is not
recorded: the caching allocator keeps no statistic of its largest free
block (its ``*_split_bytes`` and ``max_split_size`` are other
quantities), so the gauge stays absent, as it does on the JAX package's
backends without it.

A process that has not initialised CUDA (a CPU-only run, or a CPU grid on
a machine with a card) records nothing and returns ``{}``: sampling would
create a CUDA context as a side effect.  Reading the allocator's
statistics is host bookkeeping and never synchronises the device.

:func:`sample_ensemble_hbm` is a copy of the JAX package's: the
per-member cohort memory gauge ``ensemble.hbm_bytes_per_member{model}``.
"""
from __future__ import annotations

from .registry import metrics

__all__ = ["sample_hbm", "sample_ensemble_hbm"]

#: gauge name -> ``torch.cuda.memory_stats`` key
_STAT_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
)


def sample_hbm(registry=None, devices=None) -> dict:
    """Record ``hbm.<stat>{device=d}`` gauges for every CUDA device
    (``devices``: CUDA ordinals, default all) of a process that has
    initialised CUDA; returns ``{device: {stat: v}}`` for whatever was
    sampled (empty without CUDA)."""
    reg = registry if registry is not None else metrics
    if not reg.enabled:
        return {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        if devices is None:
            devices = range(torch.cuda.device_count())
    except Exception:  # noqa: BLE001 — no CUDA runtime, no gauges
        return {}
    out: dict = {}
    for d in devices:
        d = int(d)
        try:
            stats = torch.cuda.memory_stats(d)
            _free, total = torch.cuda.mem_get_info(d)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            continue
        rec = {}
        for gauge, key in _STAT_KEYS:
            v = stats.get(key)
            if isinstance(v, (int, float)):
                rec[gauge] = int(v)
        rec["bytes_limit"] = int(total)
        for gauge, v in rec.items():
            reg.gauge(f"hbm.{gauge}", v, device=d)
        out[d] = rec
    return out


def sample_ensemble_hbm(model: str, bytes_per_member: int,
                        registry=None) -> int | None:
    """Record the per-member cohort memory gauge
    ``ensemble.hbm_bytes_per_member{model=...}``; returns the recorded
    value, or None when telemetry is disabled.  The value is computed by
    the cohort — this seam only owns the gauge name and registry routing
    so tools and tests have ONE spelling to assert on."""
    reg = registry if registry is not None else metrics
    if not reg.enabled:
        return None
    v = int(bytes_per_member)
    reg.gauge("ensemble.hbm_bytes_per_member", v, model=str(model))
    return v
