"""JSON export of a telemetry snapshot (``telemetry.json``).

``bench.py`` writes one file per bench run and folds the phase breakdown
into ``BENCH_DETAIL.json``; ``tools/check_telemetry.py`` gates CI on the
file containing every instrumented phase.
"""
from __future__ import annotations

import json
import os

from .registry import metrics

__all__ = ["export_json"]


def export_json(path: str, registry=None, extra: dict | None = None) -> dict:
    """Write ``registry.report()`` (default: the process-wide registry)
    to ``path`` as JSON and return the report.  ``extra`` entries are
    merged into the top level (run metadata: workload name, device kind,
    ...).  Written via temp file + rename so a crash never leaves a
    truncated file behind."""
    reg = registry if registry is not None else metrics
    rep = reg.report()
    if extra:
        rep = {**rep, **extra}
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=1, default=float, sort_keys=False)
    os.replace(tmp, str(path))
    return rep
