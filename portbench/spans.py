"""The program's own spans and counters, for the per-layer metrics of the
model and set-up layers: the process-wide registry and event timeline of
``dccrg_tpu_torch.obs``.  A run is one process, so a series' total is the
run's: set-up, one warm-up chunk and the window's chunks.

Every chunk opens with one ``advection.max_time_step`` span (its ``dt``
read), the warm-up's first; that span marks the program as instrumented
and the chunks on the timeline.  Each reader returns ``None`` where the
program records none of it: with telemetry off (``DCCRG_TELEMETRY=0``), or
in a program without these spans.
"""
from __future__ import annotations

import bisect

#: the span each chunk opens first
CHUNK_SPAN = "advection.max_time_step"


def _obs():
    try:
        from dccrg_tpu_torch import obs
    except ImportError:
        return None
    return obs if obs.metrics.enabled else None


def _report(ctx):
    """The registry's snapshot, or None unless it holds one chunk span for
    each chunk the run made (the window's and the warm-up)."""
    obs = _obs()
    if obs is None:
        return None
    rep = obs.metrics.report()
    rec = rep["phases"].get(CHUNK_SPAN)
    if rec is None or rec["count"] != len(ctx.chunks) + 1:
        return None
    return rep


def counter_per_chunk(ctx, name: str):
    """Counter ``name``, summed over its sites, a chunk: its total over the
    run's chunks (the window's and the warm-up, which do the same work)
    over their number; 0 where the instrumented program never counted."""
    rep = _report(ctx)
    if rep is None:
        return None
    return sum(rep["counters"].get(name, {}).values()) / (len(ctx.chunks) + 1)


def phase_seconds(ctx, names) -> float | None:
    """The summed host seconds of the phases ``names``; None unless each
    was recorded."""
    rep = _report(ctx)
    if rep is None or any(n not in rep["phases"] for n in names):
        return None
    return sum(rep["phases"][n]["total_s"] for n in names)


def chunk_spans(ctx):
    """The timeline's spans by chunk of ``ctx.chunks``: chunk ``i`` holds
    the spans that begin between its chunk span and the next chunk's (the
    warm-up's, before chunk 0's, are left out).  None where the timeline
    is off or dropped spans, or holds another number of chunk spans."""
    obs = _obs()
    if obs is None:
        return None
    summary = obs.timeline.summary()
    if not summary["enabled"] or summary["dropped"]:
        return None
    spans = sorted(obs.timeline.spans(), key=lambda s: s["begin"])
    starts = [s["begin"] for s in spans if s["name"] == CHUNK_SPAN]
    if len(starts) != len(ctx.chunks) + 1:
        return None
    starts = starts[1:]
    out = [[] for _ in ctx.chunks]
    for s in spans:
        i = bisect.bisect_right(starts, s["begin"]) - 1
        if i >= 0:
            out[i].append(s)
    return out
