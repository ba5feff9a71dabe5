"""The traced run's device timeline: a ``torch.profiler`` session over the
last chunks of the window, and its reduction to the device's busy time, the
device operations by name, and the idle gaps named by the harness span that
was open on the host at the time.

The harness's spans enter the trace as ``record_function`` annotations
(``chunk``, and inside it ``dt``, ``dispatch``, ``drain``), so host and device
events share the profiler's clock.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

#: trace event categories that are device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness spans an idle gap can be named by
HOST_SPANS = ("dt", "dispatch", "drain")


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Session:
    """A profiler session; ``events()`` after ``stop()``."""

    def __init__(self, device):
        self.prof = torch.profiler.profile(activities=_activities(device))

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def events(self) -> list:
        """The trace's complete events (``ph == "X"``) as exported."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict | None:
    """Busy and idle time over the traced window, from the first ``chunk``
    annotation's start to the last one's end.  ``None`` when the trace holds
    no chunk.  Times in seconds."""
    chunks = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == "chunk"]
    if not chunks:
        return None
    w0 = min(a for a, _ in chunks)
    w1 = max(b for _, b in chunks)
    by_name: dict = {}
    spans = []
    for e in events:
        cat = e.get("cat")
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                spans.append((a, b))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy = _merge(spans)
    busy_us = sum(b - a for a, b in busy)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") in HOST_SPANS)
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][1] < mid:
            j += 1
        name = host[j][2] if j < len(host) and host[j][0] <= mid else "harness"
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[k, v * 1e-6] for k, v in top],
        "idle_gaps": [[k, v * 1e-6] for k, v in idle],
    }
