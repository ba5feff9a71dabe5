"""Kineto trace ingestion: the device half of the merged timeline.

``torch.profiler`` (wrapped by :func:`obs.profile_trace`) writes its
capture as Kineto's Chrome-trace JSON (``*.pt.trace.json``) under the log
dir.  Everything the host telemetry plane cannot see lives in there: the
CUDA kernels, copies and memsets that ran on each device (CUPTI's
activity records), and the ``record_function`` spans host phases open
while a trace runs.  The counterpart of the JAX package's
``obs/xplane.py``, with its public surface: the merge (``obs.merge``)
reads either package's ingest the same way.

What comes out (:func:`ingest`):

* **execution lines** — one per CUDA device: the events whose ``cat`` is
  ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, each with its stream
  (``args.stream``) and, for a kernel, its ``__global__`` symbol as the
  span's ``module`` (:func:`kernel_symbol`; Kineto's names carry return
  types, namespaces and template arguments that differ between torch
  versions) — the link to the wrapper labels ``merge`` attributes device
  time to;
* **host markers** — every ``user_annotation`` event: the registry's
  phase spans (opened whenever a profiler records), workload markers,
  and the clock-sync beacons below;
* **clock syncs** — :func:`emit_clock_sync` opens zero-work
  ``record_function`` spans whose NAME embeds ``time.perf_counter_ns()``
  at emission.  Re-finding them in the capture yields (host perf time,
  trace time) pairs; ``obs.merge`` fits the offset that maps device spans
  onto the ``EventTimeline`` clock, whatever base Kineto's microsecond
  ``ts`` has.

A capture without device events — a CPU-only process, where the profiler
records no CUDA activity — is an ingest with no execution lines: the
documented no-op.  The CPU operators in such a capture are host work and
never stand in for a device line.  ``DCCRG_XPLANE=0`` opts the whole
device-timeline plane out (the JAX package's switch).
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time

__all__ = [
    "kineto_enabled",
    "find_trace_files",
    "parse_trace",
    "kernel_symbol",
    "ingest",
    "emit_clock_sync",
    "clock_syncs",
    "CLOCK_SYNC_TAG",
    "DEVICE_CATEGORIES",
    "XIngest",
    "ExecLine",
    "KernelSpan",
    "HostMarker",
]

#: annotation-name prefix of the clock-sync beacons; the part after the
#: colon is ``time.perf_counter_ns()`` at emission
CLOCK_SYNC_TAG = "dccrg.clock_sync"

#: Kineto event categories that are device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: Kineto event category of ``record_function`` spans
HOST_MARKER_CATEGORY = "user_annotation"


def kineto_enabled() -> bool:
    """``DCCRG_XPLANE=0`` opts the whole device-timeline plane out."""
    return os.environ.get("DCCRG_XPLANE", "1").lower() not in (
        "0", "false", "off", "no",
    )


_MANGLED = re.compile(r"_Z(\d+)")


def kernel_symbol(name: str) -> str:
    """The bare ``__global__`` identifier of a Kineto kernel name:
    ``void (anonymous namespace)::ring_gather_kernel<4>(Fields)`` and
    ``_Z18ring_gather_kernel6Fields`` both give ``ring_gather_kernel``.
    Names that parse as neither come back unchanged."""
    s = str(name).strip()
    m = _MANGLED.match(s)
    if m:
        n = int(m.group(1))
        ident = s[m.end():m.end() + n]
        return ident if len(ident) == n else s
    s = s.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    cut = len(s)
    for ch in "<(":
        i = s.find(ch)
        if i > 0:
            cut = min(cut, i)
    s = s[:cut].strip()
    return s.rsplit("::", 1)[-1] if s else str(name)


class KernelSpan:
    """One executed kernel, copy or memset on an execution line;
    ``module`` is the kernel's ``__global__`` symbol (None for copies and
    memsets), ``stream`` the CUDA stream it ran on."""

    __slots__ = ("name", "module", "start_ns", "dur_ns", "stream")

    def __init__(self, name, module, start_ns, dur_ns, stream=None):
        self.name = name
        self.module = module
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.stream = stream

    def __repr__(self):
        return (f"KernelSpan({self.name!r}, module={self.module!r}, "
                f"start_ns={self.start_ns}, dur_ns={self.dur_ns}, "
                f"stream={self.stream!r})")


class HostMarker:
    """One ``record_function`` span found among the host events."""

    __slots__ = ("name", "start_ns", "dur_ns")

    def __init__(self, name, start_ns, dur_ns):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns


class ExecLine:
    """One device's execution timeline: the spans that ran there, every
    stream together.  ``kind`` is ``"device"``."""

    __slots__ = ("device_id", "name", "kind", "spans")

    def __init__(self, device_id, name, kind, spans):
        self.device_id = device_id
        self.name = name
        self.kind = kind
        self.spans = spans

    def busy_ns(self) -> int:
        """Union length of this line's span intervals (spans of two
        streams that overlap are not double-counted)."""
        ivs = sorted((s.start_ns, s.start_ns + s.dur_ns)
                     for s in self.spans)
        total = 0
        cur_a = cur_b = None
        for a, b in ivs:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total


class XIngest:
    """Everything the merge needs from one profiler capture;
    ``plane_names`` lists the event categories seen (Kineto's ``cat``
    strings differ between torch versions)."""

    __slots__ = ("paths", "exec_lines", "markers", "plane_names")

    def __init__(self, paths, exec_lines, markers, plane_names):
        self.paths = paths
        self.exec_lines = exec_lines
        self.markers = markers
        self.plane_names = plane_names

    @property
    def has_device_evidence(self) -> bool:
        """Whether the capture carried any device event at all — False
        for a CPU-only capture (the documented no-op case)."""
        return any(line.spans for line in self.exec_lines)


def find_trace_files(log_dir: str) -> list:
    """Every Kineto trace (``*.pt.trace.json``, gzipped or not) under a
    profiler log dir, sorted so repeated captures come back in run
    order."""
    out: list = []
    for pat in ("*.pt.trace.json", "*.pt.trace.json.gz"):
        out.extend(glob.glob(os.path.join(str(log_dir), pat)))
        out.extend(glob.glob(os.path.join(str(log_dir), "*", pat)))
    return sorted(set(out))


def parse_trace(path: str) -> list:
    """The ``traceEvents`` list of one Kineto trace file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents") if isinstance(data, dict) else data
    return events if isinstance(events, list) else []


def _device_of(ev: dict) -> int:
    args = ev.get("args") or {}
    for v in (args.get("device"), ev.get("pid")):
        try:
            return int(v)
        except (TypeError, ValueError):
            continue
    return 0


def ingest(log_dir: str) -> XIngest:
    """Parse every capture under ``log_dir`` into execution lines and
    host markers.  Missing traces, an opted-out plane
    (``DCCRG_XPLANE=0``), or a capture with no device events all come
    back as an empty-but-valid :class:`XIngest` — callers branch on
    :attr:`XIngest.has_device_evidence`, never on exceptions."""
    paths = find_trace_files(log_dir) if kineto_enabled() else []
    by_device: dict = {}
    markers: list = []
    cats: set = set()
    for path in paths:
        for ev in parse_trace(path):
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            if cat is not None:
                cats.add(str(cat))
            try:
                start_ns = float(ev["ts"]) * 1e3
                dur_ns = float(ev.get("dur", 0.0)) * 1e3
            except (KeyError, TypeError, ValueError):
                continue
            name = str(ev.get("name", ""))
            if cat in DEVICE_CATEGORIES:
                if dur_ns <= 0:
                    continue
                by_device.setdefault(_device_of(ev), []).append(KernelSpan(
                    name,
                    kernel_symbol(name) if cat == "kernel" else None,
                    start_ns, dur_ns, (ev.get("args") or {}).get("stream"),
                ))
            elif cat == HOST_MARKER_CATEGORY:
                markers.append(HostMarker(name, start_ns, dur_ns))
    exec_lines = [
        ExecLine(d, f"/device:CUDA:{d}", "device",
                 sorted(spans, key=lambda s: s.start_ns))
        for d, spans in sorted(by_device.items())
    ]
    markers.sort(key=lambda m: m.start_ns)
    return XIngest(paths, exec_lines, markers, sorted(cats))


def emit_clock_sync(reps: int = 3, tag: str = CLOCK_SYNC_TAG) -> None:
    """Open ``reps`` zero-work ``record_function`` spans whose names embed
    the host ``perf_counter_ns`` at emission — the beacons
    :func:`clock_syncs` recovers from the capture.  Must run while a
    profiler trace is active; a no-op cost (~µs each) otherwise."""
    if not kineto_enabled():
        return
    from torch.profiler import record_function

    for _ in range(reps):
        t = time.perf_counter_ns()
        with record_function(f"{tag}:{t}"):
            pass


def clock_syncs(ing: XIngest, tag: str = CLOCK_SYNC_TAG) -> list:
    """The ``(host_perf_ns, trace_ns)`` pairs recovered from a capture's
    sync beacons, emission order."""
    prefix = tag + ":"
    out = []
    for m in ing.markers:
        if m.name.startswith(prefix):
            try:
                out.append((int(m.name[len(prefix):]), m.start_ns))
            except ValueError:
                continue
    return sorted(out)
