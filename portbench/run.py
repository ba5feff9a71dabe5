"""Run one cell once and print its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): import, the
program's grid and model (``grid_build``), loading the seed's inputs into
it, one warm-up chunk of the cell's own traffic.  The reference's part of
set-up (its leaf list and refinement request, and drawing the inputs) is
timed apart and left out of ``setup_s``.  Then the
window: chunks back to back, each one ``dt`` read, its steps enqueued and a
synchronise, until ``--seconds`` have passed; a closed loop, as the user's own.  After it: the
device memory peak, the sampled chunks read back, the program freed, and the
plain reference run over them to decide ``correct``.

With ``--trace 1`` the profiler records the last ``TRACE_S`` seconds of
chunks and the per-layer metrics are reported; with ``--trace 0`` the
end-to-end ones.  The last line on standard output is the result; the last
lines on standard error are the numbers compared, each beside its limit.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 3.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types

import numpy as np

from portbench import load

#: seconds of chunks the profiler records at the end of a traced run
TRACE_S = 2.0
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160
#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "dccrg_tpu")


class Spans:
    """Host spans of one chunk (seconds by name), annotated in the
    profiler's trace while ``traced``."""

    def __init__(self):
        self.seconds: dict = {}
        self.traced = False

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    __slots__ = ("owner", "name", "t", "rf")

    def __init__(self, owner, name):
        self.owner, self.name, self.rf = owner, name, None

    def __enter__(self):
        if self.owner.traced:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        s = self.owner.seconds
        s[self.name] = s.get(self.name, 0.0) + time.perf_counter() - self.t
        if self.rf is not None:
            self.rf.__exit__(*exc)


def window(system, state, traffic: dict, seconds: float, drawn_at: float,
           sync, session=None, trace_s: float = TRACE_S) -> dict:
    """Chunks back to back from ``state`` until ``seconds`` have passed.
    Keeps the input and output states of chunk 0, of the first chunk that
    starts ``drawn_at`` (a share) into the window, and of the last chunk.
    With ``session``, the last ``trace_s`` seconds of chunks run under the
    profiler, which starts after the untraced chunks (its start and its
    hooks, which outlive it, then touch none of them)."""
    import torch

    chunks, keep, dts = [], {}, []
    drawn = None
    start = time.perf_counter()

    def one(state, traced):
        nonlocal drawn
        spans = Spans()
        spans.traced = traced
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.record_function("chunk"):
                new, dt = system.chunk(state, traffic, spans)
                with spans("drain"):
                    sync()
        else:
            new, dt = system.chunk(state, traffic, spans)
            with spans("drain"):
                sync()
        t1 = time.perf_counter()
        i = len(chunks)
        chunks.append({"t0": t0 - start, "t1": t1 - start, "spans": spans.seconds,
                       "traced": traced})
        dts.append(dt)
        if i == 0:
            keep[0] = (state, new)
        if drawn is None and t0 - start >= drawn_at * seconds:
            drawn = i
            keep[i] = (state, new)
        keep["last"] = (i, state, new)
        return new, t1

    untraced = seconds if session is None else max(0.0, seconds - trace_s)
    t1 = start
    while untraced > 0 and (not chunks or t1 - start < untraced):
        state, t1 = one(state, False)
    if session is not None:
        session.start()
        t_trace = time.perf_counter()
        while t1 < t_trace or t1 - t_trace < trace_s:
            state, t1 = one(state, True)
        session.stop()
    i, s_in, s_out = keep.pop("last")
    keep[i] = (s_in, s_out)
    return {"chunks": chunks, "keep": keep, "dts": dts, "seconds": t1 - start}


def read_back(system, keep: dict, ref, inputs: dict) -> list:
    """``(answer in, answer out)`` on the host for each kept chunk, chunk 0
    first: the model's own ``system.answer`` of each state, chunk 0's input
    being ``ref.start(inputs)``, the benchmark's own.  A chunk's output
    state is the next one's input, so each state is read once."""
    seen, pairs = {}, []

    def rd(state):
        if id(state) not in seen:
            seen[id(state)] = system.answer(state)
        return seen[id(state)]

    for i in sorted(keep):
        s_in, s_out = keep[i]
        pairs.append((ref.start(inputs) if i == 0 else rd(s_in), rd(s_out)))
    return pairs


def device_info(device) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, where it runs."""
    import shutil
    import subprocess

    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, root=None, log=None) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last)."""
    import torch

    from portbench import trace as tr

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    config = load.config(cell["config"], root)
    traffic = load.traffic(cell["traffic"], root)
    limits = load.limits(cell["name"], root)
    model = config["model"]
    ref_mod = load.model_module("reference", model)
    sys_mod = load.model_module("systems", model)
    work_mod = load.model_module("work", model)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    setup, reference = {}, {}
    t = time.perf_counter()
    ref = ref_mod.Reference(config)
    reference["leaves"] = time.perf_counter() - t
    t = time.perf_counter()
    system = sys_mod.System(config, device, ref.request)
    setup["grid_build"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = ref.inputs(seed, device)
    reference["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    state0 = system.load(inputs)
    setup["load"] = time.perf_counter() - t
    log(f"[portbench] {cell['name']} seed {seed}: {system.describe()}; "
        f"set-up spans {setup}; reference spans, not in setup_s, {reference}")
    warm, _ = system.chunk(state0, traffic, Spans())
    sync()
    del warm
    drawn_at = float(np.random.default_rng([int(seed) % (1 << 64), 1]).random())
    session = tr.Session(device) if trace else None
    setup_s = time.perf_counter() - t0 - sum(reference.values())

    w = window(system, state0, traffic, seconds, drawn_at, sync, session)
    units = system.units(traffic) * len(w["chunks"])
    dev = device_info(device)
    pairs = read_back(system, w["keep"], ref, inputs)
    cells = system.cells()
    n_chunks, dts, kept = len(w["chunks"]), w["dts"], sorted(w["keep"])
    del system, state0, w["keep"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = ref.readings(device, pairs, dts, cells, traffic)
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    summary = ref.summary(device)
    calls = work_mod.chunk_calls(traffic, summary,
                                 np.dtype(config["dtype"]).itemsize)
    reduced = None
    if trace:
        reduced = tr.reduce(session.events())
        if cuda and (reduced is None or reduced["busy_s"] <= 0):
            raise RuntimeError("the traced window holds no device activity")
        pl = power_limit() if cuda else None
        if pl:
            log(f"[portbench] card: {pl}")

    ctx = types.SimpleNamespace(
        setup=setup, setup_s=setup_s, window_s=w["seconds"], units=units,
        chunks=w["chunks"], trace=reduced, calls=calls, work=work_mod,
        peaks=load.peaks(dev["kind"], root), dtype=config["dtype"],
        summary=summary)
    family = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in family:
        if not load.applies(m, cell["name"], bench):
            continue
        value = load.reader(m["name"], root)(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no value")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
    ms = sorted(1e3 * (c["t1"] - c["t0"]) for c in w["chunks"])
    log(f"[portbench] {n_chunks} chunks in {w['seconds']:.4f} s; kept {kept}; "
        f"chunk ms min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; "
        f"leaves {summary['leaves']}, faces {summary['faces']}")
    result = {"correct": bool(correct), "attempted": n_chunks,
              "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if reduced is not None:
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], v] for n, v in reduced["device_ops"]],
            "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load.benchmark()
    cell = load.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
