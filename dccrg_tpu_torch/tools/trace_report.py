"""Device-timeline report of the port: what ran, where the time went,
what overlapped (the JAX package's ``tools/trace_report.py`` on
``dccrg_tpu_torch``).

Consumes the merged host+device timeline (``obs.merge``) and prints:

* **top kernels by device time**, under the wrapper labels the kernels
  count their launches by (``ops.LAUNCHES``); a ``*`` marks a label whose
  library this process compiled (``epoch.recompiles{kernel=<stem>}``,
  through ``exec_cache.library_labels``);
* **overlap summary**: the measured ``overlap.fraction{phase=halo}``, how
  much of the halo's in-flight window (``halo.start`` -> ``halo.exchange``)
  coincided with interior device compute;
* **host gaps**: windows where the device sat idle, with the host phases
  that were open.

Three input modes:

    python -m dccrg_tpu_torch.tools.trace_report --run
        profile one split-phase round in-process (on the card unless
        --device cpu); --model picks the drive (the host-split advection
        loop, or the split-phase step of advection-fused / vlasov / gol)
        and --halo-backend pins the halo transport
    python -m dccrg_tpu_torch.tools.trace_report LOGDIR
        post-hoc: an existing ``obs.profile_trace`` log directory; the host
        track is rebuilt from the capture's own annotations
    python -m dccrg_tpu_torch.tools.trace_report --fleet T1 T2 ...
        unify per-process merged traces on their shared epoch-zero

``--json`` prints the machine-readable record; ``--merged-out`` exports
the merged Chrome trace.  A capture without device events reports
``device_evidence: false``; with ``--require-devices``, and always under
``--run`` on the card, that exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def run_probe(steps: int = 6, model: str = "advection",
              halo_backend: str | None = None, device=None):
    """Profile one split-phase round in-process on ``device`` (default
    CUDA) and return ``(merged, summary)``, gauges recorded.

    ``model``: ``advection`` profiles the host-split start / compute /
    wait loop of the gate's workload; ``advection-fused``, ``vlasov`` and
    ``gol`` profile the model's split-phase step (``overlap=True``) on the
    same grid.  ``halo_backend`` sets ``DCCRG_HALO_BACKEND`` before any
    exchange schedule is built."""
    from .. import obs
    from ..grid import resolve_device
    from . import check_telemetry as ct

    device = resolve_device(device)
    if halo_backend:
        os.environ["DCCRG_HALO_BACKEND"] = halo_backend
    obs.enable()
    obs.enable_timeline()
    g, adv, state, dt = ct.build_workload(device)
    if model == "advection":
        state = ct.drive(g, adv, state, dt, 2)      # first launches
        state = ct.drive_split(g, adv, state, dt, 1)
        with tempfile.TemporaryDirectory() as td:
            with obs.profile_trace(td):
                ct.drive_split(g, adv, state, dt, steps)
            return obs.merge_profile(td)
    name = "advection" if model == "advection-fused" else model
    step_once, mstate = ct.build_fused_model(g, name)
    mstate = ct.drive_fused(step_once, mstate, 1)   # first launches
    with tempfile.TemporaryDirectory() as td:
        with obs.profile_trace(td):
            ct.drive_fused(step_once, mstate, steps)
        return obs.merge_profile(td, extra_labels={"model": name})


def report_record(merged, summary, top: int = 10,
                  gaps_min_us: float = 100.0) -> dict:
    """The machine-readable report: summary, top kernels, host gaps and
    whether each kernel's library was compiled by this process."""
    from .. import obs
    from .check_telemetry import compiled_labels

    kernels = list(summary["kernels"].items())[:top]
    compiled = compiled_labels(obs.metrics.report()["counters"].get(
        "epoch.recompiles", {}))
    return {
        "window_s": summary["window_s"],
        "aligned": summary["aligned"],
        "alignment": summary["alignment"],
        "device_evidence": summary["device_evidence"],
        "devices": summary["devices"],
        "overlap": summary["overlap"],
        "top_kernels": [
            {"kernel": name, **rec, "compiled_this_process": name in compiled}
            for name, rec in kernels
        ],
        "host_gaps": merged.host_gaps(min_us=gaps_min_us, top=top),
    }


def print_report(rec: dict) -> None:
    print(f"window {rec['window_s'] * 1e3:.1f} ms   "
          f"aligned: {rec['aligned']}   "
          f"devices: {len(rec['devices'])}")
    if not rec["device_evidence"]:
        print("no device execution evidence in this capture "
              "(no device, or DCCRG_XPLANE=0) — host-only report")
        return
    for dev, d in sorted(rec["devices"].items(), key=lambda kv: str(kv[0])):
        print(f"  device {dev} ({d['kind']}): busy {d['busy_s'] * 1e3:.2f} ms"
              f" ({d['fraction'] * 100:.1f}%), {d['spans']} spans")
    ov = rec["overlap"]["halo"]
    if ov["fraction"] is not None:
        print(f"overlap[halo]: {ov['fraction'] * 100:.1f}% of "
              f"{ov['inflight_s'] * 1e3:.2f} ms in-flight hidden under "
              f"interior compute "
              f"(compute {ov['device_compute_s'] * 1e3:.2f} ms, "
              f"collectives {ov['device_collective_s'] * 1e3:.2f} ms)")
    else:
        print("overlap[halo]: no halo spans on the host track")
    print("top kernels by device time:")
    for k in rec["top_kernels"]:
        mark = "*" if k["compiled_this_process"] else " "
        print(f" {mark} {k['kernel']:32s} {k['time_us'] / 1e3:10.2f} ms  "
              f"{k['count']:8d} calls  ({k['module'] or '-'})")
    if rec["top_kernels"]:
        print("   (* = kernel whose library this process compiled)")
    if rec["host_gaps"]:
        print("host gaps (all devices idle):")
        for gap in rec["host_gaps"]:
            phases = ", ".join(gap["open_host_phases"]) or "-"
            print(f"   +{gap['start_us'] / 1e3:10.2f} ms  "
                  f"{gap['dur_us'] / 1e3:8.2f} ms   open: {phases}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("log_dir", nargs="?", default=None,
                    help="existing obs.profile_trace log dir to analyze post-hoc "
                         "(host track from its annotations)")
    ap.add_argument("--run", action="store_true",
                    help="profile a built-in split-phase advection round in-process "
                         "and report the live merge")
    ap.add_argument("--steps", type=int, default=6, help="probe steps under --run")
    ap.add_argument("--model", choices=("advection", "advection-fused", "gol", "vlasov"),
                    default="advection",
                    help="drive profiled under --run: 'advection' is the host-split "
                         "loop; the others drive the model's split-phase step")
    ap.add_argument("--halo-backend", choices=("collective", "pallas", "auto"),
                    default=None,
                    help="set DCCRG_HALO_BACKEND before the probe builds its halo "
                         "schedules")
    ap.add_argument("--fleet", nargs="+", default=None, metavar="TRACE",
                    help="merge per-process merged traces onto their shared "
                         "epoch-zero; write with --merged-out")
    ap.add_argument("--top", type=int, default=10, help="kernels/gaps listed")
    ap.add_argument("--gaps-min-us", type=float, default=100.0,
                    help="minimum device-idle gap reported")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable record")
    ap.add_argument("--merged-out", default=None, metavar="FILE",
                    help="also export the merged Chrome trace here")
    ap.add_argument("--require-devices", action="store_true",
                    help="exit 1 when the capture holds no device execution evidence "
                         "(always so under --run on the card)")
    ap.add_argument("--device", default=None,
                    help="where --run profiles (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    args = ap.parse_args(argv)

    if args.fleet:
        from ..obs.merge import merge_chrome_traces, validate_merged_trace

        fleet = merge_chrome_traces(args.fleet, out_path=args.merged_out)
        failures = validate_merged_trace(fleet)
        rec = {
            "sources": fleet["otherData"]["sources"],
            "events": len(fleet["traceEvents"]),
            "origin_unix_s": fleet["otherData"]["origin_unix_s"],
            "valid": not failures,
            "failures": failures,
        }
        if args.json:
            print(json.dumps(rec, indent=1))
        else:
            print(f"fleet trace: {rec['events']} events from {len(rec['sources'])} "
                  f"processes on epoch-zero {rec['origin_unix_s']:.6f}"
                  + (f" -> {args.merged_out}" if args.merged_out else ""))
            for f in failures:
                print(f"FAIL: {f}", file=sys.stderr)
        return 1 if failures else 0

    require = args.require_devices
    if args.run or args.log_dir is None:
        from ..grid import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        require = require or device.type == "cuda"
        merged, summary = run_probe(steps=args.steps, model=args.model,
                                    halo_backend=args.halo_backend, device=device)
    else:
        from ..obs.merge import build_from_capture

        merged = build_from_capture(args.log_dir)
        summary = merged.summary()
    if args.merged_out:
        merged.export(args.merged_out)
    rec = report_record(merged, summary, top=args.top, gaps_min_us=args.gaps_min_us)
    if args.json:
        print(json.dumps(rec, indent=1, default=float))
    else:
        print_report(rec)
    if require and not rec["device_evidence"]:
        print("FAIL: no device execution evidence", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
