"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... \
        --seconds 2 [--float32] [--out FILE]

Builds the cell's program once, then for each seed hands it the seed's
inputs, runs a short window of the cell's own chunks (``run.window``, the
same sampling as a benchmark run) and reads:

* ``program``: the numbers compared (``density_gap_first``,
  ``density_gap_later``, ``dt_gap``, ``leaf_mismatch``) of the program's
  answers against the float64 reference;
* ``control``: the same numbers of the reference computed in bfloat16, the
  precision below the configuration's float32, put in the program's place
  on the same chunk inputs;
* ``float32_reference`` (with ``--float32``): the same numbers of the
  reference computed in float32, the configuration's precision, put in the
  program's place: a witness of what float32 alone reads;
* ``faults``: the numbers of the program's answers with a fault planted
  where they are produced: ``unchanged`` (each sampled chunk returns its
  input state), ``half_left_out`` (every other leaf keeps its input
  density), ``one_altered`` (the densest leaf's output times 1.1) and
  ``dt_altered`` (every ``dt`` read times 1.0001).

Prints one JSON object: each seed's readings, and for each number the
largest program reading (the lower reading), the least control reading and
the least reading of each fault.  Needs the card, as a benchmark run does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import load, run

FAULTS = ("unchanged", "half_left_out", "one_altered", "dt_altered")


def plant(fault: str, pairs: list, dts: list) -> tuple:
    """The answers ``(outs, dts)`` with ``fault`` planted in them."""
    outs = [np.array(o, dtype=np.float64) for _, o in pairs]
    if fault == "unchanged":
        outs = [np.array(i, dtype=np.float64) for i, _ in pairs]
    elif fault == "half_left_out":
        for o, (i, _) in zip(outs, pairs):
            o[::2] = i[::2]
    elif fault == "one_altered":
        for o in outs:
            o[int(np.argmax(o))] *= 1.1
    elif fault == "dt_altered":
        dts = [d * 1.0001 for d in dts]
    return outs, dts


def calibrate(cell: dict, seeds, seconds: float, device, root=None, log=print,
              float32: bool = False) -> dict:
    config = load.config(cell["config"], root)
    traffic = load.traffic(cell["traffic"], root)
    model = config["model"]
    ref = load.model_module("reference", model).Reference(config)
    system = load.model_module("systems", model).System(config, device, ref.request)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cells = system.cells()
    rows = {}
    for seed in seeds:
        t = time.perf_counter()
        inputs = ref.inputs(seed, device)
        state0 = system.load(inputs)
        warm, _ = system.chunk(state0, traffic, run.Spans())
        sync()
        del warm
        drawn_at = float(np.random.default_rng([int(seed) % (1 << 64), 1]).random())
        w = run.window(system, state0, traffic, seconds, drawn_at, sync)
        pairs = run.read_back(system, w["keep"], ref, inputs)
        del w["keep"], state0
        exp = ref.expected(device, [p[0] for p in pairs], traffic)
        row = {"chunks": len(w["chunks"]),
               "program": ref.judge([p[1] for p in pairs], w["dts"], cells, exp),
               "control": ref.control(device, pairs, traffic, torch.bfloat16, exp),
               "faults": {}}
        if float32:
            row["float32_reference"] = ref.control(device, pairs, traffic,
                                                   torch.float32, exp)
        for fault in FAULTS:
            outs, dts = plant(fault, pairs, w["dts"])
            row["faults"][fault] = ref.judge(outs, dts, cells, exp)
        rows[str(seed)] = row
        log(f"[calibrate] {cell['name']} seed {seed} ({time.perf_counter() - t:.1f} s): "
            f"{json.dumps(row)}")
    numbers = list(next(iter(rows.values()))["program"])
    summary = {}
    for n in numbers:
        summary[n] = {
            "lower": max(r["program"][n] for r in rows.values()),
            "control_min": min(r["control"][n] for r in rows.values()),
            "faults_min": {f: min(r["faults"][f][n] for r in rows.values())
                           for f in FAULTS},
        }
        if float32:
            summary[n]["float32_reference_max"] = max(
                r["float32_reference"][n] for r in rows.values())
    return {"workload": cell["name"], "seeds": list(seeds), "seconds": seconds,
            "device": run.device_info(device), "path": system.describe(),
            "rows": rows, "summary": summary}


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--float32", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = load.workload(load.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    out = calibrate(cell, args.seeds, args.seconds, "cuda",
                    log=lambda m: print(m, file=sys.stderr, flush=True),
                    float32=args.float32)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"workload": out["workload"], "summary": out["summary"],
                      "path": out["path"], "device": out["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
