"""Game of life with throughput reporting — the analogue of the
reference's examples/game_of_life.cpp: both its overlapped
compute/transfer pattern (lines 124-138 — here the split-phase
``GameOfLife(grid, overlap=True)`` step: the ghost copies started, inner
cells computed with no dependence on them, ghosts merged, outer cells
computed) and its min/avg/max cells/process/s report (lines 116-180).
Runs the blocking and overlap variants back to back and reports both; on
one slot the blocking run is one launch of the whole-run kernel.
"""
import sys
import time

import numpy as np
import torch

from dccrg_tpu_torch import GameOfLife, Grid
from dccrg_tpu_torch.examples import parser


def sync(device: str) -> None:
    """Wait for the card's queued work (the JAX example's
    ``block_until_ready``)."""
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("size", type=int, nargs="?", default=500)
    ap.add_argument("turns", type=int, nargs="?", default=100)
    args = ap.parse_args(argv)
    size, turns = args.size, args.turns
    grid = (
        Grid()
        .set_initial_length((size, size, 1))
        .set_neighborhood_length(1)
        .set_load_balancing_method("RCB")
        .initialize(device=args.device)
    )
    grid.balance_load()

    rng = np.random.default_rng(0)
    cells = grid.get_cells()
    alive0 = cells[rng.random(len(cells)) < 0.3]

    results = {}
    for name, overlap in (("blocking", False), ("overlap", True)):
        gol = GameOfLife(grid, overlap=overlap)
        state = gol.new_state(alive_cells=alive0)
        gol.step(state)             # warm-up
        sync(args.device)
        t0 = time.perf_counter()
        state = gol.run(state, turns)
        sync(args.device)
        secs = time.perf_counter() - t0
        results[name] = (secs, set(gol.alive_cells(state).tolist()))
        n_dev = grid.n_devices
        per_dev = [
            grid.get_local_cell_count(d) * turns / secs for d in range(n_dev)
        ]
        print(
            f"[{name}] devices: {n_dev}, grid {size}x{size}, {turns} turns "
            f"in {secs:.3f}s"
        )
        print(
            f"[{name}] cells/device/s min {min(per_dev):.3e} "
            f"avg {sum(per_dev)/n_dev:.3e} max {max(per_dev):.3e}; "
            f"total {size*size*turns/secs:.3e} cells/s"
        )
    assert results["blocking"][1] == results["overlap"][1], "physics differs!"
    print(
        f"overlap speedup: "
        f"{results['blocking'][0] / results['overlap'][0]:.3f}x"
    )
    print(f"PASSED: {len(results['blocking'][1])} alive after {turns} turns, "
          f"blocking == overlap")


if __name__ == "__main__":
    sys.exit(main())
