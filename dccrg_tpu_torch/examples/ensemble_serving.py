"""Ensemble serving demo: multiplex a parameter sweep of independent
advection scenarios through shared cohorts.

Builds N same-shape grids (the bucketed-epoch discipline lands them on
one ``ShapeSignature``), gives each scenario its own randomized density
field and timestep, submits everything to the :class:`~dccrg_tpu_torch.
serve.Ensemble`, and verifies a sampled member against solo stepping.
float64 density (the JAX example enables x64).
"""
import sys
import time

import numpy as np

from dccrg_tpu_torch import Advection, CartesianGeometry, Grid, obs
from dccrg_tpu_torch.examples import parser
from dccrg_tpu_torch.serve import Ensemble


def build_model(n, seed, device):
    g = (
        Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(0)
        .set_periodic(True, True, True)
        .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                      level_0_cell_length=(1.0 / n,) * 3)
        .initialize(device=device)
    )
    g.stop_refining()
    adv = Advection(g, dtype=np.float64, allow_dense=False)
    state = adv.initialize_state()
    rng = np.random.default_rng(seed)
    ids = np.sort(g.get_cells())
    state = adv.set_cell_data(state, "density", ids,
                              rng.uniform(0.5, 2.0, len(ids)))
    state = g.update_copies_of_remote_neighbors(state)
    return adv, state


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--cells", type=int, default=6,
                    help="level-0 edge length per scenario grid")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    print(f"building {args.scenarios} scenarios "
          f"({args.cells}^3 cells each)...")
    sweep = [build_model(args.cells, seed, args.device)
             for seed in range(args.scenarios)]
    dt = 0.4 * sweep[0][0].max_time_step(sweep[0][1])

    ens = Ensemble()
    tickets = [
        ens.submit(adv, state, steps=args.steps, dt=dt,
                   tenant=f"user{i}")
        for i, (adv, state) in enumerate(sweep)
    ]
    t0 = time.perf_counter()
    served = ens.run()
    wall = time.perf_counter() - t0
    cohorts = list(ens.cohorts.values())
    print(f"served {served} scenario-steps in {wall:.2f}s through "
          f"{len(cohorts)} cohort(s) "
          f"(widths {[c.W for c in cohorts]})")

    # sampled member vs solo stepping — the bit-identity anchor
    adv, state = sweep[0]
    ref = state
    for _ in range(args.steps):
        ref = adv.step(ref, dt)
    same = bool((ref["density"] == tickets[0].result["density"]).all())
    print(f"member 0 bit-identical to solo stepping: {same}")

    rep = obs.metrics.report()
    served_by = rep["counters"].get("ensemble.steps_served", {})
    print(f"tenants served: {len(served_by)}; "
          f"queue latency: "
          f"{rep['histograms']['ensemble.queue_latency']['']['mean']:.4f}s"
          f" mean")
    assert same, "member 0 differs from solo stepping"
    print(f"PASSED: {args.scenarios} scenarios x {args.steps} steps")


if __name__ == "__main__":
    sys.exit(main())
