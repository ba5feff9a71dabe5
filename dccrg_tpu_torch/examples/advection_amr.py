"""3-D advection with dynamic AMR and periodic load balancing — the
analogue of the reference's tests/advection/2d.cpp main loop: pre-adapt
around the density hump, then step / adapt every adapt_n / balance every
balance_n, optionally saving VTK snapshots.
"""
import sys

import numpy as np

from dccrg_tpu_torch import Advection, CartesianGeometry, Grid
from dccrg_tpu_torch.examples import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--cells", type=int, default=400)
    ap.add_argument("--max-ref-lvl", type=int, default=2)
    ap.add_argument("--tmax", type=float, default=1.0)
    ap.add_argument("--adapt-n", type=int, default=1)
    ap.add_argument("--balance-n", type=int, default=25)
    ap.add_argument("--cfl", type=float, default=0.5)
    ap.add_argument("--save", type=str, default="")
    args = ap.parse_args(argv)

    n = int(round(np.sqrt(args.cells)))
    grid = (
        Grid()
        .set_initial_length((n, n, 1))
        .set_maximum_refinement_level(args.max_ref_lvl)
        .set_neighborhood_length(0)
        .set_periodic(True, True, False)
        .set_load_balancing_method("RCB")
        .set_geometry(
            CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / n, 1.0 / n, 1.0 / n),
        )
        .initialize(device=args.device)
    )
    adv = Advection(grid, dtype=np.float32, allow_dense=False)
    state = adv.initialize_state()

    # initial adaptation rounds (2d.cpp:267-289)
    for _ in range(args.max_ref_lvl):
        state = adv.check_for_adaptation(state)
        adv, state, new_cells, removed = adv.adapt_grid(state)

    t, step = 0.0, 0
    dt = adv.max_time_step(state)
    m0 = adv.total_mass(state)
    print(f"initial timestep {dt:.5f}, {grid.get_total_cells()} cells")
    while t < args.tmax:
        state = adv.step(state, args.cfl * dt)
        t += args.cfl * dt
        step += 1
        if args.adapt_n and step % args.adapt_n == 0:
            state = adv.check_for_adaptation(state)
            adv, state, _, _ = adv.adapt_grid(state)
            dt = adv.max_time_step(state)
        if args.balance_n and step % args.balance_n == 0:
            grid.balance_load()
            state = grid.remap_state(state)
            adv = Advection(grid, dtype=np.float32, allow_dense=False)
            state = adv._exchange(state)
        if args.save and step % 10 == 0:
            rho = adv.get_cell_data(state, "density", grid.get_cells())
            grid.write_vtk_file(f"{args.save}_{step:05d}.vtk", scalars={"density": rho})
    mass = adv.total_mass(state)
    print(
        f"done: {step} steps, t={t:.3f}, {grid.get_total_cells()} cells, "
        f"mass {mass:.6f}"
    )
    # donor-cell fluxes conserve mass on the periodic plane up to float32
    # rounding (the open z faces carry no flux: vz is 0)
    drift = abs(mass - m0) / m0
    assert np.isfinite(mass) and drift < 1e-4, (m0, mass)
    print(f"PASSED: mass drift {drift:.2e}")


if __name__ == "__main__":
    sys.exit(main())
