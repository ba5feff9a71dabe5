"""Poisson solver example — the analogue of the reference's
tests/poisson programs: solve ∇²φ = ρ on an adaptively refined grid with
the matrix-free BiCG solver and verify against the analytic solution.

With ρ = sin(2πx) the exact periodic solution is
φ = -sin(2πx) / (2π)² (up to a constant); the discrete solve must agree
to discretization order, and refining a slab of the domain must not
break it.  float32 (the JAX example's float64 default under x64 off): on
one slot of the card each solve is one launch of the whole-solve kernel.
"""
import sys

import numpy as np

from dccrg_tpu_torch import CartesianGeometry, Grid, Poisson
from dccrg_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    n = 16
    grid = (
        Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(0)
        .set_periodic(True, True, True)
        .set_maximum_refinement_level(1)
        .set_geometry(
            CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / n,) * 3,
        )
        .initialize(device=args.device)
    )
    # refine a slab in the middle of the domain
    ids = grid.get_cells()
    x = grid.geometry.get_center(ids)[:, 0]
    for cid in ids[(x > 0.4) & (x < 0.6)]:
        grid.refine_completely(int(cid))
    grid.stop_refining()

    ids = grid.get_cells()
    centers = grid.geometry.get_center(ids)
    rhs = np.sin(2 * np.pi * centers[:, 0])

    model = Poisson(grid, dtype=np.float32)
    state = model.initialize_state(rhs)
    # restarts: BiCG on refined (non-normal) systems can stop early at
    # the semi-convergence rule; re-entering from the best solution
    # recovers (see Poisson.solve)
    state, residual, iterations = model.solve(
        state, max_iterations=2000, stop_residual=1e-10, restarts=3
    )

    phi = np.asarray(grid.get_cell_data(state, "solution", ids), np.float64)
    exact = -np.sin(2 * np.pi * centers[:, 0]) / (2 * np.pi) ** 2
    # remove the periodic solve's free constant (volume-weighted mean)
    vol = np.prod(grid.geometry.get_length(ids), axis=-1)
    phi = phi - (phi * vol).sum() / vol.sum()
    exact = exact - (exact * vol).sum() / vol.sum()
    err = np.abs(phi - exact).max() / np.abs(exact).max()

    print(f"{len(ids)} cells ({(grid.mapping.get_refinement_level(ids) > 0).sum()}"
          f" refined), {iterations} iterations, residual {residual:.2e}, "
          f"max rel error vs analytic {err:.3e}")
    assert err < 0.02, err     # second-order discretization at n=16
    print("PASSED")


if __name__ == "__main__":
    sys.exit(main())
