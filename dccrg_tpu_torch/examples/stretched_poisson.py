"""Poisson on a stretched Cartesian grid — the configuration the flat
voxel operator always refuses, exercising the general operator space
(reference: dccrg supports any geometry through the same per-pair
factor cache, tests/poisson/poisson_solve.hpp:716-745, with
Stretched_Cartesian_Geometry from dccrg_stretched_cartesian_geometry.hpp).

The cell boundaries follow a tanh-graded spacing (fine near the domain
center, coarse at the edges — the classic boundary-layer layout).  On the
card the solver runs the rolled static-offset decomposition of the
operator (ops/rolled_gather.py); on the CPU it runs the gather tables.
Both are the same operator: the solve must agree with the analytic
solution of ∇²φ = ρ to discretization order.

With ρ = sin(2πx) on x ∈ [0, 1] and Dirichlet boundaries φ = 0 applied
through boundary cells, the exact solution is φ = -sin(2πx)/(2π)².
"""
import sys

import numpy as np

from dccrg_tpu_torch import Grid, Poisson, StretchedCartesianGeometry
from dccrg_tpu_torch.examples import parser


def graded(n, lo=0.0, hi=1.0, strength=1.5):
    """n+1 monotone boundaries on [lo, hi], clustered around the middle."""
    u = np.linspace(-1.0, 1.0, n + 1)
    x = np.tanh(strength * u) / np.tanh(strength)
    return lo + (hi - lo) * (x + 1.0) / 2.0


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    n = 24
    grid = (
        Grid()
        .set_initial_length((n, 3, 3))
        .set_neighborhood_length(0)
        .set_periodic(False, True, True)
        .set_maximum_refinement_level(0)
        .set_geometry(
            StretchedCartesianGeometry,
            coordinates=[graded(n), np.linspace(0.0, 1.0, 4),
                         np.linspace(0.0, 1.0, 4)],
        )
        .initialize(device=args.device)
    )

    ids = grid.get_cells()
    centers = grid.geometry.get_center(ids)
    x = centers[:, 0]
    # first/last x-slabs are Dirichlet boundary cells holding φ = 0
    bounds = graded(n)
    boundary = (x < bounds[1]) | (x > bounds[-2])
    solve_cells = ids[~boundary]

    rhs = np.sin(2 * np.pi * x)
    model = Poisson(grid, dtype=np.float32, solve_cells=solve_cells)
    path = ("rolled" if model._rolled is not None
            else "flat" if model._flat is not None else "gather")
    state = model.initialize_state(rhs)
    state, residual, iterations = model.solve(
        state, max_iterations=2000, stop_residual=1e-10, restarts=3
    )

    phi = np.asarray(grid.get_cell_data(state, "solution", ids), np.float64)
    exact = -np.sin(2 * np.pi * x) / (2 * np.pi) ** 2
    sel = ~boundary
    err = np.abs(phi - exact)[sel].max() / np.abs(exact[sel]).max()

    widths = np.diff(bounds)
    print(f"{len(ids)} cells, x-spacing {widths.min():.4f}..{widths.max():.4f}, "
          f"operator path: {path}, {iterations} iterations, "
          f"residual {residual:.2e}, max rel error vs analytic {err:.3e}")
    assert err < 0.05, err  # second-order on the graded spacing at n=24
    print("PASSED")


if __name__ == "__main__":
    sys.exit(main())
