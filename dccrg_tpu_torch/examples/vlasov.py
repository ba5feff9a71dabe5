"""Vlasov advection example — the Vlasiator-style payload the reference
grid was built to carry (reference CREDITS:4-6): a velocity-space
distribution block f(v) per spatial cell, advected through space with
df/dt + v·∇_x f = 0.

A Maxwellian hump is placed mid-domain; after one periodic crossing time
per velocity bin the density field translates while total phase-space
mass is conserved exactly (periodic boundaries).  On the card each step is
one launch of the Vlasov step kernel (``ops/vlasov_kernel.py``): all three
dimension-split updates in one pass over the block.
"""
import sys

import numpy as np

from dccrg_tpu_torch import CartesianGeometry, Grid, Vlasov
from dccrg_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    n = 16
    grid = (
        Grid()
        .set_initial_length((n, n, n))
        .set_neighborhood_length(0)
        .set_periodic(True, True, True)
        .set_geometry(
            CartesianGeometry,
            start=(0.0, 0.0, 0.0),
            level_0_cell_length=(1.0 / n,) * 3,
        )
        .initialize(device=args.device)
    )
    vl = Vlasov(grid, nv=4, v_max=0.5, dtype=np.float32)
    state = vl.initialize_state(thermal_v=0.3)
    m0 = vl.total_mass(state)
    dt = np.float32(0.4 * vl.max_time_step())

    steps = 200
    state = vl.run(state, steps, dt)
    m1 = vl.total_mass(state)
    drift = abs(m1 - m0) / m0
    print(f"phase-space mass {m0:.6e} -> {m1:.6e} (rel drift {drift:.2e})")
    assert drift < 1e-5, "periodic Vlasov must conserve mass"

    rho = vl.density(state)
    print(
        f"density field: min {rho.min():.4e} max {rho.max():.4e} "
        f"({n}^3 spatial cells x {vl.B} velocity bins, "
        f"fused_block={vl._fused_block})"
    )
    print("PASSED")


if __name__ == "__main__":
    sys.exit(main())
