"""Checkpoint/restart example — the analogue of the reference's
tests/restart/restart_test.cpp: run an advecting density half way, save
to a .dc-style file, reload on a DIFFERENT slot count, finish the run,
and verify the result is bit-identical to the uninterrupted run.
"""
import pathlib
import sys
import tempfile

import numpy as np

from dccrg_tpu_torch import Advection, CartesianGeometry, Grid
from dccrg_tpu_torch.examples import parser


def build(n, n_devices, device):
    g = (
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
        .initialize(n_devices=n_devices, device=device)
    )
    ids = g.get_cells()
    c = g.geometry.get_center(ids)
    r = np.linalg.norm(c - 0.45, axis=1)
    for cid in ids[r < 0.25]:
        g.refine_completely(int(cid))
    g.stop_refining()
    return g


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--save", type=str, default="",
                    help="also keep the mid-run checkpoint at this path")
    args = ap.parse_args(argv)
    n, total_steps, half = 8, 24, 12
    g = build(n, n_devices=4, device=args.device)
    adv = Advection(g, dtype=np.float32)
    state = adv.initialize_state()
    dt = 0.4 * adv.max_time_step(state)

    # --- the uninterrupted run
    ref = state
    for _ in range(total_steps):
        ref = adv.step(ref, dt)
    ids = g.get_cells()
    want = np.asarray(adv.get_cell_data(ref, "density", ids))

    # --- half the run, checkpoint, reload on a different slot count
    for _ in range(half):
        state = adv.step(state, dt)
    spec = {"density": adv.spec["density"]}
    with tempfile.TemporaryDirectory() as tmp:
        path = args.save or str(pathlib.Path(tmp) / "mid.dc")
        g.save_grid_data(state, path, spec, user_header=b"restart-example")
        g2, state2, header = Grid.load_grid_data(path, spec, n_devices=2,
                                                 device=args.device)
        assert header == b"restart-example"
    assert np.array_equal(g2.get_cells(), ids), "reload reproduced the grid"

    adv2 = Advection(g2, dtype=np.float32)
    resumed = adv2.initialize_state()
    resumed = {**resumed, "density": state2["density"]}
    resumed = g2.update_copies_of_remote_neighbors(resumed)
    for _ in range(total_steps - half):
        resumed = adv2.step(resumed, dt)
    got = np.asarray(adv2.get_cell_data(resumed, "density", ids))

    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    print(f"PASSED: {len(ids)} cells (refined), saved at step {half} on 4 "
          f"devices, resumed on 2, bit-identical to the uninterrupted run")


if __name__ == "__main__":
    sys.exit(main())
