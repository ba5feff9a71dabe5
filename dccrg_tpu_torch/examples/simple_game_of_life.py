"""The simplest game-of-life program demonstrating basic usage — the
analogue of the reference's examples/simple_game_of_life.cpp: build a
10x10 grid, balance load, run 100 turns of a blinker and self-verify its
oscillation.
"""
import sys

from dccrg_tpu_torch import GameOfLife, Grid
from dccrg_tpu_torch.examples import parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    grid = (
        Grid()
        .set_initial_length((10, 10, 1))
        .set_maximum_refinement_level(0)
        .set_neighborhood_length(1)
        .set_load_balancing_method("RCB")
        .initialize(device=args.device)
    )
    grid.balance_load()

    gol = GameOfLife(grid)
    state = gol.new_state(alive_cells=[54, 55, 56])

    for turn in range(1, 101):
        state = gol.step(state)
        alive = set(gol.alive_cells(state).tolist())
        assert 55 in alive, f"turn {turn}: blinker center died"
        expect = {45, 55, 65} if turn % 2 == 1 else {54, 55, 56}
        assert alive == expect, f"turn {turn}: got {alive}"

    print("PASSED")


if __name__ == "__main__":
    sys.exit(main())
