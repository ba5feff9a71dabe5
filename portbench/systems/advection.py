"""The program under test for the advection cells: ``dccrg_tpu_torch``'s
grid and ``Advection`` model, driven as a user drives them.

The grid is built from the configuration file and the level-0 cells
that the benchmark names are refined once; ``initialize_state`` lays out the model's state and sets
the configuration's velocity field (the reference works it out again), and
the benchmark's seeded density goes in through ``set_cell_data``; a chunk is the user's loop between two diagnostics:
``dt = cfl * max_time_step(state)``, then ``run(state, k, dt)`` or ``k``
calls of ``step(state, dt)``.
"""
from __future__ import annotations

import numpy as np

from dccrg_tpu_torch import Advection, CartesianGeometry, Grid


class System:
    """One grid and model on ``device``, built from ``config``, with the
    level-0 cells ``request`` refined once."""

    def __init__(self, config: dict, device, request):
        n = tuple(int(v) for v in config["initial_length"])
        domain = np.asarray(config["domain"], dtype=np.float64)
        g = (Grid()
             .set_initial_length(n)
             .set_neighborhood_length(int(config["neighborhood_length"]))
             .set_periodic(*(bool(p) for p in config["periodic"])))
        if config.get("max_refinement_level", 0):
            g = g.set_maximum_refinement_level(int(config["max_refinement_level"]))
        g = g.set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                           level_0_cell_length=tuple(domain / np.asarray(n)))
        g = g.initialize(device=device)
        if len(request):
            g.refine_completely_many(np.asarray(request, dtype=np.uint64))
            g.stop_refining()
        self.grid = g
        self.n_leaves = len(g.get_cells())
        self.dtype = np.dtype(config["dtype"])
        self.model = Advection(g, dtype=self.dtype)
        self.state = self.model.initialize_state()
        self.ids = None

    def describe(self) -> str:
        """Which path the model's dispatch chose (for the run's log)."""
        m = self.model
        if m.dense is not None:
            return f"dense {m.dense_kind} fused={m.fused}"
        return f"general flat={m._flat_kind} boxed={m._prefer_boxed}"

    def load(self, inputs: dict):
        """The model state holding the benchmark's density (by cell id)."""
        ids = self.ids = np.asarray(inputs["ids"], dtype=np.uint64)
        state = self.model.set_cell_data(self.state, "density", ids,
                                         inputs["density"])
        if self.model.dense is None:
            state = self.grid.update_copies_of_remote_neighbors(state)
        return state

    def chunk(self, state, traffic: dict, span):
        """One chunk: the ``dt`` read, then the ``k`` steps enqueued.
        Returns the new state and the ``dt`` the model was given."""
        k = int(traffic["k"])
        with span("dt"):
            dt = float(traffic["cfl"]) * self.model.max_time_step(state)
        with span("dispatch"):
            if traffic["entry"] == "run":
                state = self.model.run(state, k, dt)
            else:
                for _ in range(k):
                    state = self.model.step(state, dt)
        return state, dt

    def units(self, traffic: dict) -> int:
        """Leaf updates a chunk completes."""
        return self.n_leaves * int(traffic["k"])

    def answer(self, state) -> np.ndarray:
        """What the reference judges of ``state``: its density at the ids
        the inputs were loaded by, in their order, on the host."""
        return np.asarray(self.model.get_cell_data(state, "density", self.ids),
                          dtype=np.float64)

    def cells(self) -> np.ndarray:
        """The program's leaf ids, ascending."""
        c = np.asarray(self.grid.get_cells(), dtype=np.uint64)
        return c if bool((c[1:] > c[:-1]).all()) else np.sort(c)
