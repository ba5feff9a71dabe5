"""Conway's game of life on the grid — the framework's "hello world",
matching the reference's ``examples/simple_game_of_life.cpp`` /
``examples/game_of_life.cpp``: full-vertex neighborhood, count live
neighbors of every local cell after a ghost update, then apply the 2/3
rule.

A port of the JAX package's ``models/game_of_life.py``, with two layouts:

* general (any grid, refined too): ``[D, R]`` rows of the epoch; a step is
  a ghost refresh, a neighbor gather over the stencil tables and a masked
  count feeding the rule;
* dense 2-D (an (N, N, 1) uniform grid with the length-1 neighborhood in
  y-slab ownership, ``parallel/dense.py::detect_dense2d``): the y-slab view
  is a reshape of the row layout.  ``run`` on one device takes the
  whole-run kernel of ``ops/gol_kernel.py`` (one launch for any number of
  turns) when the board fits ``gol_run_fits`` (the JAX package's rule);
  on more devices, or a larger board, it is the JAX package's dense
  loop — the kernel twin's count and rule on each device's band of rows,
  the halo two boundary rows a device — in plain torch, as the JAX package
  runs it in XLA.

The payload is uint32, as in the JAX package.  torch implements few
operations for uint32 (no ``>`` or ``+`` on the CPU), so counts and the
rule compute in int32 (the gather step) or float32 (the dense view, as in
the kernel) and the results are stored as uint32.

``overlap=True`` skips the dense 2-D path and makes ``step`` / ``run`` the
split-phase step on the row layout: start the alive halo (kernel B9 on a
side stream on CUDA), count and rule the inner rows, which read no ghost,
wait, then the outer rows — equal to the gather step.

``batch_step_spec`` gives the gather step (``gol``) or the split-phase step
(``gol.overlap``) in cohort form, over a member stack ``[W, D, R]`` (the
tables shared or stacked, the halo one grouped B9 gather for every member);
``_wide_spec`` its exchange-amortized split where a radius-1
sub-neighborhood steps inside a deeper default hood (``parallel/
wide_halo.py``).  There is no fallback: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..obs import fused
from ..ops.gol_kernel import _validity, gol_run, gol_run_fits, gol_turn
from ..parallel.dense import HaloExtend, detect_dense2d
from ..parallel.stencil import (StencilTables, gather_neighbors, member_index,
                                member_rows, split_rows)

__all__ = ["GameOfLife"]

_U32 = torch.uint32


def _life_rule(count, alive):
    """The 2/3 rule (examples/simple_game_of_life.cpp:95-106) on int32."""
    one, zero = torch.ones_like(alive), torch.zeros_like(alive)
    return torch.where(count == 3, one, torch.where(count != 2, zero, alive))


class GameOfLife:
    #: the payload declaration — the reference's ``game_of_life_cell`` with
    #: its ``get_mpi_datatype`` seam (examples/simple_game_of_life.cpp:20-32)
    SPEC = {
        "is_alive": ((), np.uint32),
        "live_neighbor_count": ((), np.uint32),
    }

    def __init__(self, grid, hood_id=None, overlap: bool = False,
                 allow_dense: bool = True, use_kernels: bool = True):
        self.grid = grid
        self.hood_id = hood_id
        self.use_kernels = bool(use_kernels)
        #: split-phase stepping on the row layout (no dense 2-D path)
        self.overlap = bool(overlap)
        self._exchange = grid.halo(hood_id)
        self.tables = None if self.overlap else StencilTables(grid, hood_id)
        self.dense2d = (detect_dense2d(grid, hood_id)
                        if allow_dense and not self.overlap else None)
        #: whether ``run`` takes the whole-run kernel (``gol_run``)
        self.fused = False
        if self.overlap:
            self._init_overlap()
        if self.dense2d is not None:
            self._init_dense()

    def new_state(self, alive_cells=()):
        state = self.grid.new_state(self.SPEC)
        if len(alive_cells):
            state = self.grid.set_cell_data(
                state, "is_alive", np.asarray(alive_cells, dtype=np.uint64),
                np.ones(len(alive_cells), dtype=np.uint32))
        return state

    # ------------------------------------------------------- general path

    def step(self, state):
        """One turn on the row layout: ghost refresh, neighbor gather,
        count over the valid entries, rule on the local rows."""
        if self.overlap:
            return self._overlap_step(state)
        state = self._exchange(state)
        alive = state["is_alive"].to(torch.int32)
        nbr_alive = gather_neighbors(alive, self.tables.nbr_rows)   # [D, R, K]
        count = (self.tables.nbr_valid & (nbr_alive != 0)).sum(
            dim=-1, dtype=torch.int32)
        local = self.tables.local_mask
        return {
            "is_alive": torch.where(local, _life_rule(count, alive), alive).to(_U32),
            "live_neighbor_count": torch.where(
                local, count, torch.zeros_like(count)).to(_U32),
        }

    # ------------------------------------------------- split-phase path

    def _init_overlap(self):
        """Compacted inner / outer row sets and their gather tables (the JAX
        package's ``_build_overlap_step`` tables; widths on the bucket ladder
        with the grid's hints, pad lanes the scratch row)."""
        grid = self.grid
        hood = grid.epoch.hoods[self.hood_id]
        ar = np.arange(grid.n_devices)[:, None]
        put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                            device=grid.device)
        self._sides = [(put(rows, torch.int64),
                        put(hood.nbr_rows[ar, rows], torch.int64),
                        put(hood.nbr_valid[ar, rows], torch.bool))
                       for rows in split_rows(grid, self.hood_id)]
        self._local = put(grid.epoch.local_mask, torch.bool)
        self._ar = torch.arange(grid.n_devices, device=grid.device)[:, None]

    def _overlap_step(self, state):
        """The split-phase turn (``game_of_life.py:185-220`` of the JAX
        package): start the alive halo, count and rule the inner rows (no
        payload read), merge the ghosts, then the outer rows; the counts
        are 0 off the local rows, and ``where(local, ...)`` cleans the
        scratch row the pad lanes wrote."""
        ex, ar = self._exchange, self._ar
        field = {"is_alive": state["is_alive"]}
        handle = ex.start(field)

        def side(a, rows, nbr, valid):
            count = (valid & (gather_neighbors(a, nbr) != 0)).sum(dim=-1, dtype=torch.int32)
            return count, _life_rule(count, a[ar, rows])

        (ri, *ti), (ro, *to) = self._sides
        cnt_i, new_i = side(state["is_alive"].to(torch.int32), ri, *ti)
        a2 = ex.finish(field, handle)["is_alive"].to(torch.int32)
        cnt_o, new_o = side(a2, ro, *to)
        out_a, cnt = a2.clone(), torch.zeros_like(a2)
        out_a[ar, ri], out_a[ar, ro] = new_i, new_o
        cnt[ar, ri], cnt[ar, ro] = cnt_i, cnt_o
        zero = torch.zeros_like(a2)
        return {
            "is_alive": torch.where(self._local, out_a, a2).to(_U32),
            "live_neighbor_count": torch.where(self._local, cnt, zero).to(_U32),
        }

    # ------------------------------------------------------ dense 2-D path

    def _init_dense(self):
        info = self.dense2d
        D, nyl, nx = info["D"], info["nyl"], info["nx"]
        px, py = info["periodic"]
        self.fused = (self.use_kernels and D == 1 and gol_run_fits(nyl, nx))
        self._ring = HaloExtend(D)
        dev = self.grid.device
        self._vx = _validity(nx, px, dev)
        # boundary-row validity on open y: device 0's below-row and device
        # D-1's above-row come from the ring wrap and must be dropped
        ok_below = torch.ones((D, 1, 1), dtype=torch.float32, device=dev)
        ok_above = torch.ones((D, 1, 1), dtype=torch.float32, device=dev)
        if not py:
            ok_below[0] = 0
            ok_above[-1] = 0
        self._ok_below, self._ok_above = ok_below, ok_above

    def _dense_board(self, rows):
        """The float32 0/1 y-slab view ``[D, nyl, nx]`` of the row layout."""
        info = self.dense2d
        per = info["nyl"] * info["nx"]
        return (rows[:, :per].to(torch.int32) != 0).to(torch.float32).reshape(
            info["D"], info["nyl"], info["nx"])

    def _dense_state(self, rows, a, cnt):
        """The row layout of the board ``a`` and the counts ``cnt``."""
        D, per = a.shape[0], a[0].numel()
        out_a = rows.clone()
        out_a[:, :per] = a.reshape(D, per).to(_U32)
        out_c = torch.zeros_like(rows)
        out_c[:, :per] = cnt.reshape(D, per).to(_U32)
        return {"is_alive": out_a, "live_neighbor_count": out_c}

    def _fused_run(self, state, turns):
        rows = state["is_alive"]
        out, cnt = gol_run(self._dense_board(rows)[0], turns, *self.dense2d["periodic"])
        return self._dense_state(rows, out[None], cnt[None])

    def _dense_run(self, state, turns):
        """The JAX package's dense loop (``game_of_life.py:347-378``) over
        ``[D, nyl, nx]``: each device's band of rows, its halo the two
        boundary rows of its ring neighbors; the count and the rule are the
        kernel twin's."""
        rows = state["is_alive"]
        a = self._dense_board(rows)
        cnt = torch.zeros_like(a)
        for _ in range(turns):
            below, above = self._ring.planes(a)
            up = torch.cat([a[:, 1:], above * self._ok_above], dim=1)
            dn = torch.cat([below * self._ok_below, a[:, :-1]], dim=1)
            a, cnt = gol_turn(up, a, dn, *self._vx)
        return self._dense_state(rows, a, cnt)

    # ----------------------------------------------------------- user API

    def run(self, state, turns: int):
        """Advance ``turns`` turns.  On the dense 2-D layout the whole run
        is one kernel launch (one device, the board fits) or the dense loop;
        otherwise the general step, turn by turn."""
        turns = int(turns)
        if self.dense2d is not None and turns > 0:
            if self.fused:
                self._record_run("fused", turns, state)
                return self._fused_run(state, turns)
            self._record_run("dense", turns, state)
            return self._dense_run(state, turns)
        for _ in range(turns):
            state = self.step(state)
        return state

    def _record_run(self, path: str, turns, state) -> None:
        """Whole-run dispatches keep their ghost traffic on the device —
        reconcile ``turns x schedule bytes`` on the host (``obs.fused``,
        the JAX package's series).  Only ``is_alive`` crosses the wire,
        like the reference's ``get_mpi_datatype``
        (examples/simple_game_of_life.cpp:20-32)."""
        if not self.grid.telemetry.enabled:
            return
        try:
            bps = self._exchange.bytes_moved({"is_alive": state["is_alive"]})
        except Exception:  # noqa: BLE001 — telemetry must never raise
            bps = 0
        fused.record_run("game_of_life", path, turns, bps)

    def alive_cells(self, state) -> np.ndarray:
        cells = self.grid.get_cells()
        alive = self.grid.get_cell_data(state, "is_alive", cells)
        return cells[alive > 0]

    def _wide_spec(self):
        """The exchange-amortized step split (the JAX package's
        ``_wide_spec``).  The life rule reads the whole neighborhood, so
        relevance is ``"all"``: on the default hood the budget is 1 and
        the wide step disengages (None); it engages when the model steps
        on a radius-1 sub-neighborhood of a deeper default hood — the
        exchange refills the full-depth ghost zone of both fields and
        ``steps_ok`` meters its shell-by-shell consumption."""
        from ..parallel.halo import MemberExchange, ring_args
        from ..parallel.wide_halo import get_wide_plan, wide_enabled

        if not wide_enabled():
            return None
        cached = getattr(self, "_wide_cached", None)
        if cached is not None and cached[0] is self.grid.epoch:
            return cached[1]
        plan = get_wide_plan(self.grid, self.hood_id, relevance="all")
        spec = None
        if plan.budget >= 2:
            from ..parallel.exec_cache import WideStepSpec

            wex = self.grid.halo(None)
            put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                                device=self.grid.device).to(dt)
            wt = {
                "w.nbr_rows": put(plan.nbr_rows, torch.int64),
                "w.nbr_valid": put(plan.nbr_valid, torch.bool),
                "w.steps_ok": put(plan.steps_ok, torch.int32),
                "w.local_mask": put(plan.local_mask, torch.bool),
            }
            wt.update(ring_args(wex, list(self.SPEC)))

            def bind(args, wargs, W):
                mex = MemberExchange(wex, wargs, W)

                def exchange(state):
                    return mex(state)

                def interior(state, dts, j):
                    alive = state["is_alive"].to(torch.int32)
                    nbr_alive = gather_neighbors(alive, wargs["w.nbr_rows"],
                                                 members=True)
                    count = (wargs["w.nbr_valid"] & (nbr_alive != 0)).sum(
                        dim=-1, dtype=torch.int32)
                    new_alive = _life_rule(count, alive)
                    live = wargs["w.steps_ok"] > j
                    # owned rows (live through the budget) equal the
                    # blocking step; the stale fringe keeps its values
                    zero = torch.zeros_like(count)
                    old_cnt = state["live_neighbor_count"].to(torch.int32)
                    cnt = torch.where(live & wargs["w.local_mask"], count,
                                      torch.where(live, zero, old_cnt))
                    return {"is_alive": torch.where(live, new_alive, alive).to(_U32),
                            "live_neighbor_count": cnt.to(_U32)}

                return exchange, interior

            spec = WideStepSpec(bind=bind, budget=plan.budget, args=wt,
                                local_mask=plan.local_mask)
        self._wide_cached = (self.grid.epoch, spec)
        return spec

    def batch_step_spec(self):
        """Cohort-batchable step (the JAX package's ``batch_step_spec``):
        the gather step (``gol``, whatever the dense 2-D layout) or the
        split-phase step (``gol.overlap``).  Game of Life takes no dt: the
        cohort's dt operand is ignored."""
        from ..parallel.exec_cache import (BatchStepSpec, args_key,
                                           default_steps_per_dispatch)
        from ..parallel.halo import MemberExchange, ring_args

        k = default_steps_per_dispatch()
        ex = self._exchange
        wide = self._wide_spec()
        if self.overlap:
            args = {}
            for p, (rows, nbr, valid) in zip(("inner.", "outer."), self._sides):
                args.update({p + "rows": rows, p + "nbr_rows": nbr,
                             p + "nbr_valid": valid})
            args["local_mask"] = self._local
            args.update(ring_args(ex, ["is_alive"]))

            def bind_overlap(args, W):
                mex = MemberExchange(ex, args, W)
                sides = [tuple(args[p + n] for n in ("rows", "nbr_rows", "nbr_valid"))
                         for p in ("inner.", "outer.")]

                def side(a, rows, nbr, valid):
                    count = (valid & (gather_neighbors(a, nbr, members=True) != 0)
                             ).sum(dim=-1, dtype=torch.int32)
                    return count, _life_rule(count, member_rows(a, rows))

                def body(state, dts):
                    field = {"is_alive": state["is_alive"]}
                    payload = mex.start(field)
                    cnt_i, new_i = side(state["is_alive"].to(torch.int32), *sides[0])
                    a2 = mex.finish(field, payload)["is_alive"].to(torch.int32)
                    cnt_o, new_o = side(a2, *sides[1])
                    out_a, cnt = a2.clone(), torch.zeros_like(a2)
                    for (rows, _, _), new, c in ((sides[0], new_i, cnt_i),
                                                 (sides[1], new_o, cnt_o)):
                        at = (*member_index(out_a, rows.dim()), rows)
                        out_a[at], cnt[at] = new, c
                    local = args["local_mask"]
                    return {
                        "is_alive": torch.where(local, out_a, a2).to(_U32),
                        "live_neighbor_count": torch.where(
                            local, cnt, torch.zeros_like(a2)).to(_U32),
                    }
                return body

            return BatchStepSpec(kind="gol.overlap",
                                 kernel_key=("gol.overlap_step", args_key(args)),
                                 bind=bind_overlap, args=args,
                                 steps_per_dispatch=k, wide=wide)
        args = {"nbr_rows": self.tables.nbr_rows,
                "nbr_valid": self.tables.nbr_valid,
                "local_mask": self.tables.local_mask}
        args.update(ring_args(ex, list(self.SPEC)))

        def bind_gather(args, W):
            mex = MemberExchange(ex, args, W)

            def body(state, dts):
                state = mex(state)
                alive = state["is_alive"].to(torch.int32)
                nbr_alive = gather_neighbors(alive, args["nbr_rows"], members=True)
                count = (args["nbr_valid"] & (nbr_alive != 0)).sum(
                    dim=-1, dtype=torch.int32)
                local = args["local_mask"]
                return {
                    "is_alive": torch.where(local, _life_rule(count, alive),
                                            alive).to(_U32),
                    "live_neighbor_count": torch.where(
                        local, count, torch.zeros_like(count)).to(_U32),
                }
            return body

        return BatchStepSpec(kind="gol", kernel_key=("gol.step", args_key(args)),
                             bind=bind_gather, args=args, steps_per_dispatch=k,
                             wide=wide)
