"""Poisson solver on the (possibly AMR-refined) grid.

A port of the JAX package's ``models/poisson.py``, which reproduces the
discretization and algorithm of the reference's parallel Poisson solver
(``tests/poisson/poisson_solve.hpp``):

* geometric factors per face direction from cell-center distances,
  ``f_side = ±2 / (offset_side * total_offset)`` with missing neighbors
  giving factor 0 (Neumann walls) and the diagonal ``scaling_factor =
  -sum(f)`` (``poisson_solve.hpp:691-822``);
* a finer face neighbor's contribution is divided by 4
  (``poisson_solve.hpp:332-336``);
* the biconjugate-gradient iteration of Numerical Recipes 2.7.6 with both
  ``A·p`` and ``Aᵀ·p`` applied matrix-free (``poisson_solve.hpp:251-520``);
* the reference's three cell roles (``poisson_solve.hpp:146-150,
  829-965``): cells in ``solve_cells`` are solved, cells in ``skip_cells``
  act as missing neighbors, the rest are boundary cells whose values feed
  the solver but are never updated; boundary-boundary pairs are dropped.

The BiCG loop runs over one of three operator spaces, picked as the JAX
package picks them: the flat voxel operator (``ops/flat_poisson.py``) when
the grid qualifies, else the rolled static-offset operator
(``ops/rolled_gather.py``) when ``allow_rolled`` (default: the grid's
device is CUDA) and the offset histogram allows it, else the ``[D, R, K]``
gather tables.  The gather operator ``_apply`` stays the oracle and the
``residual`` diagnostic.  The loop is torch on the device with one host
check of the while-condition an iteration (a device-to-host sync an
iteration; the JAX package keeps the whole loop in one ``lax.while_loop``).

Float32 on one device slot with a flat layout of at most two levels that
fits (``bicg_fits``) solves in one launch of the whole-solve kernel
(``ops/poisson_kernel.py::bicg_solve``; its twin on CPU tensors).  There is
no fallback: a kernel that fails to build or launch raises.  With
``use_kernels=False`` the same grids solve through the twin on any device,
so kernel and plain solve agree bitwise, as the JAX package's two paths are
one computation.

The BiCG dots add one partial a slot, in slot order
(``utils/collectives.slot_sum``); one slot keeps its single sum.  So the
iteration count and the solution are the same bits on any controller
layout of the same slots.

Under several controllers (``parallel/mesh.py``) every controller builds the
replicated factors and tables and keeps its own slots' rows: the flat
operator holds its block of z-slabs and takes the z-rolls' end planes over
the slab ring; the rolled and gather operators refresh ghosts through the
grid's halo (kernel B9, the transport, B9); the dots' partials meet in one
all-gather.  Every controller asserts that it took the same operator space.
The whole-solve kernel B8 stays a one-slot kernel, as in the JAX package:
several controllers always mean at least two slots, so their solves run the
torch loop.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import numpy_dtype, torch_dtype
from ..ops.flat_poisson import build_flat_poisson, make_flat_poisson_apply
from ..ops.poisson_kernel import bicg_fits, bicg_loop, bicg_solve, bicg_solve_plain
from ..ops.rolled_gather import build_rolled_matvec_multi, make_rolled_apply_multi
from ..parallel.dense import HaloExtend
from ..parallel.stencil import StencilTables, gather_neighbors, ordered_sum
from ..utils.collectives import assert_agreement, fetch, slot_sum

__all__ = ["Poisson"]


class Poisson:
    SPEC = {
        "rhs": ((), np.float64),
        "solution": ((), np.float64),
    }

    #: cell roles, same codes as the reference (poisson_solve.hpp:146-150)
    SOLVE_CELL = 0
    BOUNDARY_CELL = 1
    SKIP_CELL = 2

    def __init__(self, grid, hood_id=None, dtype=np.float64,
                 solve_cells=None, skip_cells=None, allow_flat=True,
                 use_kernels=True, allow_rolled=None):
        self.grid = grid
        self.hood_id = hood_id
        self.dtype = numpy_dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.device = grid.device
        self.use_kernels = bool(use_kernels)
        self.spec = {k: (s, self.dtype) for k, (s, _) in self.SPEC.items()}
        self.tables = StencilTables(grid, hood_id, with_geometry=True)
        self._exchange = grid.halo(hood_id)
        self._full_solve = solve_cells is None
        self._build_cell_types(solve_cells, skip_cells)
        self._build_factors()
        self._flat_tables = None
        self._flat_ring = None
        self._flat = self._build_flat() if allow_flat else None
        # the rolled operator replaces the [R, K] row gather where the flat
        # operator does not engage; by default on CUDA only, mirroring the
        # JAX package's "not the CPU backend" (its CPU gather is already
        # vectorized)
        if allow_rolled is None:
            allow_rolled = self.device.type == "cuda"
        self._rolled = (self._build_rolled()
                        if allow_rolled and self._flat is None else None)
        #: the whole-solve path where the grid qualifies (B8, or its twin
        #: with ``use_kernels=False``: :meth:`_fast_solve` chooses), else None
        self._solve_whole = self._build_fast_solver()
        space = ("flat" if self._flat is not None else
                 "rolled" if self._rolled is not None else "gather")
        #: the operator space the BiCG loop runs in: "flat", "rolled" or
        #: "gather" (host metadata decides it: the same on every controller)
        self.operator_space = space
        assert_agreement("Poisson operator space",
                         f"{space} {self._solve_fast is not None}".encode())

    @property
    def _solve_fast(self):
        """The whole-solve kernel path (B8) where it engages: None with
        ``use_kernels=False`` or where the grid does not qualify."""
        return self._solve_whole if self.use_kernels else None

    def _put(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(
            self.torch_dtype if dtype is None else dtype)

    def _put_slots(self, a, dtype=None):
        """``_put`` of this controller's slots of a per-slot host table."""
        return self._put(self.grid.slot_view(a), dtype)

    def _build_flat(self):
        """The flat voxel operator (``ops/flat_poisson.py``), engaged when the
        grid qualifies (Cartesian, leaf levels <= 4, one slot or the voxel
        z-slab partition); else None."""
        t = build_flat_poisson(
            self.grid, self._f_pos_leaf, self._f_neg_leaf, self._scaling_leaf,
            self._cell_type_leaf, self.SOLVE_CELL, self.SKIP_CELL,
            self.BOUNDARY_CELL,
        )
        if t is None:
            return None
        self._flat_tables = t
        ctl = self.grid.controllers
        #: the flat operator's slab ring across controllers (None on one)
        self._flat_ring = HaloExtend(t["n_devices"], ctl) if ctl.multi else None
        return make_flat_poisson_apply(t, self.torch_dtype, self.device,
                                       slots=self.grid.slots, ring=self._flat_ring)

    def _build_cell_types(self, solve_cells, skip_cells):
        """Per-leaf role array (reference cache_system_info,
        ``poisson_solve.hpp:829-965``): everything not solved or skipped is
        a boundary cell; solve membership wins over skip."""
        leaves = self.grid.epoch.leaves
        N = len(leaves)
        if solve_cells is None:
            types = np.full(N, self.SOLVE_CELL, dtype=np.int8)
            if skip_cells is not None and len(skip_cells):
                pos = leaves.position(np.asarray(skip_cells, dtype=np.uint64))
                types[pos] = self.SKIP_CELL
        else:
            types = np.full(N, self.BOUNDARY_CELL, dtype=np.int8)
            if skip_cells is not None and len(skip_cells):
                pos = leaves.position(np.asarray(skip_cells, dtype=np.uint64))
                types[pos] = self.SKIP_CELL
            pos = leaves.position(np.asarray(solve_cells, dtype=np.uint64))
            types[pos] = self.SOLVE_CELL
        self._cell_type_leaf = types

    # ---------------------------------------------------------- factors

    def _build_factors(self):
        """Factors are computed over the GLOBAL leaf arrays (so transpose
        multipliers can reference any neighbor's factors, local or ghost)
        and then scattered into the per-slot [D, R, K] tables."""
        grid = self.grid
        epoch = grid.epoch
        hood = epoch.hoods[self.hood_id]
        lists = hood.lists
        leaves = epoch.leaves
        N = len(leaves)
        D, R, K = hood.nbr_rows.shape

        counts = np.diff(lists.start)
        src = np.repeat(np.arange(N, dtype=np.int64), counts)
        nbr = lists.nbr_pos
        off = lists.offset                               # (E, 3) index units
        clen_i = grid.mapping.get_cell_length_in_indices(leaves.cells).astype(np.int64)
        nlen_i = clen_i[nbr]
        slen_i = clen_i[src]

        # face classification per entry (solve.hpp:71-123 offset logic)
        overlap = (off < slen_i[:, None]) & (off > -nlen_i[:, None])
        n_overlap = overlap.sum(axis=1)
        direction = np.zeros(len(src), dtype=np.int8)
        for d in range(3):
            direction = np.where(
                (n_overlap == 2) & (off[:, d] == slen_i), d + 1, direction
            )
            direction = np.where(
                (n_overlap == 2) & (off[:, d] == -nlen_i), -(d + 1), direction
            )

        # pairs involving a skip cell act as missing neighbors, and
        # boundary-boundary pairs are dropped (poisson_solve.hpp:896-965)
        types = self._cell_type_leaf
        active_pair = (
            (types[src] != self.SKIP_CELL)
            & (types[nbr] != self.SKIP_CELL)
            & ~(
                (types[src] == self.BOUNDARY_CELL)
                & (types[nbr] == self.BOUNDARY_CELL)
            )
        )

        half = 0.5 * grid.geometry.get_length(leaves.cells)   # (N, 3)
        # per-leaf center offsets toward face neighbors; missing neighbors
        # default to own size but give factor 0 (poisson_solve.hpp:716-724)
        pos_off = 2.0 * half.copy()
        neg_off = -2.0 * half.copy()
        has_pos = np.zeros((N, 3), dtype=bool)
        has_neg = np.zeros((N, 3), dtype=bool)
        for d in range(3):
            m = (direction == d + 1) & active_pair
            pos_off[src[m], d] = half[src[m], d] + half[nbr[m], d]
            has_pos[src[m], d] = True
            m = (direction == -(d + 1)) & active_pair
            neg_off[src[m], d] = -(half[src[m], d] + half[nbr[m], d])
            has_neg[src[m], d] = True

        total = pos_off - neg_off                        # (N, 3)
        f_pos = np.where(has_pos, 2.0 / (pos_off * total), 0.0)
        f_neg = np.where(has_neg, -2.0 / (neg_off * total), 0.0)
        scaling_leaf = -(f_pos.sum(-1) + f_neg.sum(-1))  # (N,)

        # per-entry multipliers at leaf level
        e_fwd = np.zeros(len(src))
        e_rev = np.zeros(len(src))
        for d in range(3):
            m = direction == d + 1
            e_fwd[m] = f_pos[src[m], d]
            e_rev[m] = f_neg[nbr[m], d]   # from n's view, c sits at -d
            m = direction == -(d + 1)
            e_fwd[m] = f_neg[src[m], d]
            e_rev[m] = f_pos[nbr[m], d]
        finer = nlen_i < slen_i           # neighbor finer than cell
        e_fwd = np.where(finer, e_fwd / 4.0, e_fwd)
        coarser = nlen_i > slen_i         # cell finer than neighbor
        e_rev = np.where(coarser, e_rev / 4.0, e_rev)
        nonface = (direction == 0) | ~active_pair
        e_fwd[nonface] = 0.0
        e_rev[nonface] = 0.0

        # scatter into [D, R, K] aligned with the epoch's gather tables
        ecol = np.arange(int(lists.start[-1]), dtype=np.int64) - np.repeat(
            lists.start[:-1], counts
        )
        owner = leaves.owner.astype(np.int64)
        mult_fwd = np.zeros((D, R, K))
        mult_rev = np.zeros((D, R, K))
        for d in range(D):
            sel = owner[src] == d
            rows = epoch.row_of[src[sel]]
            cols = ecol[sel]
            mult_fwd[d, rows, cols] = e_fwd[sel]
            mult_rev[d, rows, cols] = e_rev[sel]

        # diagonal + cell role for every row (ghosts included)
        scaling_rows = np.zeros((D, R))
        type_rows = np.full((D, R), self.SKIP_CELL, dtype=np.int8)
        for d in range(D):
            lp, gp = epoch.local_pos[d], epoch.ghost_pos[d]
            scaling_rows[d, : len(lp)] = scaling_leaf[lp]
            scaling_rows[d, len(lp) : len(lp) + len(gp)] = scaling_leaf[gp]
            type_rows[d, : len(lp)] = types[lp]
            type_rows[d, len(lp) : len(lp) + len(gp)] = types[gp]

        self._scaling = self._put_slots(scaling_rows)
        # the [D, R, K] multiplier tables go to the device only when the
        # gather operator runs (the solver's gather space or residual())
        self._mult_np = (mult_fwd, mult_rev)
        self._mult_dev = [None, None]
        self._scaling_np = scaling_rows
        self._solve_mask = self.tables.local_mask & self._put_slots(
            type_rows == self.SOLVE_CELL, torch.bool)
        # leaf-level factors kept for the flat operator
        # (ops/flat_poisson.py): per-(leaf, axis) side factors + diagonal
        self._f_pos_leaf = f_pos
        self._f_neg_leaf = f_neg
        self._scaling_leaf = scaling_leaf

    # ----------------------------------------------------------- operators

    def _mult_table(self, i):
        """Device copy of the [D, R, K] multiplier table ``i`` (0 = fwd,
        1 = transpose; this controller's slots), uploaded on first use."""
        if self._mult_dev[i] is None:
            self._mult_dev[i] = self._put_slots(self._mult_np[i])
        return self._mult_dev[i]

    def _mult_tables(self):
        return self._mult_table(0), self._mult_table(1)

    def _apply(self, x, mult):
        """A·x (or Aᵀ·x with the transpose table): ghost refresh, then
        gather and the slot-ordered reduction."""
        x = self._exchange({"v": x})["v"]
        xn = gather_neighbors(x, self.tables.nbr_rows)
        return self._scaling * x + ordered_sum(mult * xn, axis=-1), x

    def _build_rolled(self):
        """(apply_fwd, apply_rev) on the rolled static-offset operator
        (``ops/rolled_gather.py``), or None when any slot's offset histogram
        refuses the decomposition.  Each slot's row block (local + ghost +
        scratch, ghosts refreshed first, as in ``_apply``) is its own roll
        space.  The same operator as ``_apply`` up to fp association."""
        nbr = self.grid.epoch.hoods[self.hood_id].nbr_rows
        applies = []
        for mult in self._mult_np:
            t = build_rolled_matvec_multi(nbr, mult, self._scaling_np)
            if t is None:
                return None
            applies.append(make_rolled_apply_multi(t, self.torch_dtype,
                                                   self.device,
                                                   slots=self.grid.slots))

        def wrap(ap):
            return lambda x: ap(self._exchange({"v": x})["v"])

        return wrap(applies[0]), wrap(applies[1])

    def _operator_space(self):
        """(apply_fwd, apply_rev, lift, project, solve_mask, dot_mask) of
        the space the BiCG loop runs in: flat voxels, or the [D, R] rows
        with the rolled or the gather operator."""
        local = self.tables.local_mask
        if self._flat is not None:
            apply_fwd, apply_rev, voxelize, writeback, masks = self._flat
            return (apply_fwd, apply_rev, voxelize, writeback, masks["solve"],
                    masks["dot"])
        if self._rolled is not None:
            apply_fwd, apply_rev = self._rolled
        else:
            mult_fwd, mult_rev = self._mult_tables()
            apply_fwd = lambda v: self._apply(v, mult_fwd)[0]
            apply_rev = lambda v: self._apply(v, mult_rev)[0]
        zero = torch.zeros((), dtype=self.torch_dtype, device=self.device)
        # boundary cells keep their given solution values: they feed the
        # initial residual (Dirichlet lifting) but never change
        lift = lambda row_arr: torch.where(local, row_arr, zero)
        return (apply_fwd, apply_rev, lift, lambda v: v, self._solve_mask,
                self._solve_mask)

    def _solve(self, state, max_iterations, stop_residual, stop_after_increase):
        """The BiCG loop (the JAX package's ``_build_solver`` /
        ``_build_gather_solver`` body) in torch, ``ops.poisson_kernel.
        bicg_loop`` over the operator space.  Thresholds are float64, as the
        JAX package's are under x64."""
        apply_fwd, apply_rev, lift, project, solve_mask, dot_mask = (
            self._operator_space())
        dev = self.device
        zero = torch.zeros((), dtype=self.torch_dtype, device=dev)
        f64 = lambda v: torch.tensor(float(v), dtype=torch.float64, device=dev)
        n_slots = self.grid.n_devices
        n_local = len(self.grid.slots)

        def dot(a, b):
            """The masked dot: one slot its single sum; else a partial a
            slot (each in its own buffer, so no partial's reduction depends
            on where its slot sits in this controller's block), added in
            slot order over every controller (``slot_sum``)."""
            prod = torch.where(dot_mask, a * b, zero)
            if n_slots == 1:
                return prod.sum()
            per = prod.reshape(n_local, -1)
            return slot_sum(torch.stack([per[d].clone().sum()
                                         for d in range(n_local)]))

        best_x, best_res, i = bicg_loop(
            apply_fwd, apply_rev,
            torch.where(solve_mask, lift(state["rhs"]), zero),
            lift(state["solution"]), solve_mask, dot,
            max_iterations, f64(stop_residual), f64(stop_after_increase),
        )
        sol = torch.where(self.tables.local_mask, project(best_x), zero)
        return {**state, "solution": sol}, best_res, i

    def _build_fast_solver(self):
        """The whole-solve path (``ops/poisson_kernel.py``), or None when
        ineligible — the JAX package's gating: flat tables, one slot, at
        most two levels (the kernel pools with the two-level roll chain),
        float32, and the fit rule.  With kernels on it launches B8, with
        ``use_kernels=False`` it runs B8's plain twin: the same computation
        to the bit, as the JAX package's plain solve and its kernel are one
        ``jnp.sum`` computation (an unconverged singular solve drifts along
        the null space with the dots' rounding, so two orders end apart)."""
        t = self._flat_tables
        if (
            t is None
            or t["n_devices"] != 1
            or t.get("vl", 1) > 1
            or self.dtype != np.float32
            or not bicg_fits(int(np.prod(t["shape"])))
        ):
            return None
        f32 = lambda a: self._put(a, torch.float32)
        self._bicg_statics = (
            [f32(w) for pair in t["weights"] for w in pair]
            + [f32(t["scaling"]), f32(t["fine"]), f32(~t["fine"]),
               f32(t["orig"]), f32(t["solve"]), f32(t["dot_mask"])]
        )
        self._bicg_has_coarse = bool(t["has_coarse"])
        return self._fast_solve

    def _bicg_inputs(self, state):
        """The whole-solve kernel's 14 float32 voxel arrays for ``state``:
        the lifted rhs (masked to solve voxels), the lifted solution, the
        face weights, the diagonal and the masks."""
        _fwd, _rev, voxelize, _wb, masks = self._flat
        zero = torch.zeros((), dtype=self.torch_dtype, device=self.device)
        rhs = torch.where(masks["solve"], voxelize(state["rhs"]), zero)
        x = voxelize(state["solution"])
        return (rhs.to(torch.float32), x.to(torch.float32), *self._bicg_statics)

    def _fast_solve(self, state, max_iterations, stop_residual, stop_increase):
        solve = bicg_solve if self.use_kernels else bicg_solve_plain
        best_x, best_res, it = solve(
            *self._bicg_inputs(state), max_iterations, stop_residual,
            stop_increase, has_coarse=self._bicg_has_coarse,
        )
        writeback = self._flat[3]
        zero = torch.zeros((), dtype=self.torch_dtype, device=self.device)
        sol = torch.where(self.tables.local_mask,
                          writeback(best_x.to(self.torch_dtype)), zero)
        return {**state, "solution": sol}, best_res[0], it[0]

    # ---------------------------------------------------------- user API

    def initialize_state(self, rhs_by_cell):
        grid = self.grid
        state = grid.new_state(self.spec)
        cells = grid.get_cells()
        rhs = np.asarray(rhs_by_cell, dtype=np.float64)
        # zero-mean the charge like the reference tests do for all-periodic
        # grids (volume-weighted so AMR stays consistent)
        vol = np.prod(grid.geometry.get_length(cells), axis=-1)
        if all(grid.topology.periodic) and self._full_solve:
            rhs = rhs - (rhs * vol).sum() / vol.sum()
        return grid.set_cell_data(state, "rhs", cells, rhs)

    def solve(
        self,
        state,
        max_iterations: int = 1000,
        stop_residual: float = 1e-12,
        stop_after_residual_increase: float = 10.0,
        restarts: int = 0,
    ):
        """Returns (state, best_residual, iterations).

        ``restarts``: BiCG on non-normal systems (AMR + mixed cell roles)
        can break down mid-Krylov-space and stop at the semi-convergence
        rule far from the target; re-entering from the best solution
        rebuilds the space and recovers (the reference's drivers re-invoke
        solve for exactly this).  With ``restarts=N`` the solve re-enters up
        to N more times until ``stop_residual`` is met or an attempt makes
        no progress; iterations accumulate.  Default 0 = the reference's
        single-trajectory behavior."""
        if restarts > 0:
            total_it = 0
            prev_res = float("inf")
            for _ in range(restarts + 1):
                state, res, it = self.solve(
                    state, max_iterations, stop_residual,
                    stop_after_residual_increase,
                )
                total_it += it
                if res <= stop_residual or not res < prev_res:
                    break  # converged, or the attempt made no progress
                prev_res = res
            return state, res, total_it
        run = self._solve_whole or self._solve
        state, res, it = run(state, int(max_iterations), stop_residual,
                             stop_after_residual_increase)
        return state, float(res), int(it)

    def residual(self, state) -> float:
        """||rhs - A·solution|| over the solve cells, on the gather
        operator: a collective under several controllers (every slot's
        rows gathered, one sum of squares, one ``sqrt``)."""
        Ax, _ = self._apply(state["solution"], self._mult_table(0))
        zero = torch.zeros((), dtype=Ax.dtype, device=Ax.device)
        r = fetch(torch.where(self._solve_mask, state["rhs"] - Ax, zero))
        return float(np.sqrt((r * r).sum()))
