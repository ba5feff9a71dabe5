"""Dtype helpers and numpy <-> state conversion.

``state_from_numpy`` / ``state_to_numpy`` carry a dense advection state
(``{field: [D, nz_local, ny, nx]}``) between numpy and this package,
``vlasov_state_from_numpy`` a dense Vlasov state (``{"f": [D, nz_local, ny,
nx, B]}``), and ``rows_state_from_numpy`` a row-layout state (``{field:
[D, R, ...]}``, e.g. a Game of Life or general-path Vlasov state) by cell
id, so a state produced elsewhere — by the JAX package, a file, a test —
can be run here from identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_dtype", "numpy_dtype", "state_from_numpy", "state_to_numpy",
           "vlasov_state_from_numpy", "rows_state_from_numpy"]


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy/torch dtype (or anything ``np.dtype`` takes)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy/torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _slot_block(grid, host):
    """This controller's slots of a ``[D, ...]`` host array (all of it
    under one controller), as a writable C-ordered copy."""
    slots = grid.slots
    return np.ascontiguousarray(host[slots.start:slots.stop])


def state_from_numpy(adv, arrays) -> dict:
    """A state for the dense ``Advection`` model ``adv`` from numpy arrays
    (one per field, each ``[D, nz_local, ny, nx]``), cast to the model's
    dtype and placed on its grid's device (this controller's block of
    slots under several controllers)."""
    info = adv.dense
    shape = (info.n_devices, info.nz_local, info.ny, info.nx)
    state = {}
    for name, arr in arrays.items():
        host = np.array(arr, dtype=adv.dtype, order="C")  # a writable copy
        if host.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {host.shape}")
        state[name] = torch.from_numpy(_slot_block(adv.grid, host)).to(adv.grid.device)
    return state


def vlasov_state_from_numpy(vl, f) -> dict:
    """A state for the dense ``Vlasov`` model ``vl`` from the numpy phase
    space ``f [D, nz_local, ny, nx, B]``, cast to the model's dtype and
    placed on its grid's device (this controller's block of slots under
    several controllers)."""
    info = vl.info
    if info is None:
        raise ValueError("the model runs the general layout: use rows_state_from_numpy")
    shape = (info.n_devices, info.nz_local, info.ny, info.nx, vl.B)
    host = np.array(f, dtype=vl.dtype, order="C")  # a writable copy
    if host.shape != shape:
        raise ValueError(f"f: expected shape {shape}, got {host.shape}")
    return {"f": torch.from_numpy(_slot_block(vl.grid, host)).to(vl.device)}


def state_to_numpy(state) -> dict:
    """Host numpy copies of every field of a state: every slot, ``[D,
    ...]``, whatever the controllers (a collective under several:
    ``utils.collectives.fetch``)."""
    from .utils.collectives import fetch

    return {name: fetch(t) for name, t in state.items()}


def rows_state_from_numpy(grid, arrays, cell_ids) -> dict:
    """The state of ``grid`` (this package's) holding the values of a
    row-layout state from another epoch of the same leaf set and owners:
    ``arrays`` maps fields to numpy ``[D, R', ...]`` arrays laid out by
    ``cell_ids`` ``[D, R']`` (that epoch's row -> cell id table, 0 on pad
    rows).  Values go by cell id, never by row: every local and ghost row of
    ``grid`` gets the value its cell holds on its owner's row; pad rows are
    0.  The arrays keep their dtype and land on the grid's device."""
    ep = grid.epoch
    leaves = ep.leaves
    cell_ids = np.asarray(cell_ids, dtype=np.uint64)
    if cell_ids.shape[0] != ep.n_devices:
        raise ValueError(
            f"cell_ids cover {cell_ids.shape[0]} devices, the grid {ep.n_devices}")
    # source row of every leaf on its owning device
    src_row = np.full(len(leaves), -1, dtype=np.int64)
    for d in range(ep.n_devices):
        pos = leaves.position(cell_ids[d])
        own = (pos >= 0) & (leaves.owner[np.maximum(pos, 0)] == d)
        src_row[pos[own]] = np.flatnonzero(own)
    if (src_row < 0).any():
        raise ValueError("cell_ids do not hold every leaf on its owner")
    dst = []
    for d in range(ep.n_devices):
        rows = np.arange(int(ep.n_local[d] + ep.n_ghost[d]))
        pos = leaves.position(ep.cell_ids[d, rows])
        dst.append((rows, leaves.owner[pos], src_row[pos]))
    state = {}
    for name, arr in arrays.items():
        host = np.asarray(arr)
        if host.shape[:2] != cell_ids.shape:
            raise ValueError(
                f"{name}: leading shape {host.shape[:2]} != cell_ids {cell_ids.shape}")
        out = np.zeros((ep.n_devices, ep.R) + host.shape[2:], dtype=host.dtype)
        for d, (rows, src_dev, src) in enumerate(dst):
            out[d, rows] = host[src_dev, src]
        state[name] = torch.from_numpy(out).to(grid.device)
    return state
