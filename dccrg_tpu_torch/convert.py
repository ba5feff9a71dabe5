"""Dtype helpers and numpy <-> state conversion.

``state_from_numpy`` / ``state_to_numpy`` carry a dense advection state
(``{field: [D, nz_local, ny, nx]}``) between numpy and this package, so a
state produced elsewhere — by the JAX package, a file, a test — can be run
here from identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_dtype", "numpy_dtype", "state_from_numpy", "state_to_numpy"]


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


def state_from_numpy(adv, arrays) -> dict:
    """A state for the dense ``Advection`` model ``adv`` from numpy arrays
    (one per field, each ``[D, nz_local, ny, nx]``), cast to the model's
    dtype and placed on its grid's device."""
    info = adv.dense
    shape = (info.n_devices, info.nz_local, info.ny, info.nx)
    state = {}
    for name, arr in arrays.items():
        host = np.array(arr, dtype=adv.dtype, order="C")  # a writable copy
        if host.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {host.shape}")
        state[name] = torch.from_numpy(host).to(adv.grid.device)
    return state


def state_to_numpy(state) -> dict:
    """Host numpy copies of every field of a state."""
    return {name: t.detach().cpu().numpy() for name, t in state.items()}
