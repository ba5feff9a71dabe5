"""Host-metadata collectives: the single-process part of the JAX package's
``utils/collectives.py`` (the role of the reference's MPI support layer,
``dccrg_mpi_support.hpp``: ``All_Gather`` ``:98-231``, ``All_Reduce``
``:237-266``, ``Some_Reduce`` ``:282-377``).

One Python process drives every device slot, so per-device metadata is
replicated on the controller and agreement between controllers is free:
the helpers below are the identities and local reductions the JAX package
runs with one controller.  Its process-level and point-to-point transports
are not ported.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fetch", "sync_partition_inputs", "all_gather", "all_reduce",
           "some_reduce", "halo_peers"]


def fetch(x, dtype=None) -> np.ndarray:
    """Device -> host readback of a tensor (numpy arrays pass through)."""
    out = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return out if dtype is None else out.astype(dtype, copy=False)


def sync_partition_inputs(pin_requests: dict, cell_weights: dict) -> tuple:
    """The merged (pins, weights) view every controller partitions with
    (the reference's ``update_pin_requests`` All_Gather,
    ``dccrg.hpp:8297-8340``): the identity under one controller."""
    return pin_requests, cell_weights


def all_gather(per_device_values) -> list:
    """Every device's value, visible everywhere (reference All_Gather)."""
    return list(per_device_values)


def all_reduce(per_device_values, op=np.add):
    """Reduce all devices' values to one result (reference All_Reduce);
    any associative ufunc (add, minimum, maximum, ...)."""
    return op.reduce(np.asarray(per_device_values), axis=0)


def halo_peers(grid, device: int, hood_id=None) -> np.ndarray:
    """Devices that exchange halo cells with the given one."""
    pc = grid.epoch.hoods[hood_id].pair_counts
    return np.flatnonzero((pc[device] > 0) | (pc[:, device] > 0))


def some_reduce(grid, per_device_values, device: int, op=np.add, hood_id=None):
    """Reduce only among a device and its halo peers (the reference's
    neighbor-only ``Some_Reduce``), in ascending device order."""
    peers = halo_peers(grid, device, hood_id)
    vals = np.asarray(per_device_values)
    members = np.unique(np.concatenate([[device], peers])).astype(np.int64)
    return op.reduce(vals[members], axis=0)
