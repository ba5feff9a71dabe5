"""Dense fast path for uniform (refinement-level-0) grids.

When every leaf is at level 0 and the partition is z-slab aligned, each
device's cells form a dense ``[nz_local, ny, nx]`` block (cell ids are
x-fastest / z-slowest, ``dccrg_mapping.hpp:180-207``), stencils become
shifted slices, and the halo exchange collapses to two plane transfers up
and down the slab ring.

In this package all D slabs live in one ``[D, nz_local, ny, nx]`` tensor on
one device, so the ring's plane transfers are rolls of the top and bottom
planes over the leading (device) axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DenseInfo", "detect_dense", "detect_dense2d", "HaloExtend"]


@dataclass(frozen=True)
class DenseInfo:
    nx: int
    ny: int
    nz: int
    nz_local: int          # z planes per device
    n_devices: int
    periodic: tuple


def detect_dense(mapping, topology, leaves, n_devices: int) -> DenseInfo | None:
    """A grid is dense-eligible iff every leaf is level 0 and ownership is
    the id-order slab partition with D | nz."""
    nx, ny, nz = mapping.length
    if len(leaves) != nx * ny * nz:
        return None  # something is refined
    if nz % n_devices != 0:
        return None
    per = len(leaves) // n_devices
    expected = np.repeat(np.arange(n_devices, dtype=np.int32), per)
    if not np.array_equal(leaves.owner, expected):
        return None
    # leaves must be exactly the level-0 cells 1..n in order
    if leaves.cells[0] != 1 or leaves.cells[-1] != nx * ny * nz:
        return None
    return DenseInfo(
        nx=nx,
        ny=ny,
        nz=nz,
        nz_local=nz // n_devices,
        n_devices=n_devices,
        periodic=topology.periodic,
    )


def detect_dense2d(grid, hood_id):
    """Dense ``[D, ny_local, nx]`` y-slab layout for uniform 2-D grids —
    the 2-D sibling of :func:`detect_dense` (the reference's hello-world
    shape, ``simple_game_of_life.cpp``: an (N, N, 1) grid with the full
    length-1 vertex neighborhood).

    Under the id-order block partition the dense view is a pure reshape
    of the row layout (ids are x-fastest, rows ascend in id order), so no
    gather tables are needed; the halo is two boundary rows per device.
    Returns None unless: default hood of length 1, nz == 1 with
    non-periodic z (a periodic z of extent 1 would make every cell its
    own neighbor), all leaves level 0, and ownership the exact y-slab
    block striping."""
    if hood_id is not None:
        return None
    epoch = grid.epoch
    mapping = epoch.mapping
    nx, ny, nz = (int(v) for v in mapping.length)
    if nz != 1 or grid.topology.is_periodic(2):
        return None
    leaves = epoch.leaves
    N = len(leaves)
    if N != nx * ny or N == 0:
        return None
    if int(leaves.cells[0]) != 1 or int(leaves.cells[-1]) != N:
        return None
    D = epoch.n_devices
    if ny % D != 0:
        return None
    per = N // D
    expected = np.repeat(np.arange(D, dtype=leaves.owner.dtype), per)
    if not np.array_equal(leaves.owner, expected):
        return None
    hood = np.asarray(grid.neighborhoods[None])
    if len(hood) != 26 or np.abs(hood).max() != 1:
        return None
    return dict(
        nx=nx, ny=ny, nyl=ny // D, D=D,
        periodic=(grid.topology.is_periodic(0), grid.topology.is_periodic(1)),
    )


class HaloExtend:
    """Per-device leading-axis halo of a ``[D, n_loc, ...]`` slab stack —
    z planes for the 3-D slab layout, y rows for the 2-D one: device d
    receives the top slice of device d-1 below its block and the bottom
    slice of device d+1 above it (the ring's two transfers; for one
    device the ring degenerates to the local wrap)."""

    def __init__(self, info):
        """``info``: a DenseInfo, or a plain device count."""
        self.info = info
        self.n_devices = info if isinstance(info, int) else info.n_devices

    def __call__(self, blk: torch.Tensor) -> torch.Tensor:
        """blk: ``[D, nzl, ...]``. Returns ``[D, nzl+2, ...]``."""
        recv_below, recv_above = self.planes(blk)
        return torch.cat([recv_below, blk, recv_above], dim=1)

    def planes(self, blk: torch.Tensor):
        """The two received halo planes ``(below, above)``, each
        ``[D, 1, ...]``, without materializing the extended block."""
        top = blk[:, -1:]                    # plane sent upward
        bot = blk[:, :1]                     # plane sent downward
        return torch.roll(top, 1, 0), torch.roll(bot, -1, 0)
