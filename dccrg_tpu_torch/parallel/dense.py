"""Dense fast path for uniform (refinement-level-0) grids.

When every leaf is at level 0 and the partition is z-slab aligned, each
device's cells form a dense ``[nz_local, ny, nx]`` block (cell ids are
x-fastest / z-slowest, ``dccrg_mapping.hpp:180-207``), stencils become
shifted slices, and the halo exchange collapses to two plane transfers up
and down the slab ring.

Under one controller all D slabs live in one ``[D, nz_local, ny, nx]``
tensor on one device, so the ring's plane transfers are rolls of the top and
bottom planes over the leading (slot) axis.  Under several controllers
(``parallel/mesh.py``) each holds its block of slots, ``[len(slots),
nz_local, ...]``: the planes between its own slots are still rolls, and the
two that cross to the ring neighbours' controllers travel over the payload
transport (``parallel/transport.py``).
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
    """Per-slot leading-axis halo of a ``[D, n_loc, ...]`` slab stack —
    z planes for the 3-D slab layout, y rows for the 2-D one: slot d
    receives the top slice of slot d-1 below its block and the bottom
    slice of slot d+1 above it (the ring's two transfers; for one slot the
    ring degenerates to the local wrap).

    Under several controllers (``controllers.multi``) the stack is this
    controller's block of slots, ``[len(slots), n_loc, ...]``, and the
    planes are bit for bit those one controller's roll gives these slots:
    the top plane of the last local slot goes to rank ``(r + 1) % P``, the
    bottom plane of the first to rank ``(r - 1) % P``, and the matching
    planes come back from them, in one transport batch a call.  The wrap
    planes at an open end travel too; the model masks their faces as on one
    controller.  A member stack ``[W, D, nzl, ...]`` (a cohort's) crosses
    with all W members' planes in each message.  Every controller calls
    :meth:`planes` in the same order."""

    def __init__(self, info, controllers=None):
        """``info``: a DenseInfo, or a plain slot count; ``controllers``: a
        ``parallel.mesh.Controllers`` (None or a single one: the roll)."""
        self.info = info
        self.n_devices = info if isinstance(info, int) else info.n_devices
        self.controllers = (controllers if controllers is not None
                            and controllers.multi else None)
        self._transport = None
        if self.controllers is not None:
            from .transport import Transport

            self.controllers.local_slots(self.n_devices)   # D % P == 0
            self._transport = Transport(self.controllers)

    @property
    def transport_bytes(self) -> int:
        """Bytes this ring has sent to other controllers (0 under one)."""
        return 0 if self._transport is None else self._transport.bytes_sent

    def __call__(self, blk: torch.Tensor, members: bool = False) -> torch.Tensor:
        """blk: ``[D, nzl, ...]`` (``[W, D, nzl, ...]`` with ``members``).
        Returns ``[D, nzl+2, ...]`` (``[W, D, nzl+2, ...]``)."""
        recv_below, recv_above = self.planes(blk, members)
        return torch.cat([recv_below, blk, recv_above], dim=2 if members else 1)

    def planes(self, blk: torch.Tensor, members: bool = False):
        """The two received halo planes ``(below, above)``, each
        ``[D, 1, ...]``, without materializing the extended block.  With
        ``members`` the block is ``[W, D, nzl, ...]``, W independent slab
        rings: each member's planes come from its own slots, and under
        several controllers every member's crossing planes, ``[W, 1, ...]``,
        travel in the one transport batch of the call."""
        a = 1 if members else 0
        top = blk.narrow(a + 1, blk.shape[a + 1] - 1, 1)   # plane sent upward
        bot = blk.narrow(a + 1, 0, 1)                      # plane sent downward
        below, above = torch.roll(top, 1, a), torch.roll(bot, -1, a)
        if self.controllers is None:
            return below, above
        # the ring's two crossings: this block's first slot receives from
        # the previous controller's last, its last from the next one's first
        lo, hi = self.cross(top.select(a, -1), bot.select(a, 0))
        below.select(a, 0).copy_(lo)
        above.select(a, -1).copy_(hi)
        return below, above

    def cross(self, up: torch.Tensor, down: torch.Tensor):
        """The controller ring's two crossings alone: send ``up`` to rank
        ``(r + 1) % P`` and ``down`` to rank ``(r - 1) % P``; return what
        arrives ``(from below, from above)`` — the previous rank's ``up``
        and the next rank's ``down``.  One transport batch; every
        controller calls it in the same order.  Under one controller the
        ring closes on itself: ``(up, down)``."""
        if self.controllers is None:
            return up, down
        ctl = self.controllers
        to_up, to_down = (ctl.rank + 1) % ctl.size, (ctl.rank - 1) % ctl.size
        recv_lo = torch.empty(up.shape, dtype=up.dtype, device=up.device)
        recv_hi = torch.empty(down.shape, dtype=down.dtype, device=down.device)
        # canonical order on every rank: sends (up, down), receives (below,
        # above); with P = 2 both go to one peer, and its k-th receive from
        # this rank meets this rank's k-th send
        self._transport.exchange(
            [(to_up, up.contiguous()), (to_down, down.contiguous())],
            [(to_down, recv_lo), (to_up, recv_hi)])
        return recv_lo, recv_hi
