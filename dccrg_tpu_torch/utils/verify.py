"""Runtime verification layer — the analogue of the reference's
``#ifdef DEBUG`` machinery (``is_consistent``/``verify_neighbors``/
``verify_remote_neighbor_info``/``verify_user_data``,
``dccrg.hpp:12264-12850``).

Where the reference cross-checks replicated state between MPI ranks, the
single-controller design has one directory — so verification means checking
the *internal* consistency of every derived structure against the leaf set,
plus ghost-copy correctness of user data.  Call after mutations in tests or
debugging sessions; it is pure host-side numpy.  A copy of the JAX
package's ``utils/verify.py``; payloads are read back with
``collectives.fetch`` (under several controllers a collective that gives
every controller all slots' rows, so ``verify_user_data`` and
``verify_finite`` check every slot on every controller), and ``verify_grid`` compares the neighbour pairs as
sorted integer keys and sums the leaves' volume over their distinct edge
lengths, where the JAX package builds Python sets and sums cell by cell
(the same invariants; a re-landing of a million cells verifies in about a
second instead of about twenty).
"""
from __future__ import annotations

import os

import numpy as np
from .collectives import fetch

__all__ = ["verify_grid", "verify_user_data", "verify_finite",
           "compare_epochs"]


def verify_finite(grid, state, spec) -> None:
    """Raise AssertionError naming the first field/device carrying a
    non-finite value in a local (owned) row — the detection oracle for
    halo NaN storms (the ``halo.nan`` injection site): a poisoned
    payload row is owned by SOME device, so scanning local rows finds
    every storm without double-reporting its ghost copies."""
    epoch = grid.epoch
    for name, (shape, dt) in spec.items():
        if not np.issubdtype(np.dtype(dt), np.floating):
            continue
        arr = fetch(state[name])
        for d in range(grid.n_devices):
            rows = epoch.row_of[epoch.local_pos[d]]
            vals = arr[d, rows]
            if not np.isfinite(vals).all():
                bad = int(np.count_nonzero(~np.isfinite(vals)))
                raise AssertionError(
                    f"non-finite values in field {name!r} on device {d} "
                    f"({bad} entries) — corrupted payload (NaN storm?)"
                )


def compare_epochs(got, want) -> None:
    """Assert two epochs carry bit-identical derived state, table by
    table — the incremental rebuild's oracle check (``got`` from
    ``parallel/epoch_delta.py``, ``want`` a fresh ``build_epoch``).
    Raises AssertionError naming the first differing table."""
    assert got.n_devices == want.n_devices
    assert got.R == want.R, (got.R, want.R)
    np.testing.assert_array_equal(got.leaves.cells, want.leaves.cells)
    np.testing.assert_array_equal(got.leaves.owner, want.leaves.owner)
    for name in ("n_local", "n_ghost", "row_of", "cell_len", "cell_level",
                 "cell_ids", "local_mask"):
        np.testing.assert_array_equal(
            getattr(got, name), getattr(want, name), err_msg=f"epoch.{name}"
        )
    for d in range(got.n_devices):
        np.testing.assert_array_equal(
            got.local_pos[d], want.local_pos[d], err_msg=f"local_pos[{d}]"
        )
        np.testing.assert_array_equal(
            got.ghost_pos[d], want.ghost_pos[d], err_msg=f"ghost_pos[{d}]"
        )
    assert (got.dense is None) == (want.dense is None), "dense flag"
    assert set(got.hoods) == set(want.hoods), "hood ids"
    for hid in want.hoods:
        g, w = got.hoods[hid], want.hoods[hid]
        np.testing.assert_array_equal(
            g.offsets, w.offsets, err_msg=f"hood {hid}: offsets"
        )
        for name in ("to_start", "to_src", "send_rows", "recv_rows",
                     "pair_counts", "inner_mask", "outer_mask", "nbr_rows",
                     "nbr_valid", "nbr_offset", "nbr_len", "nbr_slot"):
            np.testing.assert_array_equal(
                getattr(g, name), getattr(w, name),
                err_msg=f"hood {hid}: {name}",
            )
        for name in ("start", "nbr_pos", "nbr_cell", "offset", "slot"):
            np.testing.assert_array_equal(
                getattr(g.lists, name), getattr(w.lists, name),
                err_msg=f"hood {hid}: lists.{name}",
            )


def verify_grid(grid, check_two_to_one: bool = True) -> None:
    """Raise AssertionError on any internal inconsistency.

    With ``DCCRG_EPOCH_VERIFY=1`` additionally rebuilds the epoch from
    scratch and asserts the live one (possibly delta-patched after
    AMR/LB) matches it table for table — the incremental-rebuild oracle
    run at every verification point."""
    leaves = grid.leaves
    epoch = grid.epoch
    N = len(leaves)

    if os.environ.get("DCCRG_EPOCH_VERIFY", "0") != "0":
        from ..parallel.epoch import build_epoch
        from ..parallel.shapes import epoch_shape_hints

        # the oracle rebuild takes the live epoch's shapes as hints:
        # bucket choice is idempotent against its own result, so a
        # well-formed epoch is reproduced exactly (hysteresis included)
        # while any table corruption still trips the comparison
        compare_epochs(epoch, build_epoch(
            grid.mapping, grid.topology, leaves, grid.n_devices,
            grid.neighborhoods,
            uniform_geometry=grid._uniform_geometry(),
            shape_hints=epoch_shape_hints(epoch),
        ))

    # --- directory invariants (is_consistent)
    assert (np.diff(leaves.cells) > 0).all(), "leaf ids not sorted/unique"
    assert leaves.cells.dtype == np.uint64
    assert (leaves.owner >= 0).all() and (leaves.owner < grid.n_devices).all()
    lvl = grid.mapping.get_refinement_level(leaves.cells)
    assert (lvl >= 0).all(), "non-existing id in leaf set"

    # leaves must partition the domain: total index-volume matches (exact
    # Python ints over the distinct edge lengths: a volume may pass 2**63)
    ln, n_ln = np.unique(grid.mapping.get_cell_length_in_indices(leaves.cells),
                         return_counts=True)
    vol = sum(int(v) ** 3 * int(c) for v, c in zip(ln, n_ln))
    nx, ny, nz = grid.mapping.length_in_indices
    assert vol == nx * ny * nz, "leaves do not tile the domain"

    # --- row bookkeeping
    for d in range(grid.n_devices):
        lp = epoch.local_pos[d]
        assert (leaves.owner[lp] == d).all()
        np.testing.assert_array_equal(epoch.row_of[lp], np.arange(len(lp)))
        gp = epoch.ghost_pos[d]
        assert (leaves.owner[gp] != d).all(), "ghost of a local cell"

    for hid, hood in epoch.hoods.items():
        _verify_hood(grid, hood, lvl, check_two_to_one, hid)


def _distinct(keys):
    """The distinct values of ``keys``, ascending: a sort and a mask of
    first occurrences (newer numpy's ``np.unique`` hashes, which at millions
    of keys can be many times slower than the sort)."""
    keys = np.sort(keys)
    return keys[np.concatenate(([True], keys[1:] != keys[:-1]))]


def _verify_hood(grid, hood, lvl, check_two_to_one, hid):
    leaves = grid.leaves
    epoch = grid.epoch
    N = len(leaves)
    lists = hood.lists
    counts = np.diff(lists.start)
    src = np.repeat(np.arange(N), counts)

    # neighbor entries reference existing leaves
    assert (lists.nbr_pos >= 0).all() and (lists.nbr_pos < N).all()

    # 2:1 balance (the reference's max_ref_lvl_diff == 1 invariant)
    if check_two_to_one and len(src):
        diff = np.abs(lvl[src] - lvl[lists.nbr_pos])
        assert diff.max() <= 1, f"2:1 violation in hood {hid}"

    # neighbors_to is the exact inverse of neighbors_of: the same set of
    # (cell, neighbour) pairs, each pair a key cell * N + neighbour
    pairs_of = _distinct(src * N + lists.nbr_pos.astype(np.int64))
    src_to = np.repeat(np.arange(N), np.diff(hood.to_start))
    to_src = hood.to_src.astype(np.int64)
    pairs_to = _distinct(to_src * N + src_to)
    assert ((to_src >= 0) & (to_src < N)).all() and np.array_equal(
        pairs_to, pairs_of), f"neighbors_to not inverse in hood {hid}"

    # send/recv schedules pairwise consistent (remote-info symmetry)
    D = grid.n_devices
    scratch = epoch.R - 1
    for i in range(D):
        for j in range(D):
            s = hood.send_rows[i, j]
            r = hood.recv_rows[j, i]
            ns = int((s != scratch).sum())
            nr = int((r != scratch).sum())
            assert ns == nr == hood.pair_counts[i, j], (i, j, hid)
            if ns:
                sent_cells = epoch.cell_ids[i, s[:ns]]
                recv_cells = epoch.cell_ids[j, r[:ns]]
                np.testing.assert_array_equal(sent_cells, recv_cells)

    # inner/outer partition covers exactly the local cells
    both = hood.inner_mask & hood.outer_mask
    assert not both.any()
    np.testing.assert_array_equal(
        hood.inner_mask | hood.outer_mask, epoch.local_mask
    )


def verify_user_data(grid, state, spec, hood_id=None) -> None:
    """Ghost copies must be bit-identical to their owner rows after an
    exchange (the BASELINE halo guarantee), and field shapes/dtypes must
    match the spec."""
    epoch = grid.epoch
    for name, (shape, dt) in spec.items():
        arr = fetch(state[name])
        assert arr.shape[:2] == (grid.n_devices, epoch.R), name
        assert arr.shape[2:] == tuple(shape), name

    refreshed = grid.update_copies_of_remote_neighbors(state, hood_id)
    for name in spec:
        arr = fetch(refreshed[name])
        for d in range(grid.n_devices):
            gp = epoch.ghost_pos[d]
            if not len(gp):
                continue
            rows = epoch.rows_on_device(d, gp)
            own_dev = epoch.leaves.owner[gp]
            own_row = epoch.row_of[gp]
            np.testing.assert_array_equal(
                arr[d, rows], arr[own_dev, own_row],
                err_msg=f"ghost mismatch in field {name} on device {d}",
            )
