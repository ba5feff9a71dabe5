"""The work of the advection cells, counted from the physics, per user call.

Whatever kernel does the work, a call of ``run(state, k, dt)`` or of
``step(state, dt)`` needs:

* operations: one flux a face, each face of the benchmark's own face list
  once, a step; ``OPS_PER_FACE`` is the dense scheme's 11 float operations a
  cell-step (the least any of the port's kernels has shown to be enough, its
  whole-run kernel's count) over the 3 faces a cell owns on a periodic
  uniform grid;
* bytes: each input field read once (density, vx, vy, vz) and the output
  density written once, in the configuration's dtype, whatever the call's
  step count.

The least time a call can take on a device is the larger of its operations
over the device's peak rate and its bytes over its peak bandwidth.
"""
from __future__ import annotations

OPS_PER_FACE = 11.0 / 3.0
FIELDS_READ = 4
FIELDS_WRITTEN = 1


def call(leaves: int, faces: int, steps: int, dtype_bytes: int) -> tuple:
    """``(operations, bytes)`` of one call that advances ``steps`` steps."""
    ops = OPS_PER_FACE * faces * steps
    moved = (FIELDS_READ + FIELDS_WRITTEN) * dtype_bytes * leaves
    return ops, moved


def chunk_calls(traffic: dict, summary: dict, dtype_bytes: int) -> list:
    """The calls of one chunk of ``traffic``: one ``run`` of ``k`` steps, or
    ``k`` calls of ``step``."""
    k, entry = int(traffic["k"]), traffic["entry"]
    leaves, faces = summary["leaves"], summary["faces"]
    if entry == "run":
        return [call(leaves, faces, k, dtype_bytes)]
    if entry == "step":
        return [call(leaves, faces, 1, dtype_bytes)] * k
    raise ValueError(f"unknown entry {entry!r}")


def least_seconds(calls, flops_per_s: float, bytes_per_s: float) -> tuple:
    """The least device seconds for ``calls``, and which bound binds more
    of them (``"operations"`` or ``"bytes"``)."""
    total, by_ops = 0.0, 0
    for ops, moved in calls:
        t_ops, t_bytes = ops / flops_per_s, moved / bytes_per_s
        total += max(t_ops, t_bytes)
        by_ops += t_ops >= t_bytes
    return total, ("operations" if 2 * by_ops >= len(calls) else "bytes")
