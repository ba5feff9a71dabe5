"""What the on-chip whole-run kernels B1 (``fused_run``), B4 (``gol_run``),
B5 (``flat_amr_run``) and B6 (``flat_ml_run``) share: the rule that cuts an
extent into parts, the cuts of a 3-D block into at most one brick an SM,
the shape of a CTA's threads, and the card's limits that their launch plans
take.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["RUN_THREADS", "part", "cuts", "run_threads", "card_limits"]

#: threads a CTA of the whole-run kernels at most (``__launch_bounds__``
#: of B1, B4, B5 and B6: 128 registers a thread)
RUN_THREADS = 512


def part(n: int, p: int, i: int):
    """``(start, length)`` of part ``i`` of ``n`` cells cut into ``p``
    parts, the first ``n % p`` one cell longer (the kernels' ``part``)."""
    q, r = divmod(n, p)
    return i * q + min(i, r), q + (i < r)


def cuts(cells, most: int):
    """Every ``(pz, py, px)`` cutting ``cells = (nz, ny, nx)`` cells into
    at most ``most`` bricks, no axis into more parts than it has cells."""
    nz, ny, nx = cells
    for pz in range(1, min(nz, most) + 1):
        for py in range(1, min(ny, most // pz) + 1):
            for px in range(1, min(nx, most // (pz * py)) + 1):
                yield pz, py, px


def run_threads(inner: int, rows: int, limit: int = RUN_THREADS):
    """``(bx, by)`` threads a CTA: ``bx`` along a row of ``inner`` cells,
    ``by`` rows, at most ``limit`` in all."""
    bx = min(inner, limit)
    return bx, max(1, min(limit // bx, rows))


@functools.lru_cache(maxsize=None)
def card_limits(index: int):
    """``(sms, smem_per_block)`` of CUDA device ``index``: its SM count and
    the shared memory one block may opt into."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin
