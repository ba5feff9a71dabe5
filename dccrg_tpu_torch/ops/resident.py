"""What the on-chip whole-run kernels B1 (``fused_run``) and B4
(``gol_run``) share: the rule that cuts an extent into parts, the shape of
a CTA's threads, and the card's limits that their launch plans take.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["RUN_THREADS", "part", "run_threads", "card_limits"]

#: threads a CTA of the whole-run kernels at most (``__launch_bounds__``
#: of B1 and B4: 128 registers a thread)
RUN_THREADS = 512


def part(n: int, p: int, i: int):
    """``(start, length)`` of part ``i`` of ``n`` cells cut into ``p``
    parts, the first ``n % p`` one cell longer (the kernels' ``part``)."""
    q, r = divmod(n, p)
    return i * q + min(i, r), q + (i < r)


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
