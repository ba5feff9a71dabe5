"""Model layer: host milliseconds a chunk in the flat run's row-to-voxel
gathers and weights (``advection.flat.inputs``) and its write-back
(``advection.flat.write_back``), over the chunks before the profiler
started, as ``dispatch_ms_per_chunk`` takes them."""
from portbench import spans

NAMES = ("advection.flat.inputs", "advection.flat.write_back")


def read(ctx):
    by_chunk = spans.chunk_spans(ctx)
    if by_chunk is None:
        return None
    ms = []
    for got, chunk in zip(by_chunk, ctx.chunks):
        if chunk["traced"]:
            continue
        mine = [s["dur"] for s in got if s["name"] in NAMES]
        if len(mine) != len(NAMES):
            return None
        ms.append(1e3 * sum(mine))
    return sum(ms) / len(ms) if ms else None
