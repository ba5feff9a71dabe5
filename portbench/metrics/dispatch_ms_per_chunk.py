"""Model layer: host milliseconds inside the program's stepping calls
(``run`` / ``step``) until they return, a chunk, over the chunks before
the profiler started (its hooks slow every later launch)."""


def read(ctx):
    spans = [c["spans"]["dispatch"] for c in ctx.chunks if not c["traced"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
