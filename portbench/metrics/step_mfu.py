"""Device layer: the traced chunks' operations (``work/<model>.py``) over
what the card's peak rate in the configuration's dtype does in the traced
window: the whole step's share of the chip's peak."""


def read(ctx):
    t, p = ctx.trace, ctx.peaks
    if t is None or p is None or t["window_s"] <= 0:
        return None
    n = sum(1 for c in ctx.chunks if c["traced"])
    ops = n * sum(c[0] for c in ctx.calls)
    return 100.0 * ops / (p[f"{ctx.dtype}_flops_per_s"] * t["window_s"])
