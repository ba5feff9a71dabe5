"""Kernels layer: the least time the card needs for the traced chunks' work
(``work/<model>.py``: the larger of operations over the peak rate and bytes
over the peak bandwidth, a call) over the time the device was busy with
operations in the traced window."""


def read(ctx):
    t, p = ctx.trace, ctx.peaks
    if t is None or p is None or t["busy_s"] <= 0:
        return None
    n = sum(1 for c in ctx.chunks if c["traced"])
    least, _ = ctx.work.least_seconds(ctx.calls, p[f"{ctx.dtype}_flops_per_s"],
                                      p["bytes_per_s"])
    return 100.0 * n * least / t["busy_s"]
