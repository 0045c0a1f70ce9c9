"""The share of the traced episodes' wall (first reset to last call's
synchronize) in which no device operation ran (the union of kernel, copy
and set intervals)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
