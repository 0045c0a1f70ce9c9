"""Active bodies x frames completed over the whole window's wall time
(resets and gaps included), on the host clock."""

from harness.stats import window_rate


def read(ctx):
    w = ctx.window
    return window_rate([ctx.active_bodies * f for f in w.frames], w.window_s)
