"""The 95th percentile of every call's wall time in the window, from the
call to its ``torch.cuda.synchronize()``. A call whose hard counters
flagged still returned its state, which the reference checks, so it ranks
at its measured time."""

from harness.stats import percentile


def read(ctx):
    return percentile([1e3 * w for w in ctx.window.walls_s], 95.0)
