"""The step's share of the chip's peak: the least time of the counted work
of every kernel with a count under ``roofline/`` that ran in the traced
episodes (K2 and K4 in a batch, and K3 where its worlds have joints; K6
and K10 on the tile engine), over the traced episodes' wall."""

from harness.roofline import counted_kernels, step_share


def read(ctx):
    return step_share(ctx, counted_kernels())
