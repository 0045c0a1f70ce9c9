"""K10, the tile engine's frame of substeps (``tile_frame_kernel``), once
a frame: each substep a projection and a velocity pass for every solved
pair of an awake body. Bytes: each awake row's state read and written and
its four constants read, each solved pair's 18 words read once a frame."""

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])tile_frame_kernel"


def work(ctx):
    c, s = ctx.counts, ctx.cell.config["solver"]
    flops = (s["substeps"] * s["iterations"] * c["solved"]
             * (P.PROJECT_FLOPS + P.VELOCITY_FLOPS))
    nbytes = P.WORD * (c["awake"] * (6 + 6 + 4) + 18 * c["solved"])
    e = episodes(ctx)
    return e * flops, e * nbytes
