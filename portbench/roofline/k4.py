"""K4, the whole batched frame (``frame2_kernel``), once a frame: a
manifold for every candidate pair, then each substep (x iterations) a
projection and a velocity pass for every solved pair. Bytes: each body's
state and masses read and its state written, each collider's shape read,
one partner index a candidate pair."""

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])frame2_kernel"


def work(ctx):
    c, s, sh = ctx.counts, ctx.cell.config["solver"], ctx.shapes
    frames = c["frames"]
    flops = (c["cand"] * P.MANIFOLD_FLOPS
             + s["substeps"] * s["iterations"] * c["solved"]
             * (P.PROJECT_FLOPS + P.VELOCITY_FLOPS))
    nbytes = P.WORD * (frames * (sh["bodies"] * (10 + 6)
                                 + sh["colliders"] * (2 * sh["verts"] + 6))
                       + c["cand"])
    e = episodes(ctx)
    return e * flops, e * nbytes
