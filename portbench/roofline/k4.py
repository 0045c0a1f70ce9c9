"""K4, the whole batched frame (``frame2_kernel``), once a frame: a
manifold for every candidate pair, then each substep (x iterations) a
projection and a velocity pass for every solved pair, and for every solved
joint row a projection each iteration and a motor and damping pass each
substep. Bytes: each body's state and masses read and its state written,
each collider's shape read, each joint row's parameters read, once a
frame, and one partner index a candidate pair."""

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])frame2_kernel"
# a joint row's words: type, two bodies, four anchor coordinates, rest,
# lo, hi, compliance, damping, motor speed and budget, colour
JOINT_WORDS = 15


def work(ctx):
    c, s, sh = ctx.counts, ctx.cell.config["solver"], ctx.shapes
    frames = c["frames"]
    flops = (c["cand"] * P.MANIFOLD_FLOPS
             + s["substeps"] * s["iterations"] * c["solved"]
             * (P.PROJECT_FLOPS + P.VELOCITY_FLOPS)
             + s["substeps"] * (s["iterations"] + 1) * c.get("joints", 0)
             * P.JOINT_FLOPS)
    nbytes = P.WORD * (frames * (sh["bodies"] * (10 + 6)
                                 + sh["colliders"] * (2 * sh["verts"] + 6)
                                 + sh.get("joints", 0) * JOINT_WORDS)
                       + c["cand"])
    e = episodes(ctx)
    return e * flops, e * nbytes
