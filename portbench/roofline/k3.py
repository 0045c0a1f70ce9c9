"""K3, the joint-slot build (``joint_slot_kernel``), once a call: each
body's first ``joint_slot_capacity`` joints in joint order. Bytes: each
joint's two endpoint bodies and its active flag read once; the slots'
joint rows, sides and flags ``[W, JC, N]`` and the bodies' joint counts
``[W, N]`` written. Its arithmetic (a rank and a compare a joint and
body) is not counted: the bytes bound it."""

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])joint_slot_kernel"


def work(ctx):
    c, s, sh = ctx.counts, ctx.cell.config["solver"], ctx.shapes
    JC = s["joint_slot_capacity"]
    nbytes = P.WORD * c["calls"] * (3 * sh["joints"]
                                    + (3 * JC + 1) * sh["bodies"])
    return 0.0, episodes(ctx) * nbytes
