"""K6, the tile engine's manifolds (``tile_manifold_kernel``), once a
frame: a manifold for every candidate pair with an awake body. Bytes: each
awake row's state and shape read, each active pair's solve slot (22
words) written."""

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])tile_manifold_kernel"


def work(ctx):
    c, sh = ctx.counts, ctx.shapes
    flops = c["cand_live"] * P.MANIFOLD_FLOPS
    nbytes = P.WORD * (c["awake"] * (6 + 2 * sh["verts"] + 8)
                       + 22 * c["active"])
    e = episodes(ctx)
    return e * flops, e * nbytes
