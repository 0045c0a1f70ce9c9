"""K2, the slot-table broadphase (``slot_kernel``), once a call for every
``frames_per_broadphase`` frames of it: a box test for every candidate
pair. Bytes: each collider's pose, speed bound and shape read once, its
partner slots, their flags, three counts and a budget written."""

import math

from harness import peaks as P
from harness.roofline import episodes

PATTERN = r"(?<![A-Za-z0-9_])slot_kernel"


def work(ctx):
    c, s, sh = ctx.counts, ctx.cell.config["solver"], ctx.shapes
    F = ctx.cell.traffic["frames_per_call"]
    builds = c["calls"] * math.ceil(F / max(s["frames_per_broadphase"], 1))
    cand = c["cand"] * builds / max(c["frames"], 1)
    C = s["slot_capacity"]
    flops = cand * P.PAIR_FLOPS
    nbytes = P.WORD * builds * sh["colliders"] * (
        (2 * sh["verts"] + 6) + (2 * C + 4))
    e = episodes(ctx)
    return e * flops, e * nbytes
