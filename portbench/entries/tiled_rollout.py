"""Entry ``tiled_rollout``: ``tiled.tiled_rollout`` over one big world
with its defaults (the whole-frame kernel, ``fuse=True``)."""

from __future__ import annotations

# the diag counters that mean a contact went unsolved or unseen
HARD = ("slot_overflow", "solve_overflow", "window_overflow",
        "large_overflow", "owner_overflow")


def implied(ref: dict, solver: dict) -> list:
    """The hard counters that have to read above 0 where the reference
    found, at the call's first frame (a table build), more touching
    partners of one collider than the table's slots, or more imminent ones
    (within the margin) than its solve slots."""
    table = -(-solver["slot_capacity"] // 8) * 8
    solve = min(-(-solver["tile_solve_capacity"] // 8) * 8, table)
    if solver["tile_solve_capacity"] <= 0:
        solve = table
    out = []
    if ref["max_touching"] > table:
        out.append("slot_overflow")
    if ref["max_imminent"] > solve:
        out.append("solve_overflow")
    return out


def call(world, cfg, n_frames: int):
    """``(final world, diag)`` after ``n_frames`` frames."""
    from starframe_tpu_torch import tiled

    return tiled.tiled_rollout(world, cfg, n_frames)
