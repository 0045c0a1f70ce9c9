"""Entry ``batched_rollout``: ``parallel.batched_rollout`` over a world
batch with its defaults, poses not recorded (an RL environment step reads
the final state)."""

from __future__ import annotations

# the diag counters that mean a contact or joint went unsolved
HARD = ("slot_overflow", "joint_overflow", "solve_overflow",
        "owner_overflow")


def implied(ref: dict, solver: dict) -> list:
    """The hard counters that have to read above 0 where the reference
    found, at the call's first frame (a table build), more touching
    partners of one collider than its ``slot_capacity`` slots, or more
    joint rows on one body than its ``joint_slot_capacity`` slots."""
    return ((["slot_overflow"] if ref["max_touching"]
             > solver["slot_capacity"] else [])
            + (["joint_overflow"] if ref.get("max_joint_rows", 0)
               > solver["joint_slot_capacity"] else []))


def call(world, cfg, n_frames: int):
    """``(final world, diag)`` after ``n_frames`` frames."""
    from starframe_tpu_torch import parallel

    final, _, diag = parallel.batched_rollout(world, cfg, 0, n_frames,
                                              record=lambda _w: None)
    return final, diag
