"""The least time one H100 could take for a count of work, and the work
each counted item needs.

Peaks: NVIDIA's H100 SXM data sheet at its full 700 W: 3.35 TB/s of HBM3
and 67 TFLOP/s of float32 outside the tensor cores (the engine's arithmetic
is float32 and uses no tensor cores; compares and selects count at that
rate). The run reports the card's power limit beside every share.

Operations an item needs (counted from the method, as the program's bring-up
bound arithmetic counts them): a candidate pair's box test and tier select,
one manifold of two polygons, one solved pair's projection and velocity
pass a substep, and one joint row's solve in one pass (a projection, or
its motor and damping rows)."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12
PAIR_FLOPS = 20
MANIFOLD_FLOPS = 1000
PROJECT_FLOPS = 200
VELOCITY_FLOPS = 220
JOINT_FLOPS = 100
WORD = 4  # bytes of a float32 or int32


def least_time_s(flops: float, nbytes: float) -> float:
    """The larger of the bytes' time at peak bandwidth and the operations'
    at peak rate."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S)
