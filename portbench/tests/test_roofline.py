"""Roofline counts against hand-worked small cases."""

from types import SimpleNamespace

import pytest

from harness import cells, peaks, roofline


def ctx(counts, solver, traffic=None, dev=(), episodes=1, window_s=1.0):
    cell = SimpleNamespace(config={"solver": solver},
                           traffic=traffic or {"frames_per_call": 4})
    tr = dict(dev=list(dev), episodes=episodes, window_s=window_s)
    return SimpleNamespace(cell=cell, counts=counts, trace=tr,
                           shapes=dict(bodies=3, colliders=3, verts=4))


SOLVER = dict(substeps=10, iterations=1, frames_per_broadphase=4,
              slot_capacity=8)
COUNTS = dict(frames=2, cand=10, cand_live=6, active=5, solved=4, awake=2,
              calls=1)


def test_k4_counts():
    flops, nbytes = cells.roofline_count("k4").work(ctx(COUNTS, SOLVER))
    # 10 manifolds + 10 substeps x 4 solved pairs x (200 + 220)
    assert flops == 10 * 1000 + 10 * 4 * 420
    # 2 frames x (3 bodies x 16 words + 3 colliders x (2 x 4 + 6) words)
    # + one partner word a candidate
    assert nbytes == 4 * (2 * (3 * 16 + 3 * 14) + 10)


def test_k4_counts_a_joint_free_world_as_before():
    """Joint-free counts and shapes (the reference's, which name no joints,
    or name none with zeros) give the count of contacts alone."""
    parent = (10 * 1000 + 10 * 4 * 420, 4 * (2 * (3 * 16 + 3 * 14) + 10))
    k4 = cells.roofline_count("k4")
    assert k4.work(ctx(COUNTS, SOLVER)) == parent
    zero = ctx(dict(COUNTS, joints=0, max_joint_rows=0), SOLVER)
    zero.shapes["joints"] = 0
    assert k4.work(zero) == parent


def test_k4_counts_joint_rows():
    """Each solved joint row: a projection an iteration and a motor and
    damping pass, each substep; its 15 parameter words read once a frame."""
    c = ctx(dict(COUNTS, joints=6, max_joint_rows=3), SOLVER)
    c.shapes["joints"] = 5
    flops, nbytes = cells.roofline_count("k4").work(c)
    assert flops == 10 * 1000 + 10 * 4 * 420 + 10 * (1 + 1) * 6 * 100
    assert nbytes == 4 * (2 * (3 * 16 + 3 * 14 + 5 * 15) + 10)


def test_k2_counts_one_build_a_call_at_k4():
    flops, nbytes = cells.roofline_count("k2").work(ctx(COUNTS, SOLVER))
    # one build (4 frames a call, K = 4) sees half of the 2 frames' pairs
    assert flops == pytest.approx(5 * 20)
    assert nbytes == 4 * 3 * (14 + 2 * 8 + 4)
    per_frame = ctx(COUNTS, SOLVER, traffic={"frames_per_call": 1})
    assert cells.roofline_count("k2").work(per_frame)[0] == pytest.approx(
        5 * 20)


def test_k10_and_k6_counts():
    flops, nbytes = cells.roofline_count("k10").work(ctx(COUNTS, SOLVER))
    assert flops == 10 * 4 * 420
    assert nbytes == 4 * (2 * 16 + 18 * 4)
    flops, nbytes = cells.roofline_count("k6").work(ctx(COUNTS, SOLVER))
    assert flops == 6 * 1000
    assert nbytes == 4 * (2 * (6 + 8 + 8) + 22 * 5)


def test_counts_scale_with_the_traced_episodes():
    one = cells.roofline_count("k4").work(ctx(COUNTS, SOLVER))
    two = cells.roofline_count("k4").work(ctx(COUNTS, SOLVER, episodes=2))
    assert two == (2 * one[0], 2 * one[1])


def test_share_is_least_time_over_device_time():
    kern = ("void frame2_kernel<8, false, false>(Frame2Args)", "kernel",
            0.0, 1.0)  # 1 us
    c = ctx(COUNTS, SOLVER, dev=[kern])
    least = max(4 * (2 * 90 + 10) / peaks.PEAK_BYTES_S,
                (10 * 1000 + 10 * 4 * 420) / peaks.PEAK_FLOPS_S)
    assert roofline.share(c, "k4") == pytest.approx(100 * least / 1e-6)
    # a kernel that is not in the trace reads nothing (never 0)
    assert roofline.share(c, "k2") is None
    assert roofline.step_share(c, ("k2", "k4")) == pytest.approx(
        100 * least / 1.0)
    assert roofline.step_share(c, roofline.counted_kernels()) == (
        pytest.approx(100 * least / 1.0))
    assert roofline.step_share(c, ("k10",)) is None


def test_least_time_takes_the_larger_bound():
    assert peaks.least_time_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_time_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_time_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
