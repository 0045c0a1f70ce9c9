"""The window's rate and its tail over every call."""

import pytest

from harness import stats


def test_window_rate_counts_all_work_over_the_whole_window():
    # 3 calls of 4 frames x 10 bodies in a 2 s window (resets included)
    assert stats.window_rate([40, 40, 40], 2.0) == 60.0


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0


def test_p95_takes_every_call():
    walls = [0.010] * 95 + [0.020] * 5
    ms = [1e3 * w for w in walls]
    assert stats.percentile(ms, 95) == pytest.approx(10.0 + 0.05 * 10.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q1, med, q3 = 1.5, 3.0, 4.5  # statistics.quantiles of 1..5
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((q3 - q1) / med)
