"""The program's spans on a synthetic trace: self intervals of nested
spans, their idle time by exact intersection with gaps that straddle span
edges, and the partition of the window's idle time."""

from types import SimpleNamespace

import pytest

from harness import spans, trace
from test_trace import ev

# one call (10-90) in a window 0-100: set-up 12-20, a guard 30-50 with a
# tables span 40-45 inside it, a frame 60-80; host ops the reduction ignores
EVENTS = [
    ev("portbench.call", "user_annotation", 5.0, 90.0),
    ev("starframe.rollout", "user_annotation", 10.0, 80.0),
    ev("starframe.setup", "user_annotation", 12.0, 8.0),
    ev("starframe.guard", "user_annotation", 30.0, 20.0),
    ev("starframe.tables", "user_annotation", 40.0, 5.0),
    ev("starframe.frame", "user_annotation", 60.0, 20.0),
    ev("aten::empty", "cpu_op", 61.0, 2.0),
    # device: 15-35 (straddles set-up's end and the guard's start), 42-43,
    # 70-95 (straddles the frame's and the rollout's end)
    ev("void slot_kernel(SlotArgs)", "kernel", 15.0, 20.0),
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 42.0, 1.0),
    ev("void frame2_kernel<4, false, false>(Frame2Args)", "kernel", 70.0,
       25.0),
]
T0, T1 = 0.0, 100.0


def reduced():
    dev = trace.device_events(EVENTS, T0, T1)
    return dict(dev=dev, host=trace.host_events(EVENTS), t0_us=T0, t1_us=T1,
                window_s=(T1 - T0) * 1e-6, busy_s=trace.busy_us(dev) * 1e-6,
                frames=4)


def test_self_intervals_of_nested_spans():
    ss = spans.program_spans(trace.host_events(EVENTS), T0, T1)
    pieces = spans.self_intervals(ss, T0, T1)
    assert pieces == [
        (0.0, 10.0, None), (10.0, 12.0, "starframe.rollout"),
        (12.0, 20.0, "starframe.setup"), (20.0, 30.0, "starframe.rollout"),
        (30.0, 40.0, "starframe.guard"), (40.0, 45.0, "starframe.tables"),
        (45.0, 50.0, "starframe.guard"), (50.0, 60.0, "starframe.rollout"),
        (60.0, 80.0, "starframe.frame"), (80.0, 90.0, "starframe.rollout"),
        (90.0, 100.0, None)]


def test_idle_by_exact_intersection():
    r = spans.reduce(reduced())
    idle = {k: v * 1e6 for k, v in r["idle_s"].items()}
    # gaps: 0-15, 35-42, 43-70, 95-100
    assert idle[None] == pytest.approx(10.0 + 5.0)  # 0-10, 95-100
    assert idle["starframe.setup"] == pytest.approx(3.0)  # 12-15
    # 10-12, 50-60 (80-90 is busy)
    assert idle["starframe.rollout"] == pytest.approx(2.0 + 10.0)
    assert idle["starframe.guard"] == pytest.approx(5.0 + 5.0)  # 35-40, 45-50
    assert idle["starframe.tables"] == pytest.approx(2.0 + 2.0)  # 40-42, 43-45
    assert idle["starframe.frame"] == pytest.approx(10.0)  # 60-70
    assert r["self_s"]["starframe.guard"] == pytest.approx(15e-6)
    assert r["counts"] == {"starframe.rollout": 1, "starframe.setup": 1,
                           "starframe.guard": 1, "starframe.tables": 1,
                           "starframe.frame": 1}


def test_span_idle_sums_to_the_window_idle():
    t = reduced()
    r = spans.reduce(t)
    assert sum(r["idle_s"].values()) == pytest.approx(
        t["window_s"] - t["busy_s"], abs=1e-12)
    assert sum(r["self_s"].values()) == pytest.approx(t["window_s"])


def test_metrics_read_shares_and_counts():
    ctx = SimpleNamespace(trace=reduced())
    assert spans.idle_share(ctx, "starframe.guard") == pytest.approx(10.0)
    assert spans.per_frame(ctx, "starframe.tables") == pytest.approx(0.25)
    # a span the window does not hold reads 0 beside a rollout
    assert spans.per_frame(ctx, "starframe.sort") == 0.0


def test_a_program_without_spans_reads_nothing():
    t = reduced()
    t["host"] = [h for h in t["host"] if not h[0].startswith("starframe.")]
    ctx = SimpleNamespace(trace=t)
    assert spans.reduce(t) is None
    assert spans.idle_share(ctx, "starframe.guard") is None
    assert spans.per_frame(ctx, "starframe.tables") is None
    assert spans.idle_share(SimpleNamespace(trace=None), "x") is None
