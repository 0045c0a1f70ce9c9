"""The union of device intervals, the idle share and the breakdown on a
synthetic trace."""

import json

import pytest

from harness import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("portbench.call", "user_annotation", 0.0, 100.0),
    ev("aten::nonzero", "cpu_op", 40.0, 20.0),
    ev("cudaStreamSynchronize", "cuda_runtime", 45.0, 10.0),
    ev("void (anonymous namespace)::frame2_kernel<8, false, false>"
       "(Frame2Args)", "kernel", 10.0, 20.0),
    ev("void at::native::vectorized_elementwise_kernel<4>()", "kernel", 25.0,
       10.0),  # overlaps the frame kernel by 5 us
    ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 70.0, 10.0),
    ev("void slot_kernel(SlotArgs)", "kernel", 80.0, 5.0),
    ev("void joint_slot_kernel(JointArgs)", "kernel", 90.0, 2.0),
    {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 1.0},
]


def test_union_merges_overlaps():
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


def test_busy_and_idle_share():
    dev = trace.device_events(EVENTS, 0.0, 100.0)
    # 10-35 (frame2 and the overlapping elementwise), 70-85, 90-92
    assert trace.busy_us(dev) == pytest.approx(25.0 + 15.0 + 2.0)
    clipped = trace.device_events(EVENTS, 20.0, 75.0)
    assert trace.busy_us(clipped) == pytest.approx(15.0 + 5.0)


def test_kernel_seconds_by_exact_name():
    dev = trace.device_events(EVENTS)
    pat = r"(?<![A-Za-z0-9_])slot_kernel"
    assert trace.kernel_seconds(dev, pat) == pytest.approx(5e-6)
    assert trace.kernel_seconds(
        dev, r"(?<![A-Za-z0-9_])frame2_kernel") == pytest.approx(20e-6)


HAND = ("joint_slot_kernel", "frame2_kernel", "slot_kernel")


def test_hand_kernels_are_read_from_the_program():
    names = trace.hand_kernels()
    assert {"frame2_kernel", "slot_kernel", "tile_frame_kernel",
            "elig_kernel"} <= set(names)


def test_breakdown_groups_small_ops():
    by = trace.device_by_label(trace.device_events(EVENTS), HAND)
    assert by["frame2_kernel"] == pytest.approx(20e-6)
    assert by["small PyTorch ops"] == pytest.approx(10e-6)
    assert by["memcpy"] == pytest.approx(10e-6)
    assert by["joint_slot_kernel"] == pytest.approx(2e-6)
    assert trace.top(by, 2)[0][0] == "frame2_kernel"


def test_idle_gaps_go_to_the_innermost_host_event():
    dev = trace.device_events(EVENTS, 0.0, 100.0)
    gaps = trace.idle_gaps(dev, trace.host_events(EVENTS), 0.0, 100.0)
    # gaps: 0-10 (call), 35-70 (mid 52.5: the sync inside nonzero),
    # 85-90 (call), 92-100 (call)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)
    assert gaps["portbench.call"] == pytest.approx(23e-6)
    assert sum(gaps.values()) == pytest.approx(58e-6)


def test_load_events(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert len(trace.load_events(p)) == len(EVENTS)
