"""Per-layer metrics read from the program's counters."""

from types import SimpleNamespace

import pytest

from harness import cells


@pytest.fixture
def frame2_counters(monkeypatch):
    """``hopper.run_frame2``'s item counters, restored after the test."""
    torch = pytest.importorskip("torch")
    from starframe_tpu_torch import hopper

    monkeypatch.setattr(hopper.run_frame2, "live_items", None)
    monkeypatch.setattr(hopper.run_frame2, "slot_items", 0)
    return torch, hopper.run_frame2


def test_k4_live_share_without_a_k4_frame(frame2_counters):
    read = cells.metric_reader("k4_live_slot_share")
    assert read(SimpleNamespace(trace=None)) is None


def test_k4_live_share_from_known_counters(frame2_counters):
    torch, run = frame2_counters
    run.live_items = torch.tensor([3 * 2048], dtype=torch.int64)
    run.slot_items = 8 * 2048
    read = cells.metric_reader("k4_live_slot_share")
    assert read(SimpleNamespace(trace=None)) == pytest.approx(37.5)


def test_k4_live_share_of_a_program_without_counters(monkeypatch,
                                                     frame2_counters):
    _, run = frame2_counters
    monkeypatch.delattr(run, "live_items")
    monkeypatch.delattr(run, "slot_items")
    read = cells.metric_reader("k4_live_slot_share")
    assert read(SimpleNamespace(trace=None)) is None
