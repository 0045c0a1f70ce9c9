"""``k4_table_row_share``, read from the program's K4 row counters."""

from types import SimpleNamespace

import pytest

from harness import cells


@pytest.fixture
def row_counters(monkeypatch):
    """``hopper.run_frame2``'s row counters, zero, restored after the
    test."""
    pytest.importorskip("torch")
    from starframe_tpu_torch import hopper

    monkeypatch.setattr(hopper.run_frame2, "table_rows", 0, raising=False)
    monkeypatch.setattr(hopper.run_frame2, "rows", 0, raising=False)
    return hopper.run_frame2


def test_table_row_share_without_a_k4_frame(row_counters):
    read = cells.metric_reader("k4_table_row_share")
    assert read(SimpleNamespace(trace=None)) is None


def test_table_row_share_from_known_counters(row_counters):
    # the walker: 5 of 204 rows a world keep records
    row_counters.table_rows = 4096 * 5 * 3
    row_counters.rows = 4096 * 204 * 3
    read = cells.metric_reader("k4_table_row_share")
    assert read(SimpleNamespace(trace=None)) == pytest.approx(500 / 204)


def test_table_row_share_of_a_program_without_counters(monkeypatch,
                                                       row_counters):
    monkeypatch.delattr(row_counters, "table_rows")
    monkeypatch.delattr(row_counters, "rows")
    read = cells.metric_reader("k4_table_row_share")
    assert read(SimpleNamespace(trace=None)) is None
