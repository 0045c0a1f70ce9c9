"""Cells resolve from their files by name, and ``BENCHMARK.json`` keeps the
benchmark contract's names, units and shapes."""

import json
import re

import pytest

from harness import cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
# the parked cells, as they would stand once moved into BENCHMARK.json
ALL = cells.benchmark(parked=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_resolves_from_its_files(cell):
    c = cells.resolve(cell, ALL)
    config, traffic = cell.split(".", 1)
    assert c.config["name"] == config
    assert c.workload["traffic"] == traffic
    assert c.traffic["episode_frames"] % c.traffic["frames_per_call"] == 0
    assert callable(c.scene.program) and callable(c.scene.describe)
    assert callable(c.entry.call) and c.entry.HARD
    assert c.limits["numbers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer + c.end_to_end:
        assert callable(cells.metric_reader(m["name"]))
    # every layer metric's end-to-end metric is reported in the cell
    assert {m["moves"] for m in c.per_layer} <= names
    cells.solver_config(c.config)  # the file's fields are the program's


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("batched_rl.no_such_traffic", BENCH)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark",
                                                     "with_parked"])
def test_names_units_and_keys(bench):
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert (cells.ROOT / c["file"]).is_file()
        seen.add(("config", c["name"]))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert ("cell", w["name"]) not in seen
        seen.add(("cell", w["name"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    cellnames = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cellnames
        assert ("metric", m["name"]) not in seen
        seen.add(("metric", m["name"]))


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark",
                                                     "with_parked"])
def test_every_cell_reports_setup_and_a_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = cells.reported(bench["end_to_end"], w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert cells.reported(bench["per_layer"], w["name"])


def test_every_config_and_metric_has_a_cell():
    names = {w["name"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) & names


def test_variants_share_one_reader():
    a = cells.metric_reader("device_idle_share.batched")
    b = cells.metric_reader("device_idle_share.pile")
    assert a.__code__.co_filename == b.__code__.co_filename
    assert a.__code__.co_filename.endswith("device_idle_share.py")


def test_check_fits_the_time_limit():
    n = 24  # later PRs may grow the cells to 24 under this run length
    runs = 2 + 14 * n
    assert runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
