"""Resolve a cell ``<config>.<traffic>`` to its files, by name.

- ``BENCHMARK.json`` (the checkout's root): the cell, its configuration's
  ``file`` and the metrics it reports (``parked.json``: cells kept out of
  it, which the harness's tests still run);
- the configuration file (JSON): the scene module (``scenes/<scene>.py``),
  its arguments, the entry (``entries/<entry>.py``) and the solver
  configuration as run;
- ``traffic/<traffic>.json``: the call pattern, and the ``control``
  (``control/<control>.py``) that sets each call's actions, if it names
  one;
- ``limits/<cell>.json``: the limits of the numbers ``correct`` compares;
- ``metrics/<metric>.py``: one reader per metric (``<stem>.py`` for all
  ``<stem>.<part>`` variants without a file of their own);
- ``roofline/<kernel>.py``: one work count per kernel.

Nothing here branches on a cell's name: a new cell is new files and new
entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the portbench folder
ROOT = BENCH.parent


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    name = "portbench_" + "_".join(path.relative_to(BENCH).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict  # the BENCHMARK.json entry
    config: dict  # the configuration file
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    scene: object  # scenes/<scene>.py
    entry: object  # entries/<entry>.py
    control: object = None  # control/<control>.py, where the traffic names one

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def reported(metrics: list, cell: str) -> list:
    """The metrics of ``metrics`` that ``cell`` reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def benchmark(parked: bool = False) -> dict:
    """The checkout's ``BENCHMARK.json``; with ``parked``, with the entries
    of ``parked.json`` (cells kept out of the benchmark) added."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if parked:
        more = load_json(BENCH / "parked.json")
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + more[key]
    return bench


def resolve(cell: str, bench: dict | None = None) -> Cell:
    """The cell named ``cell`` (``<config>.<traffic>``) of ``bench`` (by
    default the checkout's ``BENCHMARK.json``)."""
    if bench is None:
        bench = benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{work['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell}.json")
    return Cell(
        name=cell, workload=work, config=config, traffic=traffic,
        limits=limits, end_to_end=reported(bench["end_to_end"], cell),
        per_layer=reported(bench["per_layer"], cell),
        scene=load_module(BENCH / "scenes" / f"{config['scene']}.py"),
        entry=load_module(BENCH / "entries" / f"{config['entry']}.py"),
        control=control_of(traffic))


def control_of(traffic: dict):
    """``control/<name>.py`` of the traffic's ``control``, or None. Its
    ``apply(world, seed, pos)`` returns the world with the actions of the
    call at episode position ``pos`` written into its joints, drawn on the
    device from ``seed``, ``pos`` and the world's index alone."""
    name = traffic.get("control")
    return None if name is None else load_module(
        BENCH / "control" / f"{name}.py")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``. A metric named ``<stem>.<part>``
    without a file of its own reads with ``metrics/<stem>.py``, which its
    variants share (``body_steps_per_s.batched`` and ``.pile``)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_module(path).read


def roofline_count(kernel: str):
    """``roofline/<kernel>.py``."""
    return load_module(BENCH / "roofline" / f"{kernel}.py")


def solver_config(config: dict):
    """The program's ``SolverConfig`` as the configuration file states it
    (a field the file does not name keeps the program's default; a field
    the program does not know is refused)."""
    from starframe_tpu_torch.config import SolverConfig

    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    given = config["solver"]
    unknown = set(given) - fields
    if unknown:
        raise KeyError(f"the program's SolverConfig has no {sorted(unknown)}")
    return SolverConfig(**given)
