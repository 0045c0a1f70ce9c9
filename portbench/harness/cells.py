"""Resolve a cell ``<config>.<traffic>`` to its files, by name.

- ``BENCHMARK.json`` (the checkout's root): the cell, its configuration's
  ``file`` and the metrics it reports (``parked.json``: cells kept out of
  it, which the harness's tests still run);
- the configuration file (JSON): the scene module (``scenes/<scene>.py``),
  its arguments, the entry (``entries/<entry>.py``), the solver
  configuration as run, and ``reference``: the plain reference package
  that decides ``correct`` and counts the work (a dotted name of a folder
  under ``portbench/``; ``"reference"``, ``reference/``, where the file
  names none);
- ``traffic/<traffic>.json``: the call pattern, and the ``control``
  (``control/<control>.py``) that sets each call's actions, if it names
  one;
- ``limits/<cell>.json``: the limits of the numbers ``correct`` compares;
- ``metrics/<metric>.py``: one reader per metric (``<stem>.py`` for all
  ``<stem>.<part>`` variants without a file of their own);
- ``roofline/<kernel>.py``: one work count per kernel.

Nothing here branches on a cell's name: a new cell is new files and new
entries in ``BENCHMARK.json``. A configuration whose physics
``reference/`` lacks brings its own reference package as new files and
names it; the harness reaches a reference only through ``Cell.reference``.
A reference package gives:

- ``world.build(desc, device)`` -> ``(geom, state)``, ``world.cast(state,
  dtype)``, ``world.cast_geom(geom, dtype)``, ``world.shapes(desc)``;
- ``frame.frame(geom, st, cfg, stats=None)`` and ``frame.rollout(geom, st,
  cfg, n_frames, stats=None)``, ``stats`` summing ``frames``, ``awake``,
  ``cand``, ``cand_live``, ``active``, ``solved``, ``joints`` and keeping
  the largest ``max_touching``, ``max_imminent``, ``max_joint_rows``;
- ``config(solver, entry_name)``: the frame settings from the solver
  block (it refuses what the reference cannot run);
- ``world_state(world)`` and ``actions(world)``: a call's input state and
  the per-call inputs a control wrote, captured from the program's world.

``reference/__init__.py`` says what each returns.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the portbench folder
ROOT = BENCH.parent
DEFAULT_REFERENCE = "reference"
# what the harness calls of a reference package
REFERENCE_INTERFACE = ("world.build", "world.cast", "world.cast_geom",
                       "world.shapes", "frame.frame", "frame.rollout",
                       "config", "world_state", "actions")
_PACKAGE_NAME = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)*$", re.ASCII)


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


def load_package(name: str):
    """Import the package ``name`` (dotted, relative to the portbench
    folder: ``tests.references.x`` is ``tests/references/x/``) under a name
    of its own, once a process; its modules import each other relatively."""
    if not _PACKAGE_NAME.match(name):
        raise ModuleNotFoundError(f"no package name {name!r}")
    key = "portbench_" + name.replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH.joinpath(*name.split("."))
    init = path / "__init__.py"
    if not init.is_file():
        raise ModuleNotFoundError(f"no package {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        key, init, submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def reference_package(name: str = DEFAULT_REFERENCE):
    """The reference package ``name``, refused where it lacks a part of
    the interface (the module's docstring)."""
    ref = load_package(name)
    missing = []
    for part in REFERENCE_INTERFACE:
        obj = ref
        for attr in part.split("."):
            obj = getattr(obj, attr, None)
        if not callable(obj):
            missing.append(part)
    if missing:
        raise TypeError(f"reference package {name!r} lacks {missing}")
    return ref


def reference_of(config: dict):
    """The reference package the configuration file names (its
    ``reference``, by default ``reference/``)."""
    return reference_package(config.get("reference", DEFAULT_REFERENCE))


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
    reference: object  # the configuration's reference package
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
        reference=reference_of(config), control=control_of(traffic))


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
