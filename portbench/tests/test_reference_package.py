"""A configuration names its plain reference package (``reference``;
``reference/`` where it names none), and the harness reaches the reference
only through the cell's package, on the CPU at 4 worlds: a copy that
re-exports ``reference/`` gives the default's compared numbers and work
counts bit for bit, every part of its interface called; a copy whose
capture drops the control's actions is not correct; a name that does not
resolve to a package with the interface is refused at ``resolve``; and
the harness's modules import no reference by name."""

import ast
import dataclasses
import json
import math

import pytest
import torch

from harness import cells, window
import jointed_cell
import run
from test_correct import SEED, run_small, small

PASSTHROUGH = "tests.references.passthrough"
DROPPED = "tests.references.actions_dropped"


def jointed(reference=None):
    cell = jointed_cell.cell(4, reference)
    cell.traffic.update(start_frame=20, episode_frames=12, check_calls=4)
    return cell


def batched(reference=None):
    cell = small("batched_rl.step4")
    if reference is not None:
        cell.config["reference"] = reference
        cell = dataclasses.replace(cell, reference=cells.reference_of(
            cell.config))
    return cell


CELLS = {"legged_hull.motors": jointed, "batched_rl.step4": batched}


def spy_on(ref, monkeypatch) -> dict:
    """Count the calls of each part of ``ref``'s interface."""
    calls = dict.fromkeys(cells.REFERENCE_INTERFACE, 0)
    for part in cells.REFERENCE_INTERFACE:
        *path, name = part.split(".")
        owner = ref
        for attr in path:
            owner = getattr(owner, attr)
        real = getattr(owner, name)

        def counted(*args, _part=part, _real=real, **kwargs):
            calls[_part] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)
    return calls


def one_episode(monkeypatch):
    """The window (and the warm-up) as one whole episode, whatever its
    time: every drawn position is checked, in every run alike."""
    real = window.run

    def run_one(cell, start, cfg, call, seconds, positions, device, seed,
                profile_episodes=0, episodes=None):
        return real(cell, start, cfg, call, math.inf, positions, device,
                    seed, profile_episodes, episodes=1)

    monkeypatch.setattr(window, "run", run_one)


def work_counts(cell) -> dict:
    """``run.count_episode``'s counts over one episode from the settled
    start."""
    torch.set_num_threads(4)
    cfg = cells.solver_config(cell.config)
    seed = SEED % (1 << 63)
    start, _ = window.set_up(cell, seed, "cpu", cfg, cell.entry.call)
    rcfg = cell.reference.config(cell.config["solver"], cell.config["entry"])
    rcfg["gravity"] = tuple(cell.config["gravity"])
    geom, _ = cell.reference.world.build(cell.scene.describe(
        cell.config["scene_args"], seed), "cpu")
    return run.count_episode(cell, start, cfg, cell.entry.call, geom, rcfg,
                             "cpu", seed)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_copy_reads_the_defaults_numbers(name, monkeypatch):
    make = CELLS[name]
    default, copy = make(), make(PASSTHROUGH)
    assert default.reference is cells.reference_package()
    assert copy.reference is cells.reference_package(PASSTHROUGH)
    assert copy.reference is not default.reference
    calls = spy_on(copy.reference, monkeypatch)
    one_episode(monkeypatch)
    ref_res = run_small(default, monkeypatch=monkeypatch)
    assert not any(calls.values())
    res = run_small(copy, monkeypatch=monkeypatch)
    assert res["correct"], res["checks"]
    assert json.dumps(res["checks"]) == json.dumps(ref_res["checks"])
    assert work_counts(copy) == work_counts(default)
    assert all(calls.values()), calls  # every part read from the copy


def test_dropped_actions_are_not_correct(monkeypatch):
    one_episode(monkeypatch)
    res = run_small(jointed(DROPPED), monkeypatch=monkeypatch)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name,error", [
    ("tests.references.no_such_package", ModuleNotFoundError),
    ("tests.references", ModuleNotFoundError),  # a folder, no package
    ("../reference", ModuleNotFoundError),
    ("harness", TypeError),  # a package without the interface
])
def test_unknown_reference_is_refused(name, error, tmp_path):
    bench = cells.benchmark()
    conf = next(c for c in bench["configs"] if c["name"] == "batched_rl")
    config = cells.load_json(cells.ROOT / conf["file"])
    config["reference"] = name
    path = tmp_path / "batched_rl.json"
    path.write_text(json.dumps(config))
    bench["configs"] = [dict(conf, file=str(path))]
    with pytest.raises(error):
        cells.resolve("batched_rl.step4", bench)


def _imported(path) -> set:
    """The top-level names of the modules ``path`` imports, absolute and
    relative alike (``from . import x`` gives ``x``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.module:
                names.add(node.module.split(".")[0])
            else:
                names |= {a.name for a in node.names}
    return names


def test_harness_imports_no_reference_by_name():
    files = (sorted((cells.BENCH / "harness").glob("*.py"))
             + [cells.BENCH / "run.py", cells.BENCH / "readings.py"])
    assert len(files) > 2
    for path in files:
        assert "reference" not in _imported(path), path
