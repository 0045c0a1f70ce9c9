#!/usr/bin/env python3
"""The harness's jointed test cell, ``legged_hull.motors``: a hull on a
motorised two-segment leg over each world's own terrain
(``jointed/scene.py``), in one-frame calls whose motor actions the control
``random_motors`` redraws every call. It is built from the files under
``jointed/`` (configuration, traffic, limits) the way
``harness.cells.resolve`` builds a cell of ``BENCHMARK.json``, and reports
the metrics ``batched_rl.step4`` reports. It is no cell of the benchmark:
the CPU tests run it at 4 worlds, and on a card

    python3 portbench/tests/jointed_cell.py --worlds 1024 --seeds 1 2 3
        [--control-seeds 3] [--readings-seeds 12] [--seconds 3]

runs it at ``--worlds`` through ``run.run_cell`` once a seed (one JSON line
each: ``correct``, the compared numbers and the metrics), then the
readings its limits are set from (``readings.py``): the program's on the
first ``--readings-seeds`` seeds and the control's (the reference in
bfloat16) on the first ``--control-seeds``, and the largest and smallest
of each at the end."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent / "jointed"
BENCH = HERE.parents[1]
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import cells  # noqa: E402

NAME = "legged_hull.motors"


def cell(n_worlds: int | None = None,
         reference: str | None = None) -> cells.Cell:
    """The cell, at ``n_worlds`` worlds (by default the configuration's
    1,024), with the reference package ``reference`` in place of the one
    its configuration names (by default ``reference/``)."""
    config = cells.load_json(HERE / "config.json")
    traffic = cells.load_json(HERE / "traffic.json")
    if n_worlds is not None:
        config["scene_args"]["n_worlds"] = n_worlds
    if reference is not None:
        config["reference"] = reference
    bench = cells.benchmark()
    return cells.Cell(
        name=NAME, workload=dict(name=NAME, config=config["name"],
                                 traffic="motors", chips=1),
        config=config, traffic=traffic,
        limits=cells.load_json(HERE / "limits.json"),
        end_to_end=cells.reported(bench["end_to_end"], "batched_rl.step4"),
        per_layer=cells.reported(bench["per_layer"], "batched_rl.step4"),
        scene=cells.load_module(HERE / "scene.py"),
        entry=cells.load_module(BENCH / "entries"
                                / f"{config['entry']}.py"),
        reference=cells.reference_of(config),
        control=cells.control_of(traffic))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings-seeds", type=int, default=0)
    ap.add_argument("--control-seeds", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("jointed_cell: no CUDA device", file=sys.stderr)
        return 2
    import readings
    import run

    c = cell(args.worlds)
    for seed in args.seeds:
        res, _ = run.run_cell(c, seed, args.seconds, bool(args.trace),
                              "cuda:0", time.perf_counter())
        print(json.dumps(dict(seed=seed, **res)), flush=True)
    rows = []
    for k, seed in enumerate(args.seeds[:args.readings_seeds]):
        row = readings.readings(c, seed % (1 << 63), args.seconds,
                                k < args.control_seeds, "cuda:0")
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rows:
        print(json.dumps(dict(workload=NAME, worlds=args.worlds,
                              seeds=len(rows),
                              summary=readings.summary(rows))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
