#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the card, in one process:

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 3] [--seconds 3]

For each seed: the cell's set-up (with its warm-up episode, which finds
the calls that fail) and a short window at its own load (long enough for
an episode), then the compared numbers of the program's sampled answers
against the cell's plain reference package; for the first
``--control-seeds`` seeds also the control's: that reference computed in
bfloat16, the nearest precision below the configuration's float32, put in
the program's place on the same inputs. One JSON line a seed; the largest
program reading and the smallest control reading of each number at the
end. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import cells, check, window  # noqa: E402


def extended(pos, ang) -> dict:
    """The compared numbers and a few more quantiles, for choosing."""
    out = check.numbers(pos, ang)
    out.update(pos_gap_p90_m=check.quantile(pos, 0.90),
               pos_gap_p999_m=check.quantile(pos, 0.999),
               ang_gap_max_rad=float(ang.max()))
    return out


def readings(cell, seed: int, seconds: float, control: bool, device):
    import torch

    cfg = cells.solver_config(cell.config)
    call = cell.entry.call
    t0 = time.perf_counter()
    start, bad = window.set_up(cell, seed, device, cfg, call)
    start = window.clone_world(start)
    F = cell.traffic["frames_per_call"]
    import run

    positions = run.seed_positions(
        seed, cell.traffic["episode_frames"] // F, cell.traffic["check_calls"])
    positions = sorted(set(positions) | window.warm_up(
        cell, start, cfg, call, positions, device, seed))
    win = window.run(cell, start, cfg, call, seconds, positions, device, seed)
    setup = time.perf_counter() - t0
    del start
    torch.cuda.empty_cache()
    ref = cell.reference
    rcfg = check.reference_config(cell.config["solver"], cell.config["entry"],
                                  ref)
    rcfg["gravity"] = tuple(cell.config["gravity"])
    geom, _ = ref.world.build(cell.scene.describe(cell.config["scene_args"],
                                                  seed), device)
    dyn = geom["invm"] > 0
    t1 = time.perf_counter()
    refs, first = check.reference_outputs(geom, rcfg, win.samples, F,
                                          reference=ref)
    ref_s = time.perf_counter() - t1

    def nums(answers):
        pos, ang = [], []
        for r, a in zip(refs, answers):
            g = check.gaps(a, r, dyn)
            pos.append(g["pos"])
            ang.append(g["ang"])
        return extended(torch.cat(pos), torch.cat(ang))

    row = dict(seed=seed, samples=[s["pos"] for s in win.samples],
               hard=[s["hard"] for s in win.samples], reference_first=first,
               counter_misses=check.counter_misses(
                   win.samples, first, cell.entry.implied,
                   cell.config["solver"]),
               failed=sum(win.failed), flagged_calls=sum(win.flagged_calls),
               calls=len(win.walls_s),
               flagged=sorted(win.flagged),
               flagged_unchecked=check.flagged_unchecked(win.flagged,
                                                         win.samples),
               settle_flagged=bad, setup_and_window_s=setup,
               reference_s=ref_s,
               program=nums([s["out"] for s in win.samples]))
    if control:
        low, _ = check.reference_outputs(geom, rcfg, win.samples, F,
                                         dtype=torch.bfloat16, reference=ref)
        row["control"] = nums(low)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    rows = []
    for k, seed in enumerate(args.seeds):
        row = readings(cell, seed % (1 << 63), args.seconds,
                       k < args.control_seeds, "cuda:0")
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=len(rows),
                          summary=summary(rows))), flush=True)
    return 0


def summary(rows) -> dict:
    """Each number's largest program reading and smallest control reading
    over the rows of :func:`readings`."""
    return {name: dict(
        program_max=max(r["program"][name] for r in rows),
        control_min=min((r["control"][name] for r in rows
                         if "control" in r), default=None))
        for name in rows[0]["program"]}


if __name__ == "__main__":
    sys.exit(main())
