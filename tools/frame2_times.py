#!/usr/bin/env python3
"""K4 alone, for one or more checkouts, in turns on one card.

    python3 tools/frame2_times.py ROOT [ROOT ...] [--rounds 2] [--reps 10]

For each package root (a checkout, e.g. a change and its parent unpacked
with ``git archive`` into ``_checkouts/``) runs, in a process of its own,
``run_frame2`` on the inputs of ``chip_smoke.py``'s K4 phases at full size,
each at its state after its frames (``tools/frame2_digests.py`` ``phase``,
their one definition): the main path after 60 frames (with and without
every dynamic body a bullet), the same with 8 solve slots of 16, the
4096-world alternating-topology batch with per-world lists after 30
frames, the mechanism and rope-bridge batches after 60 frames, and the
benchmark's 4,096 BipedalWalker-v3 envs after 60 frames (``walker``). Each
call is timed with CUDA events over
``--reps`` launches after two warm-up ones; its outputs are hashed, so the
roots' results can be compared bitwise. The roots run in turns (ABBA for
two), ``--rounds`` times. Prints one line a root and phase, and a JSON
summary last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("main", "main_ccd", "compact", "owners_alternating", "mechanism",
          "rope_bridge", "walker")


def _tools():
    """``(chip_smoke, frame2_digests)`` of this checkout, as modules."""
    mods = []
    for name, path in (("_chip_smoke_scenes", "chip_smoke.py"),
                       ("_frame2_digests", "tools/frame2_digests.py")):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return mods


def _inputs(cs, tool, name, dev):
    """``(args, kwargs)`` of one ``run_frame2`` call of phase ``name``: its
    state after its frames (``frame2_digests.phase``)."""
    from starframe_tpu_torch import hopper, parallel

    w, cfg, frames = tool.phase(cs, name, dev)
    w = parallel.batched_rollout(w, cfg, 0, frames, record=lambda _: None)[0]
    joint_slots = (parallel.frame2_joint_slots(w, cfg) if w.joints.j > 0
                   else None)
    tables = parallel.frame2_tables(w, cfg, frames=cfg.frames_per_broadphase,
                                    elig=parallel.frame2_elig(w, cfg))
    args, kw = cs.frame_call(hopper, parallel, w, cfg, tables, joint_slots)
    if cfg.ccd:
        body, _ = parallel._frame2_arrays(w, cfg)
        kw.update(bullet=body["bullet"], ccd=True, ccd_slop=cfg.ccd_slop)
    Cs = parallel._batch_solve_cap(cfg)
    if Cs:
        kw["Cs"] = Cs
    return args, kw


def child(root: str, reps: int) -> int:
    """Time every phase with the package of ``root``; print JSON."""
    sys.path.insert(0, root)
    import torch

    import starframe_tpu_torch
    from starframe_tpu_torch import hopper

    pkg = os.path.dirname(os.path.abspath(starframe_tpu_torch.__file__))
    assert os.path.dirname(pkg) == root, (pkg, root)
    cs, tool = _tools()
    dev = torch.device("cuda", 0)
    out = {}
    for name in PHASES:
        args, kw = _inputs(cs, tool, name, dev)

        def call():
            return hopper.run_frame2(*args, **kw)

        for _ in range(2):
            res = call()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            call()
        t1.record()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in res:
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[name] = {"ms": t0.elapsed_time(t1) / reps,
                     "sha256": h.hexdigest()}
        del args, kw, res
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def run_turns(script: str, roots, rounds: int, reps: int,
              extra=()) -> int:
    """Run ``script --child ROOT --reps reps *extra`` for each root, in
    turns (ABBA for two), ``rounds`` times; print one line a run, which
    outputs are bitwise equal across roots, and a JSON summary last. Each
    child prints ``{name: {"ms": ..., "sha256": ..., ...}}`` as its last
    line; every key but ``sha256`` is listed over the runs."""
    import torch

    if not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: needs a CUDA device",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    order = []
    for k in range(rounds):  # turns: A B ... then ... B A
        order += roots if k % 2 == 0 else roots[::-1]
    runs = {r: [] for r in roots}
    for root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), root, "--child",
             "--reps", str(reps), *extra], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[root].append(res)
        print(f"{root}: " + ", ".join(f"{n} {r['ms']:.4f} ms"
                                      for n, r in res.items())
              + f" on {card}", flush=True)
    names = list(runs[roots[0]][0])
    summary = {root: {n: {k: ([r[n].get(k) for r in rs] if k != "sha256"
                              else rs[0][n][k]) for k in rs[0][n]}
                      for n in names}
               for root, rs in runs.items()}
    same = {n: len({summary[r][n]["sha256"] for r in roots}) == 1
            for n in names}
    print(f"outputs bitwise equal across roots: {json.dumps(same)}")
    print(json.dumps({"card": card, "times": summary}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        return child(roots[0], args.reps)
    return run_turns(__file__, roots, args.rounds, args.reps)


if __name__ == "__main__":
    sys.exit(main())
