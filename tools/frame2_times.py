#!/usr/bin/env python3
"""K4 alone, for one or more checkouts, in turns on one card.

    python3 tools/frame2_times.py ROOT [ROOT ...] [--rounds 2] [--reps 10]
        [--phases main ...]

For each package root (a checkout, e.g. a change and its parent unpacked
with ``git archive`` into ``_checkouts/``) runs, in a process of its own,
``run_frame2`` on the inputs of ``chip_smoke.py``'s K4 phases at full size,
each at its state after its frames (``tools/frame2_digests.py`` ``phase``,
their one definition): the main path after 60 frames (with and without
every dynamic body a bullet), the same with 8 solve slots of 16, the
4096-world alternating-topology batch with per-world lists after 30
frames, the mechanism and rope-bridge batches after 60 frames, and the
benchmark's 4,096 BipedalWalker-v3 envs after 60 frames (``walker``). Each
call is timed with CUDA events over ``--reps`` launches after two warm-up
ones, beside the blocks an SM its launch runs (the root's library's
occupancy answer); its outputs are hashed, so the roots' results can be
compared bitwise. The roots run in turns (ABBA for
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
    spec = importlib.util.spec_from_file_location(
        "_frame2_digests", os.path.join(HERE, "tools", "frame2_digests.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool._smoke(), tool


def _inputs(cs, tool, name, dev):
    """``(args, kwargs)`` of one ``run_frame2`` call of phase ``name``: its
    state after its frames (``frame2_digests.phase``)."""
    from starframe_tpu_torch import hopper, parallel

    w, cfg, frames = tool.phase(cs, name, dev)
    w = parallel.batched_rollout(w, cfg, 0, frames, record=lambda _: None)[0]
    tables = parallel.frame2_tables(w, cfg, frames=cfg.frames_per_broadphase,
                                    elig=parallel.frame2_elig(w, cfg))
    return cs.frame_call(hopper, parallel, w, cfg, tables)


def _blocks_per_sm(x) -> int:
    """Resident blocks an SM of the K4 launch on inputs ``x`` (a
    ``Frame2Inputs``), from the root's library: with the rows that may
    hold a slot (``x.Rs``) where the root's layout takes them."""
    from starframe_tpu_torch.hopper import _build

    N, M = x.kin.shape[1], x.cbody.shape[1]
    rs = (x.Rs,) if hasattr(x, "Rs") else ()
    return _build.library().sf_frame2_blocks_per_sm(
        x.Vk, x.J, int(x.ccd), N, M, x.Csol, *rs)


def child(root: str, reps: int, phases=PHASES) -> int:
    """Time each phase with the package of ``root``; print JSON."""
    sys.path.insert(0, root)
    import torch

    import starframe_tpu_torch
    from starframe_tpu_torch import hopper

    pkg = os.path.dirname(os.path.abspath(starframe_tpu_torch.__file__))
    assert os.path.dirname(pkg) == root, (pkg, root)
    cs, tool = _tools()
    dev = torch.device("cuda", 0)
    out = {}
    for name in phases:
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
                     "blocks": _blocks_per_sm(args[-1]),
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
        print(f"{root}: " + ", ".join(
            f"{n} {r['ms']:.4f} ms"
            + (f" ({r['blocks']} blocks an SM)" if "blocks" in r else "")
            for n, r in res.items()) + f" on {card}", flush=True)
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
    ap.add_argument("--phases", nargs="+", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        return child(roots[0], args.reps, args.phases)
    return run_turns(__file__, roots, args.rounds, args.reps,
                     extra=("--phases", *args.phases))


if __name__ == "__main__":
    sys.exit(main())
