#!/usr/bin/env python3
"""K1 and K2 alone, for one or more checkouts, in turns on one card.

    python3 tools/slots_times.py ROOT [ROOT ...] [--rounds 2] [--reps 20]

For each package root (a checkout, e.g. a change and its parent unpacked
with ``git archive`` into ``_checkouts/``) runs, in a process of its own,
the eligibility mask (K1, ``build_elig_mask``) and the slot tables (K2,
``build_slot_tables``) on the inputs a rollout passes them at a table build
(``chip_smoke.slot_call_args``), each phase at its state after its frames
(``tools/frame2_digests.py`` ``phase``, their one definition): the main
path after 60 frames (partner-aware, C = 8), the same state at C = 16 (the
compact phases' table width), the projectile batch (4096 worlds x 128
bodies, K = 1) and the mechanism and rope-bridge batches (1024 worlds,
K = 1). Each call is timed with CUDA events over ``--reps`` launches after
two warm-up ones; its outputs are hashed, so the roots' results can be
compared bitwise. The roots run in turns (ABBA for two), ``--rounds``
times (``tools/frame2_times.py`` ``run_turns``). Prints one line a root,
a line saying which outputs are bitwise equal across roots, and a JSON
summary last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# phase -> (frame2_digests phase whose state it takes, slot capacity or None)
PHASES = {"main": ("main", None), "main_c16": ("main", 16),
          "projectile": ("projectile_200", None),
          "mechanism": ("mechanism", None),
          "rope_bridge": ("rope_bridge", None)}


def _times():
    """This checkout's ``tools/frame2_times.py``, as a module."""
    spec = importlib.util.spec_from_file_location(
        "_frame2_times", os.path.join(HERE, "tools", "frame2_times.py"))
    times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(times)
    return times


def _calls(cs, tool, name, dev):
    """``{kernel: call}`` of phase ``name``: K1 and K2 on its state after
    its frames."""
    from starframe_tpu_torch import hopper, parallel

    state, C = PHASES[name]
    w, cfg, frames = tool.phase(cs, state, dev)
    w = parallel.batched_rollout(w, cfg, 0, frames, record=lambda _: None)[0]
    if C is not None:
        cfg = dataclasses.replace(cfg, slot_capacity=C)
    eargs, sargs, skw = cs.slot_call_args(parallel, w, cfg)
    elig = hopper.build_elig_mask(*eargs)
    return {"elig": lambda: hopper.build_elig_mask(*eargs),
            "slots": lambda: hopper.build_slot_tables(*sargs, elig, **skw)}


def child(root: str, reps: int) -> int:
    """Time every phase with the package of ``root``; print JSON."""
    sys.path.insert(0, root)
    import torch

    import starframe_tpu_torch

    pkg = os.path.dirname(os.path.abspath(starframe_tpu_torch.__file__))
    assert os.path.dirname(pkg) == root, (pkg, root)
    cs, tool = _times()._tools()
    dev = torch.device("cuda", 0)
    out = {}
    for name in PHASES:
        calls = _calls(cs, tool, name, dev)
        for kernel, call in calls.items():
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
            for t in (res if isinstance(res, tuple) else (res,)):
                h.update(t.contiguous().cpu().numpy().tobytes())
            out[f"{name}/{kernel}"] = {"ms": t0.elapsed_time(t1) / reps,
                                       "sha256": h.hexdigest()}
            del res
        del calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        return child(roots[0], args.reps)
    return _times().run_turns(__file__, roots, args.rounds, args.reps)


if __name__ == "__main__":
    sys.exit(main())
