#!/usr/bin/env python3
"""The port's pile health over seeds, on one GPU.

    python3 tools/port_pile_health.py [--scene pile|compound]
        [--seeds 1 2] [--frames 240] [--bodies 10000]

Runs the port's tile engine (``tiled.tiled_rollout``, in chunks of 240
frames as bench.py does) over ``scenes.pile(n_bodies, seed=s)`` (bench.py's
``pile``, sleep on) or ``scenes.pile_compound(n_bodies, seed=s)`` for
``--frames`` frames from the start, and prints for each seed the health
numbers ``chip_smoke.pile_health`` computes (the dynamic bodies' mean
height, the lowest one's, the fastest and mean speed), the asleep share and
the run's hard counters. ``chip_smoke.py`` reads seed 0; this gives the
port's own spread beside it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HARD = ("slot_overflow", "solve_overflow", "window_overflow",
        "large_overflow", "owner_overflow")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("pile", "compound"),
                    default="compound")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--bodies", type=int, default=10_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_pile_health: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import pile_health
    from starframe_tpu_torch import scenes, tiled

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    make = scenes.pile_compound if args.scene == "compound" else scenes.pile
    for seed in args.seeds:
        sc = make(n_bodies=args.bodies, seed=seed, device="cuda")
        w, cfg, done, hard = sc.world, sc.config, 0, {k: 0 for k in HARD}
        while done < args.frames:
            n = min(240, args.frames - done)
            w, diag = tiled.tiled_rollout(w, cfg, n)
            done += n
            for k in HARD:
                hard[k] = max(hard[k], int(diag.get(k, 0)))
        b = w.bodies
        dyn = b.inv_mass > 0
        health = pile_health(b.pos.cpu().numpy(), b.vel.cpu().numpy(),
                             dyn.cpu().numpy())
        asleep = float(((b.sleep_count >= cfg.sleep_frames) & dyn).sum()
                       / dyn.sum())
        print(f"{args.scene} seed {seed} at frame {done}: "
              f"{json.dumps(health)}; asleep share {asleep:.4f}; hard "
              f"counters {json.dumps(hard)}; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
