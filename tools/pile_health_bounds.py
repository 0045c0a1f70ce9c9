#!/usr/bin/env python3
"""Pile-health reference for the pile phases of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 tools/pile_health_bounds.py [--bodies 10000]
        [--frames 240] [--seeds 0 1 2] [--sleep]

Runs the JAX package's single-world XLA tier (``step(...,
allow_tiled=False)``, jitted, on the CPU) over ``scenes.pile(n_bodies,
sleep=..., seed=s)`` for ``--frames`` frames from the start, and prints,
after every 240 frames (bench.py's chunk) and at the last, the health
numbers ``chip_smoke.pile_health``
computes for the port's tile engine on the same scene: the dynamic bodies'
mean height (the centre of mass of the equal-density pile), the fastest
body's speed and the mean speed, the lowest body's height, and the share
of dynamic bodies asleep (``sleep_count >= sleep_frames``). The XLA tier
solves the same contacts as the tile engine up to summation order; the pile
is chaotic, so ``chip_smoke.py`` holds the port's aggregate numbers to
bounds around these, not its bodies to the reference's.

Without ``--sleep`` the scene is ``pile(sleep=False)`` (every body live);
``--sleep`` runs the pile's own default, ``sleep=True`` (``sleep_velocity
= 0.1``, ``sleep_frames = 30``), which bench.py's ``pile`` config runs in
chunks of 240 frames. The default is the published 10k pile, the size
``chip_smoke.py`` runs: about four minutes per 240 frames a seed on a CPU.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 240  # frames between health reports: bench.py's chunk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--sleep", action="store_true",
                    help="the pile's default sleep config (bench.py's pile)")
    args = ap.parse_args()

    import jax

    import starframe_tpu as sf
    from starframe_tpu.step import step

    from chip_smoke import pile_health

    for seed in args.seeds:
        sc = sf.scenes.pile(n_bodies=args.bodies, sleep=args.sleep, seed=seed)
        cfg, cap = sc.config, sc.capacity
        stepj = jax.jit(
            lambda w: step(w, cfg, cap.max_pairs, allow_tiled=False)[::2])
        t0 = time.perf_counter()
        w = sc.world
        pair_ovf = cell_ovf = 0
        for frame in range(1, args.frames + 1):
            w, diag = stepj(w)
            pair_ovf = max(pair_ovf, int(diag.pair_overflow))
            cell_ovf = max(cell_ovf, int(diag.cell_overflow))
            if frame % CHUNK and frame != args.frames:
                continue
            b = w.bodies
            dyn = np.asarray(b.inv_mass) > 0
            health = pile_health(np.asarray(b.pos), np.asarray(b.vel), dyn)
            asleep = float(np.mean(
                np.asarray(b.sleep_count)[dyn] >= cfg.sleep_frames))
            print(f"pile n_bodies={args.bodies} seed={seed} sleep="
                  f"{args.sleep}: frame {frame}, {cfg.substeps} substeps, "
                  f"{time.perf_counter() - t0:.1f} s on the CPU; health "
                  f"{health}; asleep share {asleep}; pair_overflow "
                  f"{pair_ovf}, cell_overflow {cell_ovf}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
