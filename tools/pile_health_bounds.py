#!/usr/bin/env python3
"""Pile-health reference for the pile phases of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 tools/pile_health_bounds.py
        [--scene pile|compound] [--tier xla|tiles] [--bodies 10000]
        [--frames 240] [--seeds 0 1 2] [--sleep]

Runs the JAX package on the CPU over ``scenes.pile(n_bodies, sleep=...,
seed=s)`` (``--scene pile``, the default) or
``scenes.pile_compound(n_bodies, seed=s)`` (``--scene compound``: two
colliders a body, sleep on, as bench.py's ``pile_compound``) for
``--frames`` frames from the start, and prints, after every 240 frames
(bench.py's chunk) and at the last, the health numbers
``chip_smoke.pile_health`` computes for the port's tile engine on the same
scene: the dynamic bodies' mean height (the centre of mass of the
equal-density pile), the fastest body's speed and the mean speed, the
lowest body's height, and the share of dynamic bodies asleep
(``sleep_count >= sleep_frames``), with the run's hard overflow counters.
The pile is chaotic, so ``chip_smoke.py`` holds the port's aggregate
numbers to bounds around these, not its bodies to the reference's.

``--tier xla`` (the default for ``pile``) runs the single-world XLA tier
(``step(..., allow_tiled=False)``, jitted), which solves the same contacts
as the tile engine up to summation order. ``--tier tiles`` (the default
for ``compound``) runs the JAX package's tile engine itself
(``tiled_rollout(..., interpret=True)``, jitted, 240 frames a call: ~8 s
a frame at 10k compound bodies alone, ~17 s with three seeds run at
once on 8 cores): while the compound pile's 41-row lattice
falls, the XLA tier's grid broadphase puts ~4000 fast colliders into its
64-entry large set and drops their pairs (``pair_overflow`` ~4000, a hard
counter), and with a large set that drops none it runs past 15 s a frame.

Without ``--sleep`` the pile is ``pile(sleep=False)`` (every body live);
``--sleep`` runs the pile's own default, ``sleep=True`` (``sleep_velocity
= 0.1``, ``sleep_frames = 30``), which bench.py's ``pile`` config runs in
chunks of 240 frames; the compound pile has one config, with sleep on.
The default is the published 10k size, the size ``chip_smoke.py`` runs:
about four minutes per 240 frames a seed for the pile on the XLA tier,
half an hour to 70 minutes for the compound pile on the tile engine.
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
    ap.add_argument("--scene", choices=("pile", "compound"), default="pile")
    ap.add_argument("--tier", choices=("xla", "tiles"), default=None,
                    help="default: xla for pile, tiles for compound")
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--sleep", action="store_true",
                    help="the pile's default sleep config (bench.py's pile)")
    args = ap.parse_args()
    if args.sleep and args.scene != "pile":
        ap.error("--sleep applies to --scene pile only")
    tier = args.tier or ("xla" if args.scene == "pile" else "tiles")

    import jax

    import starframe_tpu as sf
    from starframe_tpu.step import step
    from starframe_tpu.tiled import tiled_rollout

    from chip_smoke import pile_health

    for seed in args.seeds:
        if args.scene == "pile":
            sc = sf.scenes.pile(n_bodies=args.bodies, sleep=args.sleep,
                                seed=seed)
        else:
            sc = sf.scenes.pile_compound(n_bodies=args.bodies, seed=seed)
        cfg, cap = sc.config, sc.capacity
        if tier == "xla":
            stepj = jax.jit(
                lambda w: step(w, cfg, cap.max_pairs, allow_tiled=False)[::2])

            def advance(w, n):
                over = {"pair_overflow": 0, "cell_overflow": 0}
                for _ in range(n):
                    w, diag = stepj(w)
                    for k in over:
                        over[k] = max(over[k], int(getattr(diag, k)))
                return w, over
        else:
            chunk = jax.jit(lambda w, n: tiled_rollout(w, cfg, n,
                                                       interpret=True),
                            static_argnums=1)

            def advance(w, n):
                w, diag = chunk(w, n)
                return w, {k: int(v) for k, v in diag.items()
                           if k in ("slot_overflow", "solve_overflow",
                                    "window_overflow", "large_overflow",
                                    "owner_overflow")}

        t0 = time.perf_counter()
        w, frame, worst = sc.world, 0, {}
        while frame < args.frames:
            n = min(CHUNK, args.frames - frame)
            w, over = advance(w, n)
            frame += n
            worst = {k: max(worst.get(k, 0), v) for k, v in over.items()}
            b = w.bodies
            dyn = np.asarray(b.inv_mass) > 0
            health = pile_health(np.asarray(b.pos), np.asarray(b.vel), dyn)
            asleep = float(np.mean(
                np.asarray(b.sleep_count)[dyn] >= cfg.sleep_frames))
            print(f"{sc.name} n_bodies={args.bodies} seed={seed} sleep="
                  f"{cfg.sleep_velocity > 0} tier={tier}: frame {frame}, "
                  f"{cfg.substeps} substeps, {time.perf_counter() - t0:.1f} s "
                  f"on the CPU; health {health}; asleep share {asleep}; "
                  f"hard counters {worst}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
