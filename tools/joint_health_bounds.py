#!/usr/bin/env python3
"""Joint-health reference for the jointed batches of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 tools/joint_health_bounds.py [--worlds 32]

Runs the JAX package's batched frame-kernel path (Pallas in interpret mode,
on the CPU) over ``batchify(mechanism(), W)`` and
``batchify(rope_bridge(), W)`` at 10 substeps for 60 frames from the start,
as ``chip_smoke.py`` runs the port's, and prints the health numbers
``chip_smoke.joint_health`` computes per world: the worst pin/weld anchor
gap, the worst distance-joint stretch outside ``[lo, hi]``, the fastest
body's speed, and for the mechanism how far the wheel's mean angular
velocity over the run and its final one lie from the motor's 2 rad/s; each
as its median, 99th percentile and max over the worlds. ``chip_smoke.py`` derives its bounds from these
numbers.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 60


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", type=int, default=32)
    args = ap.parse_args()

    import starframe_tpu as sf

    from chip_smoke import joint_health, quantiles

    for name in ("mechanism", "rope_bridge"):
        base = getattr(sf.scenes, name)()
        sc = sf.scenes.batchify(base, args.worlds)
        t0 = time.perf_counter()
        final, _, diag = sf.parallel.batched_rollout(
            sc.world, sc.config, 0, FRAMES, record=lambda _: None,
            interpret=True)
        b, j = final.bodies, final.joints
        per_world = joint_health(
            np.asarray(b.pos), np.asarray(b.angle),
            {k: np.asarray(getattr(j, k)) for k in (
                "jtype", "body_a", "body_b", "anchor_a", "anchor_b", "lo",
                "hi")})
        if name == "mechanism":
            w = base.wheel
            mean = ((np.asarray(b.angle)[:, w]
                     - np.asarray(sc.world.bodies.angle)[:, w])
                    / (FRAMES * sc.config.dt))
            per_world["wheel_mean_err"] = np.abs(mean - 2.0)
            per_world["wheel_final_err"] = np.abs(
                np.asarray(b.ang_vel)[:, w] - 2.0)
        per_world["max_speed"] = np.linalg.norm(np.asarray(b.vel),
                                                axis=-1).max(axis=1)
        health = {k: quantiles(v) for k, v in per_world.items()}
        print(f"{name}: {args.worlds} worlds, {FRAMES} frames, "
              f"{sc.config.substeps} substeps, "
              f"{time.perf_counter() - t0:.1f} s; health {health}; "
              f"counters { {k: int(v) for k, v in diag.items()} }",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
