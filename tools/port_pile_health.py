#!/usr/bin/env python3
"""The port's pile health over seeds, on one GPU.

    python3 tools/port_pile_health.py [--scene pile|compound]
        [--seeds 1 2] [--frames 240] [--bodies 10000] [--trace FRAME]

Runs the port's tile engine (``tiled.tiled_rollout``, in chunks of 240
frames as bench.py does) over ``scenes.pile(n_bodies, seed=s)`` (bench.py's
``pile``, sleep on) or ``scenes.pile_compound(n_bodies, seed=s)`` for
``--frames`` frames from the start, and prints for each seed the health
numbers ``chip_smoke.pile_health`` computes (the dynamic bodies' mean
height, the lowest one's, the fastest and mean speed), the asleep share and
the run's hard counters. ``chip_smoke.py`` reads seed 0; this gives the
port's own spread beside it. Needs a CUDA device.

``--trace FRAME`` (``--frames`` at most 240: one chunk) then follows the
body that is fastest at ``--frames`` back to FRAME: the pile's fastest
body and its speed at each frame in between (a rollout from the start for
each, as the chunk runs), the frame that launches that body and the frame
in which the pile's top speed rose most, and the contacts the body there
has in that frame (the contact-event keys of one rollout with events,
which leave the state bitwise unchanged): each partner's body, speed
before and after, mass and centre distance. Then the plain twins run the
same rollouts from the start (the kernels' schedule) to those frames, and
from the state at FRAME both run to ``--frames``, frame by frame and in
one rollout: whether the twins launch the body too.
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
    ap.add_argument("--trace", type=int, default=None, metavar="FRAME")
    args = ap.parse_args()
    if args.trace is not None and not 0 < args.trace < args.frames <= 240:
        ap.error("--trace needs 0 < FRAME < --frames <= 240")

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
        if args.trace is not None:
            trace(sc.world, cfg, args.trace, args.frames, seed)
    return 0


def _speeds(w):
    import torch

    b = w.bodies
    return torch.where(b.inv_mass > 0, b.vel.norm(dim=-1), 0.0)


def trace(w0, cfg, first: int, last: int, seed: int) -> None:
    """The ``--trace`` report (see the module docstring)."""
    from starframe_tpu_torch import tiled

    def run(w, n, plain=False):
        return tiled.tiled_rollout(w, cfg, n, plain=plain)[0]

    def fastest(w):
        v = _speeds(w)
        i = int(v.argmax())
        return i, float(v[i])

    states = {n: run(w0, n) for n in range(first, last + 1)}
    top = {n: fastest(w) for n, w in states.items()}
    body, speed = top[last]
    series = {n: float(_speeds(w)[body]) for n, w in states.items()}
    launch = next((n for n in sorted(series) if series[n] >= 0.5 * speed),
                  first)
    # where the fastest speed in the pile rose most in one frame
    jump = max(range(first + 1, last + 1),
               key=lambda n: top[n][1] - top[n - 1][1])
    b0 = w0.bodies
    print(f"seed {seed}: fastest body by frame: " + ", ".join(
        f"{n}:{b}@{v:.3f}" for n, (b, v) in top.items()))
    print(f"seed {seed}: fastest body at frame {last} is {body} at "
          f"{speed:.4f} m/s (mass {1 / float(b0.inv_mass[body]):.4g} kg); "
          f"its speed by frame: " + ", ".join(
              f"{n}:{v:.3f}" for n, v in series.items())
          + f"; first at half its frame-{last} speed at frame {launch}; the "
          f"pile's top speed rose most in frame {jump}, to body "
          f"{top[jump][0]} at {top[jump][1]:.4f} m/s")

    _, _, keys = tiled.tiled_rollout(w0, cfg, last, with_events=True)
    M = w0.colliders.m
    owner = w0.colliders.body_idx.long()
    for who, f in ((body, launch), (top[jump][0], jump)):
        k = keys[f - 1].reshape(-1)
        k = k[k >= 0].long()
        a, c = k // M, k % M
        mine = (owner[a] == who) | (owner[c] == who)
        pairs = sorted({(int(x), int(y)) for x, y in zip(a[mine], c[mine])})
        w, wp = states[f], states.get(f - 1) or run(w0, f - 1)
        pos, spd, spd0 = w.bodies.pos, _speeds(w), _speeds(wp)
        parts = []
        for x, y in pairs:
            mine_c, other = (x, y) if int(owner[x]) == who else (y, x)
            pb = int(owner[other])
            im = float(w.bodies.inv_mass[pb])
            parts.append(
                f"collider {mine_c} - {other} (body {pb}, "
                f"{'static' if im == 0 else f'{1 / im:.4g} kg'}, "
                f"{float(spd0[pb]):.3f} -> {float(spd[pb]):.3f} m/s, centre "
                f"distance {float((pos[pb] - pos[who]).norm()):.4f} m)")
        print(f"seed {seed}: body {who} in frame {f}: {float(spd0[who]):.3f} "
              f"-> {float(spd[who]):.3f} m/s at ({float(pos[who, 0]):.3f}, "
              f"{float(pos[who, 1]):.3f}); its touching contacts: "
              + ("; ".join(parts) if parts else "none"))

    # the twins on the kernels' schedule: one rollout from the start
    for n in sorted({jump - 1, jump, launch - 1, launch, last}):
        wk, wp = states.get(n) or run(w0, n), run(w0, n, plain=True)
        fk, fp = fastest(wk), fastest(wp)
        print(f"seed {seed}: frame {n} from the start, kernels against plain "
              f"twins: body {body} {float(_speeds(wk)[body]):.4f} / "
              f"{float(_speeds(wp)[body]):.4f} m/s, body {top[jump][0]} "
              f"{float(_speeds(wk)[top[jump][0]]):.4f} / "
              f"{float(_speeds(wp)[top[jump][0]]):.4f} m/s, fastest "
              f"{fk[0]}@{fk[1]:.4f} / {fp[0]}@{fp[1]:.4f}; largest pose "
              f"difference {float((wk.bodies.pos - wp.bodies.pos).abs().max()):.4g} m")

    # and from the state at `first`, frame by frame and in one rollout
    for plain in (False, True):
        w = states[first]
        steps = []
        for n in range(first, last):
            w = run(w, 1, plain=plain)
            steps.append(float(_speeds(w)[body]))
        end = run(states[first], last - first, plain=plain)
        fe = fastest(end)
        print(f"seed {seed}: from frame {first}, through the "
              f"{'plain twins' if plain else 'kernels'}: body {body}'s "
              f"speed frame by frame (one rollout a frame) "
              + ", ".join(f"{first + i + 1}:{v:.3f}"
                          for i, v in enumerate(steps))
              + f"; in one rollout to frame {last}: body {body} at "
              f"{float(_speeds(end)[body]):.4f} m/s, fastest body "
              f"{fe[0]} at {fe[1]:.4f} m/s")


if __name__ == "__main__":
    sys.exit(main())
