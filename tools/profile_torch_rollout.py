#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's batched rollout, on one GPU.

    python3 tools/profile_torch_rollout.py
        [--scene batched|batched_ccd|batched_compact|batched_owners|
                 batched_sleep|batched_events|mechanism|rope|pile|
                 pile_sleep|pile_events|pile_compound|pile_ccd] [--worlds W]
        [--bodies N] [--frames F]
        [--substeps 10] [--trace PATH]

Runs one of the paths of ``chip_smoke.py`` (``batched``: the main path,
``parallel.batched_rollout`` over ``batched_worlds`` at 4096 worlds x
``--bodies`` (256); ``mechanism``/``rope``: ``batchify`` of the jointed
scene at 1024 worlds; ``pile``: ``tiled.tiled_rollout`` over
``scenes.pile(--bodies (10000), sleep=False)``, 240 frames; ``pile_sleep``:
bench.py's ``pile`` config, ``scenes.pile(--bodies)`` with its default
sleep, 240 frames from the state after SETTLE_FRAMES (960) frames, where
~85% of the bodies sleep; ``pile_events``: bench.py's ``pile_events``,
``pile`` with ``with_events=True``; ``pile_compound``: bench.py's
``pile_compound``, ``scenes.pile_compound(--bodies)``, 240 frames from the
state after SETTLE_FRAMES frames; ``batched_ccd`` and ``pile_ccd``:
``batched`` and ``pile`` with ``ccd=True`` and every dynamic body a bullet;
``batched_compact``: ``batched`` with 16 table slots and 8 solve slots
(``batch_solve_capacity``; at the main path's 8, every solve width drops
imminent slots); ``batched_owners``: with per-world owner
tables (``batch_uniform_topology=False``); ``batched_sleep``: with the
pile's sleep (``sleep_velocity`` 0.1, 30 frames), 240 frames from the
start; ``batched_events``: ``batched_rollout(with_keys=True)``) once to
warm up, three times unprofiled for wall times, then once under
``torch.profiler``, and prints, from the benchmark's own reduction of the
trace (``portbench/harness/trace.py`` and ``spans.py``):

- each device kernel's total time, call count and share of device time
  (the hand-written kernels by name, the small PyTorch ops together);
- device busy time (the union of kernel, copy and set intervals) against
  the profiled wall, and so the device's idle share;
- each ``starframe.*`` span the rollout records (``starframe_tpu_torch/
  spans.py``): its count, its self time (less its nested spans) and the
  device's idle time inside it, which with the idle under no span sum to
  the wall's;
- device kernels and host syncs per frame, peak device memory;
- for the batched paths, one ``frame2_step`` (the frame kernel plus its
  array packing; CUDA events) on the starting batch and on the final one,
  beside the slot-table entries per world it solves over.

Imports the package from the checkout this file lives in. ``--trace``
keeps the Chrome trace; without it the trace goes to a temporary file.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "portbench")]

from harness import spans, trace  # noqa: E402

SETTLE_FRAMES = 960  # pile_sleep: frames run before the measured ones
WINDOW = "profile_torch_rollout.window"  # the profiled rollout's mark
PILES = ("pile", "pile_sleep", "pile_events", "pile_compound", "pile_ccd")
BATCHED = ("batched", "batched_ccd", "batched_compact", "batched_owners",
           "batched_sleep", "batched_events")
# each batched scene's changes to the main path's config
BATCHED_CFG = {"batched_compact": dict(slot_capacity=16,
                                      batch_solve_capacity=8),
               "batched_owners": dict(batch_uniform_topology=False),
               "batched_sleep": dict(sleep_velocity=0.1, sleep_frames=30)}


def bulleted(sc):
    """``sc`` with ``ccd`` on and every dynamic body flagged a bullet."""
    import dataclasses

    import torch
    from starframe_tpu_torch.state import BODY_BULLET

    b = sc.world.bodies
    flags = torch.where(b.inv_mass > 0, b.flags | BODY_BULLET, b.flags)
    world = dataclasses.replace(sc.world,
                                bodies=dataclasses.replace(b, flags=flags))
    return dataclasses.replace(sc, world=world, config=dataclasses.replace(
        sc.config, ccd=True))


def frame_step_ms(parallel, w, cfg, reps: int = 5):
    """CUDA-event time of one ``frame2_step`` on ``w``, and the slot-table
    entries per world it solves over."""
    import torch

    tables = parallel.frame2_tables(w, cfg, frames=cfg.frames_per_broadphase)
    kw = dict(owners=parallel.frame2_owners(w, cfg),
              joint_slots=(parallel.frame2_joint_slots(w, cfg)
                           if w.joints.j > 0 else None))
    parallel.frame2_step(w, cfg, tables=tables, **kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        parallel.frame2_step(w, cfg, tables=tables, **kw)
    end.record()
    torch.cuda.synchronize()
    per_world = float(tables[1].sum()) / tables[1].shape[0]
    return start.elapsed_time(end) / reps, per_world


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=BATCHED + ("mechanism", "rope")
                    + PILES, default="batched")
    ap.add_argument("--worlds", type=int, default=None,
                    help="default 4096 for batched, 1024 for the jointed")
    ap.add_argument("--bodies", type=int, default=None,
                    help="default 256 a world for batched, 10000 for pile")
    ap.add_argument("--frames", type=int, default=None,
                    help="default 60, 240 for pile (bench.py's pile chunk)")
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--trace", default=None, help="keep the Chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_rollout: needs a CUDA device", file=sys.stderr)
        return 2
    from starframe_tpu_torch import parallel, scenes, tiled

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.scene == "pile_compound":
        args.worlds = 1
        sc = scenes.pile_compound(n_bodies=args.bodies or 10_000,
                                  substeps=args.substeps, device="cuda")
    elif args.scene in PILES:
        args.worlds = 1
        sc = scenes.pile(n_bodies=args.bodies or 10_000, substeps=args.substeps,
                         sleep=args.scene == "pile_sleep", device="cuda")
    elif args.scene in BATCHED:
        args.worlds = args.worlds or 4096
        sc = scenes.batched_worlds(n_worlds=args.worlds,
                                   n_bodies=args.bodies or 256,
                                   substeps=args.substeps, device="cuda")
    else:
        args.worlds = args.worlds or 1024
        make = (scenes.mechanism if args.scene == "mechanism"
                else scenes.rope_bridge)
        sc = scenes.batchify(make(substeps=args.substeps, device="cuda"),
                             args.worlds)
    if args.scene.endswith("_ccd"):
        sc = bulleted(sc)
    if args.scene in BATCHED_CFG:
        import dataclasses

        sc = dataclasses.replace(sc, config=dataclasses.replace(
            sc.config, **BATCHED_CFG[args.scene]))
    cfg = sc.config
    F = args.frames or (240 if args.scene in PILES + ("batched_sleep",)
                        else 60)
    active = int(((sc.world.bodies.flags & 1) != 0).sum())
    syncing = tiled if args.scene in PILES else parallel
    start = sc.world
    if args.scene in ("pile_sleep", "pile_compound"):
        start, _ = tiled.tiled_rollout(start, cfg, SETTLE_FRAMES)
        dyn = start.bodies.inv_mass > 0
        asleep = ((start.bodies.sleep_count >= cfg.sleep_frames) & dyn).sum()
        print(f"after {SETTLE_FRAMES} settling frames: "
              f"{float(asleep / dyn.sum()):.4f} of the dynamic bodies asleep")

    def rollout():
        if args.scene in PILES:
            return tiled.tiled_rollout(start, cfg, F,
                                       with_events=args.scene == "pile_events")
        return parallel.batched_rollout(
            sc.world, cfg, 0, F, record=lambda _: None,
            with_keys=args.scene == "batched_events")

    rollout()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rollout()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"card: {card}")
    print(f"{args.scene}: {args.worlds} worlds x {sc.world.bodies.n} body slots "
          f"({active} active bodies), {args.substeps} substeps, {F} frames; "
          f"unprofiled walls {', '.join(f'{w:.4f}' for w in walls)} s "
          f"({', '.join(f'{1e3 * w / F:.4f}' for w in walls)} ms/frame)")

    torch.cuda.reset_peak_memory_stats()
    syncs0 = syncing.host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            final = rollout()[0]
            torch.cuda.synchronize()
    syncs = syncing.host_syncs - syncs0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = trace.load_events(path)
    host = trace.host_events(events)
    ((_, t0, t1),) = [h for h in host if h[0] == WINDOW]
    dev = trace.device_events(events, t0, t1)
    if not dev:
        print("no device events in the trace: the profiler saw no device "
              "time", file=sys.stderr)
        return 1
    seconds = trace.device_by_label(dev)
    calls = collections.Counter(trace.kernel_label(n, c) for n, c, _, _ in dev)
    device_s = sum(seconds.values())
    wall_ms = (t1 - t0) / 1e3
    busy_ms = trace.busy_us(dev) / 1e3
    print(f"profiled run on {card}:")
    print("| device work | total ms | calls | share of device time |")
    print("|---|---|---|---|")
    for label, sec in trace.top(seconds, len(seconds)):
        print(f"| {label} | {1e3 * sec:.3f} | {calls[label]} | "
              f"{100 * sec / device_s:.2f}% |")
    n_kernels = sum(1 for d in dev if d[1] == "kernel")
    print(f"device busy {busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled wall: "
          f"idle {100 * (1 - busy_ms / wall_ms):.2f}%; "
          f"{n_kernels / F:.2f} device kernels per frame; host syncs "
          f"{syncs} ({syncs / F:.3f}/frame); peak device memory "
          f"{peak_gib:.3f} GiB")
    red = spans.reduce(dict(dev=dev, host=host, t0_us=t0, t1_us=t1))
    print("| span | spans | a frame | self ms | device idle ms | idle, % of "
          "wall |")
    print("|---|---|---|---|---|---|")
    for name in sorted(red["self_s"], key=lambda n: (n is None, n or "")):
        n = red["counts"].get(name, 0)
        print(f"| {name or '(no span)'} | {n} | {n / F:.3f} | "
              f"{1e3 * red['self_s'][name]:.3f} | "
              f"{1e3 * red['idle_s'][name]:.3f} | "
              f"{100 * red['idle_s'][name] / (wall_ms / 1e3):.2f}% |")

    if args.scene in PILES:
        return 0
    if cfg.sleep_velocity > 0.0:
        dyn = final.bodies.inv_mass > 0
        asleep = parallel._asleep(final.bodies, cfg).sum()
        print(f"after {F} frames: {float(asleep / dyn.sum()):.4f} of the "
              f"dynamic bodies asleep")
    for name, w in (("starting batch", sc.world), (f"after {F} frames", final)):
        ms, per_world = frame_step_ms(parallel, w, cfg)
        print(f"frame2_step on the {name}: {ms:.4f} ms "
              f"({per_world:.1f} slot-table entries per world)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
