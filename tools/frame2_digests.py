#!/usr/bin/env python3
"""SHA-256 digests of the final state of every K4 phase of chip_smoke.py.

    python3 tools/frame2_digests.py [ROOT] [--phases main ...] [--out FILE]

Imports ``starframe_tpu_torch`` from ROOT (default: this checkout), builds
its kernels, and runs each phase that launches the batched frame kernel
(K4) as ``chip_smoke.py`` runs it, from the same scenes and seeds and for
the same frames (:func:`phase`, their one definition): the main path, its
CCD, compacted (with and without CCD, and the same tables uncompacted,
whose rows do not all fit in shared memory), per-world-list, sleeping and
keyed forms, the two jointed batches, the projectile batches and the
escorted projectile, and the 4,096 BipedalWalker-v3 envs of the
benchmark's walker cell (``walker``: its scene and configuration under
``portbench/``, each env's 4 motor actions drawn once from
:data:`WALKER_SEED`). Each phase's digest hashes
the final bodies' pose, velocity and sleep counter (and, for the keyed
phase, every frame's contact keys). The scenes come from this checkout's
``chip_smoke.py``, so two package roots (a change and its parent, unpacked
with ``git archive``) run the same work and their digests compare. Prints
one line a phase and the whole set as JSON last; ``--out`` also writes it.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("main", "mechanism", "rope_bridge", "main_ccd", "projectile_200",
          "projectile_1000", "projectile_1000_rest", "compact",
          "compact_ccd", "compact_off", "compact_ccd_off", "escorted",
          "owners", "owners_alternating", "sleep", "events", "walker")
# the phases whose slot table does not fit in shared memory whole (rows
# past frame2_table_rows in K4's global table): the uncompacted tables
# that batched_compact times its compacted ones against
SPLIT = ("compact_off", "compact_ccd_off")
WALKER_SEED = 1_234_567  # the walker phase's terrain, push and actions


def digest(world, *extra) -> str:
    """SHA-256 of a world batch's bodies (pose, velocity, sleep counter),
    then of each tensor in ``extra``, as their raw bytes."""
    h = hashlib.sha256()
    b = world.bodies
    for t in (b.pos, b.angle, b.vel, b.ang_vel, b.sleep_count, *extra):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def keys_digest(world, keys) -> str:
    """:func:`digest` of a world and a ``[frames, ...]`` key table, one
    frame at a time (a frame's table is tens of MB)."""
    h = hashlib.sha256(digest(world).encode())
    for f in range(keys.shape[0]):
        h.update(keys[f].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _smoke():
    """This checkout's chip_smoke.py (its scenes and constants)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_scenes", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_WIDTHS = {}  # (device, ccd) -> the compact phases' (C, Cs)


def _compact_width(cs, w, cfg, dev) -> tuple:
    """``(C, Cs)`` of the compact phases: the first of
    ``cs.COMPACT_WIDTHS`` whose ``cs.FRAMES``-frame run drops no imminent
    slot (with CCD the search starts from the width the phase without CCD
    took); searched once a device."""
    import dataclasses

    from starframe_tpu_torch import parallel

    key = (str(dev), cfg.ccd)
    if key not in _WIDTHS:
        widths = cs.COMPACT_WIDTHS
        if cfg.ccd and (str(dev), False) in _WIDTHS:
            widths = widths[widths.index(_WIDTHS[(str(dev), False)]):]
        for C, Cs in widths:
            run = dataclasses.replace(cfg, slot_capacity=C,
                                      batch_solve_capacity=Cs)
            hard = int(parallel.batched_rollout(
                w, run, 0, cs.FRAMES,
                record=lambda _: None)[2]["solve_overflow"])
            if hard == 0:
                _WIDTHS[key] = (C, Cs)
                break
            print(f"compact{'_ccd' if cfg.ccd else ''}: solve_overflow "
                  f"{hard} at Cs = {Cs} of C = {C}; the phase takes the next "
                  "widths", flush=True)
        else:
            raise RuntimeError("compact: solve_overflow at every width")
    return _WIDTHS[key]


def walker(dev, frames: int, n_worlds=None) -> tuple:
    """``(world, cfg, frames)`` of the walker phase: the benchmark's
    ``bipedal_walker`` configuration (``portbench/configs/``, its scene
    ``program`` and solver; ``n_worlds`` envs in place of its 4,096 where
    given) from :data:`WALKER_SEED`, every env's motors set once by the
    ``walker_motors`` control from the same seed."""
    bench = os.path.join(HERE, "portbench")
    if bench not in sys.path:  # the control imports the harness
        sys.path.append(bench)
    from harness import cells

    config = cells.load_json(cells.BENCH / "configs" / "bipedal_walker.json")
    scene = cells.load_module(cells.BENCH / "scenes"
                              / f"{config['scene']}.py")
    control = cells.load_module(cells.BENCH / "control"
                                / "walker_motors.py")
    args = dict(config["scene_args"])
    if n_worlds is not None:
        args["n_worlds"] = n_worlds
    w = scene.program(args, WALKER_SEED, dev)
    return (control.apply(w, WALKER_SEED, 0), cells.solver_config(config),
            frames)


def phase(cs, name, dev) -> tuple:
    """``(world, cfg, frames)``: K4 phase ``name``'s start batch, config
    and frame count, the one definition that ``chip_smoke.py``, this tool
    and ``tools/frame2_times.py`` run (``cs``: the chip_smoke module, for
    its scenes and constants). ``compact*`` solves ``Cs`` of ``C`` slots
    (:func:`_compact_width`); ``compact*_off`` is the same table without
    compaction."""
    import dataclasses

    from starframe_tpu_torch import SolverConfig, parallel
    from starframe_tpu_torch.scenes import batched_worlds

    if name == "walker":
        return walker(dev, cs.FRAMES)
    if name in cs.JOINTED:
        sc, _ = cs.jointed_scene(name, cs.W_JOINTED, dev)
        return sc.world, sc.config, cs.FRAMES
    if name.startswith("projectile_"):
        rest = 0.9 if name.endswith("_rest") else 0.0
        w, cfg = cs.bullet_batch(dev, float(name.split("_")[1]),
                                 restitution=rest, worlds=cs.PROJECTILE_W)
        return w, cfg, 10 if rest else cs.PROJECTILE_FRAMES
    if name == "escorted":
        w, cfg = cs.escorted_batch(dev, 4, cs.PROJECTILE_W)
        return w, cfg, cs.PROJECTILE_FRAMES
    if name == "owners_alternating":
        pair = [cs.scene_world(dev, c) for c in (False, True)]
        cfg = SolverConfig(dt=1 / 60, substeps=cs.SUBSTEPS, slot_capacity=8,
                           batch_uniform_topology=False,
                           max_colliders_per_body=3)
        return (parallel.stack_worlds(pair * (cs.W_MAIN // 2)), cfg,
                cs.HET_FRAMES)
    if name not in PHASES:
        raise ValueError(f"unknown phase {name!r}")
    sc = batched_worlds(n_worlds=cs.W_MAIN, n_bodies=cs.N_BODIES,
                        substeps=cs.SUBSTEPS, device=dev)
    w, cfg, frames = sc.world, sc.config, cs.FRAMES
    if "ccd" in name:
        w, cfg = cs.bulleted(w), dataclasses.replace(cfg, ccd=True)
    if name.startswith("compact"):
        C, Cs = _compact_width(cs, w, cfg, dev)
        cfg = dataclasses.replace(cfg, slot_capacity=C)
        if not name.endswith("_off"):
            cfg = dataclasses.replace(cfg, batch_solve_capacity=Cs)
    elif name == "owners":
        cfg = dataclasses.replace(cfg, batch_uniform_topology=False)
    elif name == "sleep":
        cfg = dataclasses.replace(cfg, sleep_velocity=cs.SLEEP_VELOCITY,
                                  sleep_frames=cs.SLEEP_FRAMES)
        frames = cs.SLEEP_RUN
    return w, cfg, frames


def run_phases(names, dev) -> dict:
    """``{phase: digest}`` of the K4 phases in ``names``."""
    from starframe_tpu_torch import parallel

    cs = _smoke()
    out = {}
    for name in names:
        w, cfg, frames = phase(cs, name, dev)
        final, traj, _ = parallel.batched_rollout(
            w, cfg, 0, frames, record=lambda _: None,
            with_keys=name == "events")
        out[name] = (keys_digest(final, traj[1]) if name == "events"
                     else digest(final))
        print(f"digest {name} {out[name]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=HERE,
                    help="the checkout whose package runs (default: this one)")
    ap.add_argument("--phases", nargs="+", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("frame2_digests: needs a CUDA device", file=sys.stderr)
        return 2
    import starframe_tpu_torch
    from starframe_tpu_torch.hopper import _build

    pkg = os.path.dirname(os.path.abspath(starframe_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"frame2_digests: imported {pkg}, not {root}", file=sys.stderr)
        return 2
    _build.library()
    digests = run_phases(args.phases, torch.device("cuda", 0))
    line = json.dumps({"root": root, "digests": digests})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
