#!/usr/bin/env python3
"""K5-K10, every form, alone, for one or more checkouts, in turns on one
card.

    python3 tools/tile_substep_times.py ROOT [ROOT ...] [--rounds 2]
        [--reps 20]

The first root (e.g. the parent, unpacked with ``git archive`` into
``_checkouts/``) builds the inputs once, in a process of its own, and saves
them to a temporary file: the frame's arguments (``chip_smoke.
frame_inputs``: layout, tables, solve tables, live tiles) and K6's
(``chip_smoke.manifold_inputs``) at four states, the awake pile
(``pile(10_000, sleep=False)``, C = 16, Cs = 8) after 240 frames, the
sleeping pile (bench.py's ``pile``: ``pile(10_000)``) after 1680 and
``pile_compound(10_000)`` (C = 24, Cs = 8) after 240 and 1680 frames (the
compound pile's final state, 79 tiles), printing at each the share of K6's
(row, table slot) items with ``act > 0`` and of its warps that are empty.
Then every root, each in a process of its own and in turns (ABBA for two,
``--rounds`` times: ``tools/frame2_times.py`` ``run_turns``), runs on
those same inputs: K5 (``build_tile_tables`` on the frame's layout, its
window edges and the scene's table width) at ``sweep_frames`` 1 and 8;
K6 (``tile_manifold``) plain and keyed, compacted and at Cs = C; K8
(``tile_project``) and its CCD form; K9 (``tile_apply``), its CCD form,
its compound form and the compound CCD form; K7 and the
owner kernels; K10 (``tile_frame``) plain and CCD; and one compound frame
(``tile_frame`` with ``owner`` where the root has it, else
``substep_loop`` over the owner kernels, which is the same computation),
with and without CCD; each at every phase. The CCD forms take every
dynamic row as a bullet, and the owner kernels the layout's owner column
(on the awake pile, one row a body).

Each entry prints four times (ms): ``ms``, CUDA events around ``--reps``
wrapper calls (host dispatch included, as ``chip_smoke.turns``); ``raw``,
CUDA events around ``--reps`` replays of the launch the wrapper made (its
argument struct built once, ``_build.launch`` only: bounded by the host's
launch rate where the kernel is shorter); ``dev``, the same replays
captured in a CUDA graph and the graph's replay timed (a single-launch
entry only for both; the cooperative whole-frame kernels are not timed in
a graph, their ``dev`` is ``raw``: each runs far longer than a launch
takes); ``prof``, the kernels' own time in a ``torch.profiler`` trace of
``--reps`` wrapper calls. And a SHA-256 of every output, so the roots'
results can be compared bitwise: the tool prints which entries are equal
across roots, and a JSON summary last. Each cooperative launch is also
captured in a CUDA graph and replayed ``GRAPH_REPLAYS`` times:
``direct_equal`` and ``graph_equal`` say whether the outputs' hash after
the direct replays and after the graph's equals the first call's, and the
run fails where one does not. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import inspect
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cooperative launches (the whole-frame kernels): timed by replaying
# the launch alone, not in a CUDA graph
COOPERATIVE = ("sf_tile_frame", "sf_tile_compound_frame")
# replays of each cooperative launch from a CUDA graph, outputs held
# against the direct launch's
GRAPH_REPLAYS = 100
# phase -> (scene, frames from the start)
PHASES = {"pile": ("pile", 240), "pile_sleep_1680": ("pile_sleep", 1680),
          "compound_240": ("compound", 240),
          "compound_1680": ("compound", 1680)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_scenes", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _use_root(root: str):
    sys.path.insert(0, root)
    import starframe_tpu_torch

    pkg = os.path.dirname(os.path.abspath(starframe_tpu_torch.__file__))
    assert os.path.dirname(pkg) == root, (pkg, root)


def make_states(root: str, out: str) -> int:
    """Roll each phase's scene out with the package of ``root`` and save
    its frame arguments to ``out``."""
    _use_root(root)
    import torch
    from starframe_tpu_torch import hopper, scenes, tiled

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    saved = {}
    for name, (scene, frames) in PHASES.items():
        if scene in ("pile", "pile_sleep"):
            sc = scenes.pile(n_bodies=10_000, sleep=scene == "pile_sleep",
                             device=dev)
        else:
            sc = scenes.pile_compound(n_bodies=10_000, device=dev)
        w, _ = tiled.tiled_rollout(sc.world, sc.config, frames)
        args, kw = cs.frame_inputs(hopper, tiled, w, sc.config)
        margs, mkw, keyed = cs.manifold_inputs(hopper, tiled, w, sc.config)
        items, warps = cs.manifold_skips(*margs[4:6])
        print(f"{name}: K6 at C = {margs[3].shape[1]}, Cs = {mkw['Cs']}: "
              f"{100 * items:.2f}% of the live (row, table slot) items "
              f"have act > 0; {100 * warps:.2f}% of its warps are empty, "
              "skipped whole under compaction",
              flush=True)
        cfg = sc.config
        tkw = dict(C=tiled._table_cap(cfg), margin=cfg.contact_margin,
                   dt=cfg.dt, sort_axis=0 if cfg.tile_sort_axis == "x" else 1,
                   sweep_slack=cfg.broadphase_speed_slack,
                   sweep_floor=cfg.tile_sweep_floor,
                   sweep_cap=cfg.tile_sweep_cap)
        saved[name] = dict(args=args, kw=kw, margs=margs, mkw=mkw,
                           keyed=keyed, tkw=tkw,
                           kc=cfg.max_colliders_per_body,
                           ccd_slop=cfg.ccd_slop)
    torch.save(saved, out)
    return 0


def _entries(hopper, ph):
    """``{name: call}`` of one phase, every form at every phase: each call
    returns its outputs."""
    import torch

    args, kw, kc = ph["args"], ph["kw"], ph["kc"]
    state, consts, large, pidx_c, sol, g, live = args
    h, slop = kw["h"], ph["ccd_slop"]
    ob = consts["obody"].reshape(-1)
    bconsts = dict(consts, blt=(consts["invm"] > 0).float())
    bargs = (state, bconsts) + args[2:]
    touched = torch.zeros(pidx_c.shape, device=g.device)
    pkw = dict(h=h, compliance=kw["compliance"])
    akw = {k: v for k, v in kw.items() if k not in ("substeps", "compliance")}
    f = hopper.owner_min([hopper.tile_ccd(*bargs, h=h, ccd_slop=slop)], ob,
                         kc)[0]
    proj = hopper.tile_project(*args[:6], touched, live, **pkw)
    proj_c = hopper.tile_project(*bargs[:6], touched, live, **pkw, f=f)
    osum = hopper.owner_sum(proj[:4], ob, kc)
    osum_c = hopper.owner_sum(proj_c[:4], ob, kc)
    new, accv = hopper.tile_apply(state, osum, consts, large, pidx_c, sol,
                                  proj[4], g, live, **akw, compound=True)
    vkw = dict(h=h, lin_damp=kw["lin_damp"], ang_damp=kw["ang_damp"])

    def apply(p, c, corr, **more):
        return lambda: hopper.tile_apply(state, corr, c, large, pidx_c, sol,
                                         p[4], g, live, **akw, **more)

    margs, mkw, keyed = ph["margs"], ph["mkw"], ph["keyed"]
    full = dict(mkw, Cs=margs[3].shape[1])  # no compaction: Cs = C
    targs = (state, consts, large, consts["edge_lo"], consts["edge_hi"], g)
    e = {"K5": lambda: hopper.build_tile_tables(*targs, **ph["tkw"],
                                                sweep_frames=1),
         "K5_sweep8": lambda: hopper.build_tile_tables(*targs, **ph["tkw"],
                                                       sweep_frames=8),
         "K6": lambda: hopper.tile_manifold(*margs, **mkw),
         "K6_keys": lambda: hopper.tile_manifold(*margs, **mkw, **keyed),
         "K6_full": lambda: hopper.tile_manifold(*margs, **full),
         "K6_full_keys": lambda: hopper.tile_manifold(*margs, **full,
                                                      **keyed),
         "K7": lambda: hopper.tile_ccd(*bargs, h=h, ccd_slop=slop),
         "K8": lambda: hopper.tile_project(*args[:6], touched, live, **pkw),
         "K8_ccd": lambda: hopper.tile_project(*bargs[:6], touched, live,
                                               **pkw, f=f),
         "K9": apply(proj, consts, proj[:4]),
         "K9_ccd": apply(proj_c, bconsts, proj_c[:4], f=f),
         "K9_compound": apply(proj, consts, osum, compound=True),
         "K9_compound_ccd": apply(proj_c, bconsts, osum_c, compound=True,
                                  f=f),
         "owner_min": lambda: hopper.owner_min([f], ob, kc),
         "owner_sum": lambda: hopper.owner_sum(proj[:4], ob, kc),
         "owner_velocity": lambda: hopper.owner_velocity(new, accv, ob, kc,
                                                         **vkw),
         "K10": lambda: hopper.tile_frame(*args, **kw),
         "K10_ccd": lambda: hopper.tile_frame(*bargs, **kw, ccd=True,
                                              ccd_slop=slop)}
    fused = "owner" in inspect.signature(hopper.tile_frame).parameters
    for ccd in (False, True):
        a = bargs if ccd else args
        if fused:
            ckw = dict(kw, ccd=True, ccd_slop=slop) if ccd else kw
            call = functools.partial(hopper.tile_frame, *a, **ckw,
                                     owner=(ob, kc))
        else:  # the same substeps as the per-substep launches
            toi = (hopper.tile_ccd, hopper.owner_min, slop) if ccd else None
            call = functools.partial(
                hopper.tiles.substep_loop, hopper.tile_project,
                hopper.tile_apply, *a, **kw, ccd=toi,
                owner=(hopper.owner_sum, hopper.owner_velocity, ob, kc))
        e["compound_frame" + ("_ccd" if ccd else "")] = call
    return e


def _tensors(x):
    """Every tensor of ``x`` (nested in tuples, lists, dicts), in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _kernel_ms(prof, reps: int) -> float:
    """The kernels' own device time a call in a profiler trace."""
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        name = ev.key
        if "tile_" in name or "owner_" in name:
            total += us
    return total / 1e3 / reps


def _sha(res) -> str:
    """SHA-256 of every tensor of ``res``, in order."""
    h = hashlib.sha256()
    for t in _tensors(res):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def child(root: str, states: str, reps: int) -> int:
    """Time every entry with the package of ``root`` on the saved inputs;
    print JSON. Each cooperative launch is also captured in a CUDA graph
    and replayed ``GRAPH_REPLAYS`` times; the outputs' hash after the direct
    replays and after the graph's must equal the first call's (else exit
    1)."""
    _use_root(root)
    import torch
    from starframe_tpu_torch import hopper
    from starframe_tpu_torch.hopper import _build

    saved = torch.load(states, map_location="cuda", weights_only=False)
    out, unequal = {}, []
    for phase, ph in saved.items():
        for name, call in _entries(hopper, ph).items():
            print(f"{phase}/{name}", file=sys.stderr, flush=True)
            launches = []
            orig = _build.launch

            def record(n, a, d, orig=orig):
                launches.append((n, a, d))
                orig(n, a, d)

            _build.launch = record
            try:
                res = call()
            finally:
                _build.launch = orig
            torch.cuda.synchronize()
            sha = _sha(res)
            call()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(reps):
                call()
            t1.record()
            torch.cuda.synchronize()
            row = {"ms": t0.elapsed_time(t1) / reps, "sha256": sha,
                   "launches": len(launches)}
            if len(launches) == 1:  # replay the one launch, struct built
                n, a, d = launches[0]
                t0.record()
                for _ in range(reps):
                    orig(n, a, d)
                t1.record()
                torch.cuda.synchronize()
                row["raw"] = t0.elapsed_time(t1) / reps
                if n in COOPERATIVE:  # far longer than a launch's host time
                    row["dev"] = row["raw"]
                    row["direct_equal"] = _sha(res) == sha
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        orig(n, a, d)
                    for _ in range(GRAPH_REPLAYS):
                        graph.replay()
                    torch.cuda.synchronize()
                    row["graph_equal"] = _sha(res) == sha
                    del graph
                    if not (row["direct_equal"] and row["graph_equal"]):
                        unequal.append(f"{phase}/{name}")
                else:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        for _ in range(reps):
                            orig(n, a, d)
                    graph.replay()
                    t0.record()
                    graph.replay()
                    t1.record()
                    torch.cuda.synchronize()
                    row["dev"] = t0.elapsed_time(t1) / reps
                    del graph
            act = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            row["prof"] = _kernel_ms(prof, reps)
            out[f"{phase}/{name}"] = row
            del res
        torch.cuda.empty_cache()
    print(json.dumps(out))
    if unequal:
        print(f"replayed outputs differ from the first call's: {unequal}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--states", help=argparse.SUPPRESS)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--make-states", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.make_states:
        return make_states(roots[0], args.states)
    if args.child:
        return child(roots[0], args.states, args.reps)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("tile_substep_times.py: needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "_frame2_times", os.path.join(HERE, "tools", "frame2_times.py"))
    times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(times)
    with tempfile.TemporaryDirectory() as tmp:
        states = os.path.join(tmp, "states.pt")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               roots[0], "--make-states", "--states", states])
        if proc.returncode != 0:
            return proc.returncode
        return times.run_turns(
            __file__, roots, args.rounds, args.reps,
            extra=["--states", states])


if __name__ == "__main__":
    sys.exit(main())
