#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA devices the
cell asks for (without them it exits 2 and prints no result). Set-up
builds the cell's scene from ``--seed`` on the card, settles it as the
traffic says, and runs one whole episode as the window will, its answers
dropped; the window then runs episodes of calls for ``--seconds``
(``harness/window.py``). With ``--trace 1`` the
window's first episodes run under ``torch.profiler`` and the result holds
the cell's per-layer metrics, else its end-to-end metrics. After the window
the cell's plain reference package (``reference/`` unless its
configuration names another) recomputes the sampled calls and decides
``correct`` (``harness/check.py``).

The last line of standard output is the result's JSON object; the last
lines of standard error are the compared numbers with their limits. A run
whose process holds JAX or the JAX package once the window has closed
exits 3 and prints no result, naming what it found.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# the CUDA driver's kernel cache stays inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(BENCH / "_cache" / "nv"))

from harness import cells, check, window  # noqa: E402


def card_name(device) -> tuple:
    """``(kind, power limit)`` of the card."""
    import torch

    kind = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(torch.device(device).index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return kind, limit


def built_s():
    """Seconds this process spent building the program's kernels, or None
    where it loaded a library its checkout already held."""
    from starframe_tpu_torch.hopper import _build

    return _build.build_seconds


def seed_positions(seed: int, per_episode: int, n: int) -> list:
    """The episode positions whose calls are checked: the first call, and
    ``n - 1`` more drawn from the seed."""
    rng = random.Random(seed)
    rest = rng.sample(range(1, per_episode), min(n - 1, per_episode - 1))
    return sorted([0] + rest)


def count_episode(cell, start, cfg, call, geom, rcfg, device,
                  seed: int) -> dict:
    """The problem's work over one episode, for the roofline counts: the
    program replays the episode (untimed), with the control's actions; the
    cell's reference runs each call's frames from the call's input state
    and counts candidate, active and solved pairs and solved joint rows a
    frame (its ``frame.rollout``'s ``stats``)."""
    F = cell.traffic["frames_per_call"]
    world = window.clone_world(start)
    stats = {}
    calls = cell.traffic["episode_frames"] // F
    for k in range(calls):
        world = window.act(cell, world, seed, k)
        inp = check.world_state(world, cell.reference)
        world, _ = call(world, cfg, F)
        cell.reference.frame.rollout(geom, inp, rcfg, F, stats)
    window.sync(device)
    stats["calls"] = calls
    return stats


def reduce_trace(traced) -> dict:
    """The traced episodes' device and host events, reduced."""
    from harness import trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        traced["prof"].export_chrome_trace(path)
        events = trace.load_events(path)
    dev = trace.device_events(events)
    host = trace.host_events(events)
    calls = [h for h in host if h[0] == "portbench.call"]
    resets = [h for h in host if h[0] == "portbench.reset"]
    marks = calls + resets
    t0 = min(h[1] for h in marks)
    t1 = max(h[2] for h in marks)
    dev = trace.device_events(events, t0, t1)
    return dict(dev=dev, host=host, t0_us=t0, t1_us=t1,
                window_s=(t1 - t0) * 1e-6, busy_s=trace.busy_us(dev) * 1e-6,
                frames=traced["frames"], calls=traced["calls"],
                episodes=traced["episodes"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    found = jax_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


# JAX and the JAX package the port was made from: no run may load them
JAX = ("jax", "jaxlib", "flax", "starframe_tpu")


def jax_modules() -> list:
    """The names of ``JAX`` that are the top-level name of a module in
    ``sys.modules`` (``starframe_tpu_torch`` is not ``starframe_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(JAX))


def json_number(v):
    """``v``, or its name where JSON has no number for it (NaN, an
    infinity)."""
    return v if v is None or math.isfinite(v) else repr(v)


def emit(result: dict, checks: dict) -> None:
    """The kernel build and the compared numbers on standard error, then
    the result's line."""
    b = result["setup"]
    print(f"setup: built {b['built']} in {b['build_s']!r} s; without the "
          f"build {b['without_build_s']!r} s", file=sys.stderr)
    for name, row in checks.items():
        limit = json.dumps(row["limit"])
        print(f"check {name}: {row['value']!r} limit {limit}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, call=None, answer_hook=None):
    """One run of ``cell``. Returns ``(result, checks)``. ``call``
    replaces the entry's call (the harness's own tests plant faults with
    it) and ``answer_hook(samples)`` may alter the sampled answers."""
    import torch

    cuda = torch.device(device).type == "cuda"
    cfg = cells.solver_config(cell.config)
    call = call or cell.entry.call
    seed = seed % (1 << 63)
    t_scene = time.perf_counter()
    start, settle_flagged = window.set_up(cell, seed, device, cfg, call)
    start = window.clone_world(start)
    window.sync(device)
    F = cell.traffic["frames_per_call"]
    per_episode = cell.traffic["episode_frames"] // F
    positions = seed_positions(seed, per_episode,
                               cell.traffic["check_calls"])
    t_warm = time.perf_counter()
    flagged = window.warm_up(cell, start, cfg, call, positions, device, seed)
    positions = sorted(set(positions) | flagged)
    window.sync(device)
    setup_s = time.perf_counter() - t_start
    build_s = built_s()
    # where set-up went: imports and the card's start, the scene and its
    # settling calls, the warm-up episode (with the kernel build or load)
    phases = dict(start_s=t_scene - t_start, scene_s=t_warm - t_scene,
                  warm_s=t_start + setup_s - t_warm)

    win = window.run(cell, start, cfg, call, seconds, positions, device, seed,
                     profile_episodes=(cell.traffic["trace_episodes"]
                                       if trace_on else 0))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    active = int((start.bodies.flags & 1).ne(0).sum())

    ref = cell.reference
    rcfg = check.reference_config(cell.config["solver"], cell.config["entry"],
                                  ref)
    rcfg["gravity"] = tuple(cell.config["gravity"])
    desc = cell.scene.describe(cell.config["scene_args"], seed)
    geom, _ = ref.world.build(desc, device)
    traced = counts = None
    if trace_on:
        traced = reduce_trace(win.traced)
        win.traced = None
        counts = count_episode(cell, start, cfg, call, geom, rcfg, device,
                               seed)
    del start
    if cuda:
        torch.cuda.empty_cache()

    samples = win.samples
    if answer_hook is not None:
        answer_hook(samples)
    refs, first = check.reference_outputs(geom, rcfg, samples, F,
                                          reference=ref)
    dynamic = geom["invm"] > 0
    values = check.compare(samples, refs, [s["out"] for s in samples],
                           dynamic)
    values["frames_gap"] = check.frames_gap(samples, F)
    values["counter_misses"] = check.counter_misses(
        samples, first, cell.entry.implied, cell.config["solver"])
    values["flagged_unchecked"] = check.flagged_unchecked(win.flagged,
                                                          samples)
    correct, rows = check.verdict(values, cell.limits)
    del refs, geom

    ctx = SimpleNamespace(
        cell=cell, window=win, active_bodies=active,
        setup_s=setup_s, trace=traced, counts=counts,
        shapes=ref.world.shapes(desc))
    metrics = {}
    wanted = cell.per_layer if trace_on else cell.end_to_end
    for m in wanted:
        v = cells.metric_reader(m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    kind, limit = card_name(device) if cuda else ("cpu", "none")
    dev = dict(platform="gpu" if cuda else "cpu", kind=kind, count=1,
               memory_peak_bytes=int(peak), power_limit=limit)
    result = dict(correct=bool(correct), attempted=len(win.walls_s),
                  failed=sum(win.failed), metrics=metrics, device=dev)
    if traced is not None:
        from harness import trace

        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = dict(
            device_ops=trace.top(trace.device_by_label(traced["dev"])),
            idle_gaps=trace.top(trace.idle_gaps(
                traced["dev"], traced["host"], traced["t0_us"],
                traced["t1_us"])))
    result["settle_flagged"] = settle_flagged
    # the run that builds the kernels is told apart: setup_s with and
    # without the build, and its phases
    result["setup"] = dict(built=build_s is not None, build_s=build_s or 0.0,
                           without_build_s=setup_s - (build_s or 0.0),
                           **phases)
    # calls that flagged a hard counter, the episode positions they ran at,
    # and how many of those positions the check held to the reference
    result["flagged"] = dict(
        calls=sum(win.flagged_calls), positions=len(win.flagged),
        checked=sum(s["pos"] in win.flagged for s in samples))
    result["checks"] = {k: [json_number(v["value"]), v["limit"]]
                        for k, v in rows.items()}
    return result, rows


if __name__ == "__main__":
    sys.exit(main())
