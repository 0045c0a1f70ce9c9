"""Set-up and the measured window: a closed loop of one client.

Set-up builds the scene from the seed, runs the traffic's settling calls,
keeps the episode's start state, and runs one episode as the window will
(``warm_up``). The window
then runs episodes back to back until ``seconds`` have passed: each episode
restores the start state (a device copy, inside the window) and makes its
calls. Where the traffic names a control, each call starts by writing its
actions into the world (``Cell.control``; an env step sets its action, so
inside the call's wall), as every call of set-up does too. Each call is
ended by ``torch.cuda.synchronize()`` and one read of its hard
counters and of whether its answer is finite. A call whose answer holds a
position or angle that is not finite has failed. A call with a hard
counter above 0 is flagged: the program says a contact or joint may have
gone unsolved, so its answer is held to the reference. The calls at the
episode positions drawn for the check keep their input and answer, and so
does every position whose call flagged: every episode runs the same calls
from the same start, so the positions that flagged in the warm-up episode
are kept from the window's first, any other that flags in the next, and
the check holds each flagged position to the reference. Inputs, actions and
answers are captured by the cell's reference package (``Cell.reference``)."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from . import check


def clone_world(world):
    """A copy of ``world`` whose dynamic state owns its memory."""
    b = world.bodies
    bodies = dataclasses.replace(b, **{
        f.name: getattr(b, f.name).clone() for f in dataclasses.fields(b)})
    return dataclasses.replace(world, bodies=bodies,
                               step_count=world.step_count.clone())


def read_call(world, diag: dict, hard_keys) -> tuple:
    """``(hard counters, finite)`` of a call, read on the host in one
    transfer: its hard counters, and whether the sum of its answer's
    positions and angles is finite (a NaN or an infinity anywhere makes
    it not)."""
    keys = [k for k in hard_keys if k in diag]
    b = world.bodies
    finite = torch.isfinite(b.pos.sum() + b.angle.sum()).to(torch.int64)
    vals = torch.stack([diag[k].reshape(()).to(torch.int64) for k in keys]
                       + [finite.reshape(())]).tolist()
    return dict(zip(keys, vals[:-1])), bool(vals[-1])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    walls_s: list  # each call's wall time, call to synchronize
    failed: list  # each call: its answer not finite
    flagged_calls: list  # each call: a hard counter above 0
    frames: list  # each call's frames
    window_s: float
    episodes: int
    samples: list  # {"pos", "in", "out", "hard"} of the checked calls
    flagged: set  # the episode positions whose call flagged in the window
    traced: dict | None = None  # the profiled episodes (trace runs)


def act(cell, world, seed: int, pos: int):
    """``world`` with the actions of the call at episode position ``pos``
    (the traffic's control), or as it is where the traffic has none."""
    if cell.control is None:
        return world
    return cell.control.apply(world, seed, pos)


def set_up(cell, seed: int, device, cfg, call):
    """``(start world, settle calls flagged)``: the scene, settled by the
    traffic's ``start_frame`` frames in calls of its length (the settling
    calls take the positions before the episode's, -S to -1)."""
    world = cell.scene.program(cell.config["scene_args"], seed, device)
    F = cell.traffic["frames_per_call"]
    bad = 0
    settle = cell.traffic["start_frame"] // F
    for k in range(settle):
        world = act(cell, world, seed, k - settle)
        world, diag = call(world, cfg, F)
        hard, _ = read_call(world, diag, cell.entry.HARD)
        bad += int(any(v > 0 for v in hard.values()))
    sync(device)
    return world, bad


def warm_up(cell, start, cfg, call, positions, device, seed: int) -> set:
    """One whole episode as the window runs it, its answers dropped, so
    that every shape and every allocation the window's episodes make is
    made in set-up. Returns the positions whose call flagged, for the
    window to keep from its first episode."""
    return run(cell, start, cfg, call, math.inf, positions, device, seed,
               episodes=1).flagged


def run(cell, start, cfg, call, seconds: float, positions, device,
        seed: int, profile_episodes: int = 0,
        episodes: int | None = None) -> Window:
    """The measured window (see the module's docstring), or its first
    ``episodes`` whole episodes, the control's actions drawn from
    ``seed``. With ``profile_episodes`` the first that
    many episodes run under ``torch.profiler``; ``Window.traced`` then
    holds the profiler and the traced calls' count and frames."""
    limit = episodes
    F = cell.traffic["frames_per_call"]
    per_episode = cell.traffic["episode_frames"] // F
    positions = set(positions)
    flagged = set()  # flagged positions, each kept once in a later episode
    walls, failed, flagged_calls, frames, samples = [], [], [], [], {}
    prof = traced = None
    mark = contextlib.nullcontext
    if profile_episodes:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof, mark = profile(activities=acts), record_function
    episodes = 0
    t0 = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    while limit is None or episodes < limit:
        if prof is not None and episodes == profile_episodes:
            prof.__exit__(None, None, None)
            traced = dict(prof=prof, calls=len(walls), frames=sum(frames),
                          episodes=episodes)
            prof, mark = None, contextlib.nullcontext
        with mark("portbench.reset"):
            world = clone_world(start)
        episodes += 1
        for k in range(per_episode):
            keep = k in positions or (k in flagged and k not in samples)
            if keep:
                inp = check.world_state(world, cell.reference)
            tc = time.perf_counter()
            with mark("portbench.call"):
                sent = world = act(cell, world, seed, k)
                world, diag = call(world, cfg, F)
                sync(device)
            walls.append(time.perf_counter() - tc)
            hard, finite = read_call(world, diag, cell.entry.HARD)
            failed.append(not finite)
            flagged_calls.append(any(v > 0 for v in hard.values()))
            if flagged_calls[-1]:
                flagged.add(k)
            frames.append(F)
            if keep:
                # the actions it ran with
                inp.update(check.joint_state(sent, cell.reference))
                samples[k] = dict(pos=k, **{"in": inp},
                                  out=check.world_state(world, cell.reference),
                                  hard=hard)
            # the traced episodes always run whole
            if prof is None and time.perf_counter() - t0 >= seconds:
                break
        else:
            continue
        break
    window_s = time.perf_counter() - t0
    return Window(walls, failed, flagged_calls, frames, window_s, episodes,
                  [samples[k] for k in sorted(samples)], flagged, traced)
