"""``correct`` against the plain reference, on the CPU at a size a test
run holds: a sound run passes; the control (the reference in bfloat16 in
the program's place) and each fault a cell can have fail. The parked pile
cells (``parked.json``) are held to the same.

The faults are planted under the harness's call, past its look for a
card: a call that returns its state unchanged, a call that leaves half of
the batch (half of the worlds, or half of one world's bodies) unstepped,
and an answer altered where it is produced (one body moved by 100 m). One
chip means no exchange between chips to leave out."""

import dataclasses
import json
import time

import pytest
import torch

from harness import cells, check, window
import run

SEED = 4294967311


def small(name: str):
    """The cell at a CPU size: 4 worlds in episodes of 60 frames; the pile
    at 1,021 bodies, in episodes of two calls of the cell's 60 frames (the
    settled pile from frame 300, where most of this smaller pile
    sleeps)."""
    cell = cells.resolve(name, cells.benchmark(parked=True))
    if cell.config["scene"] == "batched_worlds":
        cell.config["scene_args"]["n_worlds"] = 4
        cell.traffic.update(episode_frames=60, check_calls=4)
    else:
        cell.config["scene_args"]["n_bodies"] = 1021
        cell.traffic.update(episode_frames=120,
                            start_frame=min(cell.traffic["start_frame"], 300))
    return cell


_SETTLED = {}


def _set_up_once(cell, seed, device, cfg, call):
    """``window.set_up``, the settled start kept across this file's runs
    (the faults are planted in the window's calls, after set-up)."""
    key = (cell.name, seed)
    if key not in _SETTLED:
        _SETTLED[key] = _set_up(cell, seed, device, cfg, cell.entry.call)
    world, bad = _SETTLED[key]
    return window.clone_world(world), bad


_set_up = window.set_up


def run_small(cell, call=None, hook=None, monkeypatch=None, seconds=1.0):
    torch.set_num_threads(4)
    if monkeypatch is not None:
        monkeypatch.setattr(window, "set_up", _set_up_once)
    res, rows = run.run_cell(cell, SEED, seconds, False, "cpu",
                             time.perf_counter(), call=call,
                             answer_hook=hook)
    return res


def _replace_state(world, pos, angle, vel, ang_vel):
    b = dataclasses.replace(world.bodies, pos=pos, angle=angle, vel=vel,
                            ang_vel=ang_vel)
    return dataclasses.replace(world, bodies=b)


def unchanged(real):
    def call(world, cfg, n):
        _, diag = real(world, cfg, n)
        return world, diag
    return call


def half_left_out(real):
    def call(world, cfg, n):
        out, diag = real(world, cfg, n)
        b, o = world.bodies, out.bodies
        # the leading axis: the batch's worlds, or one world's bodies
        late = torch.arange(b.pos.shape[0]) >= b.pos.shape[0] // 2

        def mix(new, old):
            return torch.where(late.view((-1,) + (1,) * (old.dim() - 1)),
                               old, new)

        return _replace_state(out, mix(o.pos, b.pos), mix(o.angle, b.angle),
                              mix(o.vel, b.vel),
                              mix(o.ang_vel, b.ang_vel)), diag
    return call


def altered(real):
    def call(world, cfg, n):
        out, diag = real(world, cfg, n)
        pos = out.bodies.pos.clone()
        pos.view(-1, pos.shape[-2], 2)[0, 3, 0] += 100.0  # first dynamic body
        return _replace_state(out, pos, out.bodies.angle, out.bodies.vel,
                              out.bodies.ang_vel), diag
    return call


CELLS = ["batched_rl.step4", "batched_rl.step1", "pile_10k.falling",
         "pile_10k.settled"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    res = run_small(small(name), monkeypatch=monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


# the settled pile barely moves (most bodies sleep): half of its bodies
# left unstepped shows only through the few awake ones, so that fault is
# held on the falling pile, which runs the same entry
FAULTS = [(c, f) for c in CELLS for f in (unchanged, half_left_out, altered)
          if not (c == "pile_10k.settled" and f is half_left_out)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = small(name)
    res = run_small(cell, call=fault(cell.entry.call),
                    monkeypatch=monkeypatch)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, monkeypatch):
    """The reference in bfloat16 in the program's place fails a limit."""
    cell = small(name)

    def control(samples):
        from reference import world as ref_world

        rcfg = check.reference_config(cell.config["solver"],
                                      cell.config["entry"])
        rcfg["gravity"] = tuple(cell.config["gravity"])
        geom, _ = ref_world.build(cell.scene.describe(
            cell.config["scene_args"], SEED % (1 << 63)), "cpu")
        low, _ = check.reference_outputs(
            geom, rcfg, samples, cell.traffic["frames_per_call"],
            dtype=torch.bfloat16)
        for s, out in zip(samples, low):
            s["out"] = dict({k: v.float() if v.is_floating_point() else v
                             for k, v in out.items()},
                            steps=s["out"]["steps"])

    res = run_small(cell, hook=control, monkeypatch=monkeypatch)
    assert not res["correct"], res["checks"]


def flags_at(real, frame: int, shift: float = 0.0):
    """The real call, with ``slot_overflow`` raised on the call that starts
    at step ``frame`` and its answer's first dynamic body moved by
    ``shift`` m."""
    def call(world, cfg, n):
        at = int(world.step_count.reshape(-1)[0]) == frame
        out, diag = real(world, cfg, n)
        if not at:
            return out, diag
        diag = dict(diag, slot_overflow=torch.tensor(1))
        pos = out.bodies.pos.clone()
        pos.view(-1, pos.shape[-2], 2)[0, 3, 0] += shift
        return _replace_state(out, pos, out.bodies.angle, out.bodies.vel,
                              out.bodies.ang_vel), diag
    return call


def short_episodes(name: str):
    """The cell at its CPU size in episodes of three calls, one of them
    drawn for the check (position 0), so the window runs several."""
    cell = small(name)
    F = cell.traffic["frames_per_call"]
    cell.traffic.update(episode_frames=3 * F, check_calls=1)
    return cell, F


@pytest.mark.parametrize("shift,correct", [(0.0, True), (100.0, False)],
                         ids=["sound", "altered"])
def test_failed_calls_are_each_checked(shift, correct, monkeypatch):
    """A call that flags a hard counter at a position the seed did not
    draw is kept in a later episode and held to the reference: sound, it
    passes; with its answer altered, the run is not correct. A flagged
    call returned an answer, so it has not failed."""
    cell, F = short_episodes("batched_rl.step4")
    res = run_small(cell, call=flags_at(cell.entry.call, 2 * F, shift),
                    monkeypatch=monkeypatch, seconds=4.0)
    assert res["failed"] == 0
    assert res["flagged"]["calls"] >= 1
    assert {k: res["flagged"][k] for k in ("positions", "checked")} == {
        "positions": 1, "checked": 1}
    assert res["checks"]["flagged_unchecked"][0] == 0
    assert res["correct"] is correct, res["checks"]


@pytest.mark.parametrize("bad", [float("nan"), float("inf")],
                         ids=["nan", "inf"])
def test_a_call_whose_answer_is_not_finite_has_failed(bad, monkeypatch):
    """A call whose answer holds a position that is not finite counts in
    ``failed``, and the run is not correct."""
    cell, F = short_episodes("batched_rl.step4")
    res = run_small(cell, call=flags_at(cell.entry.call, 0, bad),
                    monkeypatch=monkeypatch, seconds=1.0)
    assert res["failed"] >= 1
    assert not res["correct"], res["checks"]
    json.dumps(res, allow_nan=False)


def test_a_failed_call_left_unchecked_is_not_correct():
    samples = [dict(pos=0), dict(pos=5)]
    assert check.flagged_unchecked({5}, samples) == 0
    assert check.flagged_unchecked({5, 7}, samples) == 1
    verdict, _ = check.verdict({"flagged_unchecked": 1},
                               {"numbers": {"flagged_unchecked": {"max": 0}}})
    assert not verdict
