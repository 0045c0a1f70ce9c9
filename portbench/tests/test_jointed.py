"""``correct`` on jointed, layer-filtered worlds whose motor actions change
every call, on the CPU at 4 worlds (``jointed_cell.py``, episodes of 12
one-frame calls from frame 20, where the foot has landed): a sound run
passes; the program's call with one joint turned off, with every collider
back on layer 0 with mask -1, or with the control's actions dropped fails,
and so does the reference in bfloat16 in the program's place. The
reference's answer on ``batched_rl`` is pinned: a world with no joints,
layers, densities or control runs the operations it always ran."""

import dataclasses
import hashlib
import json

import pytest
import torch

from harness import cells, check
from reference import frame as ref_frame
from reference import world as ref_world
import jointed_cell
from test_correct import SEED, run_small

# the reference's answer on batched_rl at 4 worlds (below), taken before
# the reference took joints
BATCHED_RL_DIGEST = (
    "7021bbe04cd0a5f471fa88fbdac612c85fc9948e36ee08b087574738ebb6f37e")


def small():
    cell = jointed_cell.cell(4)
    cell.traffic.update(start_frame=20, episode_frames=12, check_calls=4)
    return cell


def run_jointed(monkeypatch, call=None, hook=None):
    return run_small(small(), call=call, hook=hook, monkeypatch=monkeypatch,
                     seconds=2.0)


def test_sound_run_is_correct(monkeypatch):
    res = run_jointed(monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["samples"][0] >= 2


def _with_joints(world, **fields):
    return dataclasses.replace(world, joints=dataclasses.replace(
        world.joints, **fields))


def hip_pin_off(real):
    def call(world, cfg, n):
        jtype = world.joints.jtype.clone()
        jtype[..., 0] = 0
        return real(_with_joints(world, jtype=jtype), cfg, n)
    return call


def one_layer(real):
    def call(world, cfg, n):
        c = world.colliders
        c = dataclasses.replace(c, layer=torch.zeros_like(c.layer),
                                mask=torch.full_like(c.mask, -1))
        return real(dataclasses.replace(world, colliders=c), cfg, n)
    return call


def control_dropped(real):
    """The scene's own motor parameters in place of the call's actions."""
    cell = small()
    scene = cell.scene.program(cell.config["scene_args"], SEED % (1 << 63),
                               "cpu").joints

    def call(world, cfg, n):
        return real(_with_joints(world, motor_speed=scene.motor_speed,
                                 motor_max=scene.motor_max), cfg, n)
    return call


@pytest.mark.parametrize("fault", [hip_pin_off, one_layer, control_dropped])
def test_fault_is_not_correct(fault, monkeypatch):
    res = run_jointed(monkeypatch, call=fault(small().entry.call))
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(monkeypatch):
    """The reference in bfloat16 in the program's place fails a limit."""
    cell = small()

    def control(samples):
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

    res = run_jointed(monkeypatch, hook=control)
    assert not res["correct"], res["checks"]


def test_reference_counts_joint_rows():
    """``joints`` counts the rows solved a frame, ``max_joint_rows`` the
    most on one body (the thigh: the hip's three and the knee's three)."""
    cell = small()
    geom, st = ref_world.build(cell.scene.describe(
        cell.config["scene_args"], SEED % (1 << 63)), "cpu")
    rcfg = check.reference_config(cell.config["solver"], cell.config["entry"])
    rcfg["gravity"] = tuple(cell.config["gravity"])
    stats = {}
    ref_frame.rollout(geom, st, rcfg, 2, stats)
    assert stats["frames"] == 2
    assert stats["joints"] == 2 * 4 * 6
    assert stats["max_joint_rows"] == 6
    assert cell.entry.implied(stats, cell.config["solver"]) == []
    tight = dict(cell.config["solver"], joint_slot_capacity=5)
    assert cell.entry.implied(stats, tight) == ["joint_overflow"]


def test_batched_rl_reference_is_the_parents():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert batched_rl_digest() == BATCHED_RL_DIGEST
    finally:
        torch.set_num_threads(threads)


def batched_rl_digest() -> str:
    """sha256 of the reference's state after 40 frames of ``batched_rl``
    from spawn at 4 worlds, of one 4-frame checked call from there, and of
    their counts."""
    cell = cells.resolve("batched_rl.step4")
    cell.config["scene_args"]["n_worlds"] = 4
    desc = cell.scene.describe(cell.config["scene_args"], SEED % (1 << 63))
    geom, st = ref_world.build(desc, "cpu")
    rcfg = check.reference_config(cell.config["solver"], cell.config["entry"])
    rcfg["gravity"] = tuple(cell.config["gravity"])
    stats = {}
    mid = ref_frame.rollout(geom, st, rcfg, 40, stats)
    outs, counts = check.reference_outputs(geom, rcfg, [{"in": mid}], 4)
    h = hashlib.sha256()
    for state in (mid, outs[0]):
        for k in sorted(state):
            h.update(k.encode())
            h.update(state[k].contiguous().numpy().tobytes())
    h.update(json.dumps([stats, counts], sort_keys=True).encode())
    return h.hexdigest()
