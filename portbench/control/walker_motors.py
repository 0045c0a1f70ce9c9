"""Control ``walker_motors``: BipedalWalker-v3's env step. Each call, every
world gets 4 fresh actions ``a`` in [-1, 1), one a motor in the scene's
action order (``scenes/bipedal_walker.py``'s ``ACTION_MOTORS`` and
``ACTION_HIP``): a hip motor's target speed becomes ``SPEED_HIP *
sign(a)``, a knee's ``SPEED_KNEE * sign(a)``, and each torque budget
``MOTORS_TORQUE * |a|``, as the source's ``step`` sets ``motorSpeed`` and
``maxMotorTorque``. The actions are drawn on the world's device by a
generator seeded from the run's seed and the call's episode position, one
row a world: every episode repeats them."""

from __future__ import annotations

import dataclasses

import torch

from harness import cells

SPEED_HIP = 4.0  # rad/s
SPEED_KNEE = 6.0
MOTORS_TORQUE = 80.0  # N m
GOLDEN = 0x9E3779B97F4A7C15

_scene = cells.load_module(cells.BENCH / "scenes" / "bipedal_walker.py")
MOTORS = _scene.ACTION_MOTORS
SPEEDS = tuple(SPEED_HIP if hip else SPEED_KNEE for hip in _scene.ACTION_HIP)
_tables = {}


def actions(W: int, device, seed: int, pos: int):
    """``[W, 4]`` actions in [-1, 1) of the call at episode position
    ``pos``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * GOLDEN + pos) % (1 << 64))
    return 2.0 * torch.rand((W, len(MOTORS)), generator=g,
                            device=device) - 1.0


def _table(J: int, device):
    """``(action [J] long, driven [J] bool, speed [J])``: each joint's
    action column (0 where none drives it), whether one does, and its
    target speed at ``a = 1``; made once a device."""
    key = (J, str(device))
    if key not in _tables:
        col = [0] * J
        speed = [0.0] * J
        for k, (m, s) in enumerate(zip(MOTORS, SPEEDS)):
            col[m], speed[m] = k, s
        driven = [j in MOTORS for j in range(J)]
        _tables[key] = (torch.tensor(col, device=device),
                        torch.tensor(driven, device=device),
                        torch.tensor(speed, device=device))
    return _tables[key]


def apply(world, seed: int, pos: int):
    """``world`` with the call's actions in its motors."""
    j = world.joints
    W, J = j.jtype.shape
    col, driven, speed = _table(J, j.jtype.device)
    a = actions(W, j.jtype.device, seed, pos).index_select(1, col)
    return dataclasses.replace(world, joints=dataclasses.replace(
        j, motor_speed=torch.where(driven, speed * torch.sign(a),
                                   j.motor_speed),
        motor_max=torch.where(driven, MOTORS_TORQUE * torch.abs(a),
                              j.motor_max)))
