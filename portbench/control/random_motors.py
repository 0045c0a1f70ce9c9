"""Control ``random_motors``: each call, every angular motor (joint type 4)
of every world gets a fresh action ``a`` in [-1, 1), which sets its target
speed to ``SPEED * sign(a)`` and its torque budget to ``TORQUE * |a|``, as
BipedalWalker-v3's env step maps an action onto a motor. The actions are
drawn on the world's device by a generator seeded from the run's seed and
the call's episode position, one row a world: every episode repeats them."""

from __future__ import annotations

import dataclasses

import torch

MOTOR = 4
SPEED = 4.0  # rad/s
TORQUE = 80.0  # N m
GOLDEN = 0x9E3779B97F4A7C15


def actions(shape, device, seed: int, pos: int):
    """``[W, J]`` actions in [-1, 1) of the call at episode position
    ``pos``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * GOLDEN + pos) % (1 << 64))
    return 2.0 * torch.rand(shape, generator=g, device=device) - 1.0


def apply(world, seed: int, pos: int):
    """``world`` with the call's actions in its motors."""
    j = world.joints
    a = actions(tuple(j.jtype.shape), j.jtype.device, seed, pos)
    motor = j.jtype == MOTOR
    return dataclasses.replace(world, joints=dataclasses.replace(
        j, motor_speed=torch.where(motor, SPEED * torch.sign(a),
                                   j.motor_speed),
        motor_max=torch.where(motor, TORQUE * torch.abs(a), j.motor_max)))
