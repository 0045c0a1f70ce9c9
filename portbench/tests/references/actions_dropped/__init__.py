"""``reference/`` with one planted fault: its capture of a call drops the
actions a control wrote (the motors' ``motor_speed`` and ``motor_max``),
so its reference runs the scene's motors where the program ran the
call's. A cell with a control that names it is not correct."""

from reference import config, frame, world
from reference import world_state as _world_state
from reference.joints import STATE

__all__ = ["actions", "config", "frame", "world", "world_state"]


def actions(program_world) -> dict:
    """None of the call's actions."""
    return {}


def world_state(program_world) -> dict:
    """The call's input state without its actions."""
    return {k: v for k, v in _world_state(program_world).items()
            if k not in STATE}
