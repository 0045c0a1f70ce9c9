"""What the harness hands this reference of a configuration and of a call:
the frame settings from the configuration file's solver block, and a call's
input state and actions, captured from the program's world before the call
runs. Nothing here reads what the program computed: a captured state is
the one the call was handed."""

from __future__ import annotations

from . import joints as ref_joints


def config(solver: dict, entry_name: str) -> dict:
    """The reference's frame settings from the configuration file's
    solver block, with the entry's solve-slot compaction."""
    s = dict(solver)
    h = s["dt"] / s["substeps"]
    slots = 0
    if entry_name == "tiled_rollout":
        table = -(-s["slot_capacity"] // 8) * 8
        want = -(-s["tile_solve_capacity"] // 8) * 8
        if 0 < s["tile_solve_capacity"] and want < table:
            slots = want
    elif 0 < s.get("batch_solve_capacity", 0) < s["slot_capacity"]:
        raise NotImplementedError("the reference has no tiered solve ranking")
    return dict(
        dt=s["dt"], substeps=s["substeps"], iterations=s["iterations"],
        relaxation=s["relaxation"], contact_margin=s["contact_margin"],
        contact_compliance=s["contact_compliance"],
        restitution_threshold=s["restitution_threshold"],
        max_dpos=min(s["max_dpos"], s["max_depenetration_velocity"] * h),
        linear_damping=s["linear_damping"],
        angular_damping=s["angular_damping"],
        sleep_velocity=s["sleep_velocity"], sleep_frames=s["sleep_frames"],
        wake_velocity_factor=s["wake_velocity_factor"], solve_slots=slots,
        joint_solver=s["joint_solver"], joint_colors=s["max_joint_colors"],
        joint_max_dpos=s["max_dpos"])


def world_state(world) -> dict:
    """A program world's dynamic state as flat ``[B]`` tensors (copies),
    with :func:`actions`'."""
    b = world.bodies
    return dict(px=b.pos[..., 0].reshape(-1).clone(),
                py=b.pos[..., 1].reshape(-1).clone(),
                an=b.angle.reshape(-1).clone(),
                vx=b.vel[..., 0].reshape(-1).clone(),
                vy=b.vel[..., 1].reshape(-1).clone(),
                om=b.ang_vel.reshape(-1).clone(),
                sleep=b.sleep_count.reshape(-1).clone(),
                steps=world.step_count.reshape(-1).clone(),
                **actions(world))


def actions(world) -> dict:
    """The joint parameters a control rewrites each call (``motor_speed``
    and ``motor_max``), flat ``[W * J]`` copies; none without joints. Taken
    from the world the call is handed, they are the parameters it ran
    with, and the reference runs with them in place of the scene's."""
    j = world.joints
    if j.j == 0:
        return {}
    return {k: getattr(j, k).reshape(-1).clone()
            for k in ref_joints.STATE}
