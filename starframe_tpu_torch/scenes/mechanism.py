"""Joint mechanism (BASELINE.json:10): a motor-driven paddle wheel, a pinned
capsule pendulum and a platform hung by two distance joints, with loose
circles. The scene of ``starframe_tpu/scenes/mechanism.py``."""

from __future__ import annotations

import numpy as np

from ..config import Capacity, SolverConfig
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene, add_ground, tighten_joint_colors


def mechanism(n_pendulum_links: int = 6, link_half: float = 0.5,
              motor_speed: float = 2.0, seed: int = 0, substeps: int = 10,
              device="cuda") -> Scene:
    """A paddle wheel (two crossed capsules) pinned to a static hub and
    driven by an angular motor, a capsule-chain pendulum of revolute pins,
    a platform with cargo hung by two distance joints, and eight circles.
    ``scene.wheel`` is the wheel's body index."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))
    add_ground(b, half_width=30.0, friction=0.7)

    hub = b.add_static(pos=(0.0, 2.0))
    wheel = b.add_body(pos=(0.0, 2.0))
    b.add_collider(wheel, Shape.capsule(1.6, 0.18), friction=0.8)
    b.add_collider(wheel, Shape.capsule(1.6, 0.18), offset_angle=np.pi / 2,
                   friction=0.8)
    b.pin_joint(hub, wheel, world_point=(0.0, 2.0))
    b.angular_motor(hub, wheel, speed=motor_speed, max_torque=500.0)

    anchor = b.add_static(pos=(8.0, 9.0))
    prev = anchor
    for i in range(n_pendulum_links):
        y = 9.0 - (2 * link_half + 0.1) * (i + 0.5)
        link = b.add_body(pos=(8.0, y), angle=np.pi / 2)
        b.add_collider(link, Shape.capsule(link_half, 0.15), friction=0.4)
        pin_y = 9.0 - (2 * link_half + 0.1) * i
        b.pin_joint(prev, link, world_point=(8.0, pin_y))
        prev = link

    beam_anchor = b.add_static(pos=(-8.0, 8.0))
    platform = b.add_body(pos=(-8.0, 4.0))
    b.add_collider(platform, Shape.box(2.0, 0.2), friction=0.8)
    for x in (-1.8, 1.8):
        b.distance_joint(beam_anchor, platform, anchor_a=(x, 0.0),
                         anchor_b=(x, 0.0), compliance=1e-6, damping=1.0)
    cargo = b.add_body(pos=(-8.0, 4.6))
    b.add_collider(cargo, Shape.box(0.4, 0.4, radius=0.08), friction=0.6)

    for i in range(8):
        body = b.add_body(pos=(float(rng.uniform(-3, 3)), 4.5 + 0.7 * i))
        b.add_collider(body, Shape.circle(0.3), friction=0.4, restitution=0.2)

    n_colliders = len(b._colliders)
    cap = Capacity(max_bodies=len(b._bodies), max_colliders=n_colliders,
                   max_pairs=max(24 * n_colliders, 512),
                   max_joints=len(b._joints), max_verts=4)
    world, cap = b.build(cap, device=device)
    # compound bodies own several colliders, so rows see more candidates
    # than the default 8 slots
    cfg = SolverConfig(dt=1 / 60, substeps=substeps, slot_capacity=12)
    cfg = tighten_joint_colors(world, cfg)
    scene = Scene("mechanism", world, cap, cfg)
    scene.wheel = wheel
    return scene
