"""Rope bridge (BASELINE.json:9): a particle rope pinned between two pillars,
boxes dropped onto it and a crate hung from its middle by a second rope.
The scene of ``starframe_tpu/scenes/rope_bridge.py``."""

from __future__ import annotations

import numpy as np

from ..config import Capacity, SolverConfig
from ..ropes import attach_rope
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene, tighten_joint_colors


def rope_bridge(span: float = 16.0, n_particles: int = 40, n_loads: int = 6,
                load_half: float = 0.45, thickness: float = 0.25,
                seed: int = 0, substeps: int = 10, device="cuda") -> Scene:
    """A rope strung between two static pillars, with boxes dropped onto it
    (contacts couple them to the particle chain) and a crate hung from the
    middle particle by a second rope (pure attachment coupling).
    ``scene.rope`` and ``scene.hang`` are the two ropes' handles."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    left = b.add_static(pos=(-span / 2 - 0.5, 0.0))
    b.add_collider(left, Shape.box(0.5, 6.0))
    right = b.add_static(pos=(span / 2 + 0.5, 0.0))
    b.add_collider(right, Shape.box(0.5, 6.0))
    g = b.add_static(pos=(0.0, -14.0))  # far below, so nothing escapes
    b.add_collider(g, Shape.box(span * 2, 0.5))

    rope = attach_rope(b, start=(-span / 2, 4.0), end=(span / 2, 4.0),
                       n_particles=n_particles, thickness=thickness,
                       density=2.0, compliance=1e-7, damping=0.5,
                       body_start=left, body_end=right, friction=0.8)

    for i in range(n_loads):
        x = (-span / 3 + (2 * span / 3) * i / max(n_loads - 1, 1)
             + rng.uniform(-0.1, 0.1))
        body = b.add_body(pos=(x, 6.0 + (i % 2) * 1.2))
        b.add_collider(body, Shape.box(load_half, load_half), friction=0.5)

    mid = rope.particles[n_particles // 2]
    crate = b.add_body(pos=(0.0, 1.5))
    b.add_collider(crate, Shape.box(0.5, 0.5), friction=0.5)
    hang = attach_rope(b, start=(0.0, 4.0), end=(0.0, 2.0), n_particles=8,
                       thickness=0.15, density=1.0, collide=False,
                       body_start=mid, body_end=crate)

    cap = Capacity(
        max_bodies=3 + n_particles + 8 + n_loads + 1,
        max_colliders=3 + n_particles + n_loads + 1,
        max_pairs=max(16 * (n_particles + n_loads), 512),
        max_joints=len(b._joints), max_verts=4)
    world, cap = b.build(cap, device=device)
    cfg = SolverConfig(dt=1 / 60, substeps=substeps)
    cfg = tighten_joint_colors(world, cfg)
    scene = Scene("rope_bridge", world, cap, cfg)
    scene.rope = rope
    scene.hang = hang
    return scene
