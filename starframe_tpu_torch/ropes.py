"""Ropes: particle chains held by XPBD distance joints.

The counterpart of ``starframe_tpu/ropes.py``. Particles are ordinary
point-mass bodies (zero inverse inertia); the stretch constraints between
consecutive particles and the optional bend constraints (second
neighbours) are rows of the shared joint table, so the solver has no
rope-specific path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .shapes import Shape
from .state import WorldBuilder


@dataclasses.dataclass(frozen=True)
class Rope:
    """Handle to a spawned rope: its particle bodies and joint rows."""

    particles: tuple
    stretch_joints: tuple
    bend_joints: tuple
    spacing: float
    thickness: float


def attach_rope(builder: WorldBuilder, start, end, n_particles: int,
                thickness: float = 0.05, density: float = 1.0,
                compliance: float = 0.0, bend_compliance: float = -1.0,
                damping: float = 0.0, collide: bool = True,
                friction: float = 0.3, layer: int = 0, mask: int = -1,
                body_start: int | None = None,
                body_end: int | None = None) -> Rope:
    """Spawn a rope of ``n_particles`` point masses between two world
    points. ``body_start``/``body_end`` pin the ends to existing bodies;
    with ``collide=True`` each particle carries a small circle collider."""
    start = np.asarray(start, np.float32)
    end = np.asarray(end, np.float32)
    seg = (end - start) / max(n_particles - 1, 1)
    spacing = float(np.linalg.norm(seg))
    mass = (density * spacing * thickness if spacing > 0
            else density * thickness ** 2)

    particles = []
    for i in range(n_particles):
        key = builder.add_particle(pos=start + seg * i, mass=mass)
        particles.append(key)
        if collide:
            builder.add_collider(key, Shape.circle(thickness / 2),
                                 friction=friction, density=0.0,
                                 layer=layer, mask=mask)

    stretch = [builder.distance_joint(a, b, rest=spacing,
                                      compliance=compliance, damping=damping)
               for a, b in zip(particles[:-1], particles[1:])]
    bends = []
    if bend_compliance >= 0.0 and n_particles >= 3:
        bends = [builder.distance_joint(a, b, rest=2 * spacing,
                                        compliance=bend_compliance)
                 for a, b in zip(particles[:-2], particles[2:])]

    if body_start is not None:
        builder.pin_joint(body_start, particles[0], world_point=start)
    if body_end is not None:
        builder.pin_joint(body_end, particles[-1], world_point=end)

    return Rope(particles=tuple(particles), stretch_joints=tuple(stretch),
                bend_joints=tuple(bends), spacing=spacing,
                thickness=thickness)
