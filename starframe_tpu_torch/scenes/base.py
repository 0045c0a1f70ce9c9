"""Scene container and helpers shared by the scene builders."""

from __future__ import annotations

import dataclasses

from ..config import Capacity, SolverConfig
from ..shapes import Shape
from ..state import JOINT_OFF, World


def tighten_joint_colors(world: World, cfg: SolverConfig) -> SolverConfig:
    """Clamp ``cfg.max_joint_colors`` to the colours the scene's joints
    actually use (known at build time from the greedy colouring): the
    frame kernel runs one sequential pass per colour, so a rope chain that
    needs 2 colours would otherwise burn 6 empty passes per iteration."""
    j = world.joints
    if j.j == 0:
        return cfg
    live = (j.jtype != JOINT_OFF).cpu().numpy()
    if not live.any():
        return cfg
    used = int(j.color.cpu().numpy()[live].max()) + 1
    return dataclasses.replace(
        cfg, max_joint_colors=min(cfg.max_joint_colors, max(used, 1)))


@dataclasses.dataclass
class Scene:
    """A world (or world batch) with the capacity and solver configuration
    it was built for. The single-world ``make_step``/``make_rollout`` of the
    JAX package need the XLA tier (ROADMAP.md A3)."""

    name: str
    world: World
    capacity: Capacity
    config: SolverConfig

    @property
    def n_bodies(self) -> int:
        return int(self.world.bodies.active.sum())


def add_ground(builder, half_width: float = 100.0, y: float = 0.0,
               thickness: float = 1.0, friction: float = 0.6):
    """Static ground slab centred at (0, y - thickness / 2)."""
    g = builder.add_static(pos=(0.0, y - thickness / 2))
    builder.add_collider(g, Shape.box(half_width, thickness / 2),
                         friction=friction)
    return g
