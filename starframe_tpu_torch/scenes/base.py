"""Scene container shared by the scene builders."""

from __future__ import annotations

import dataclasses

from ..config import Capacity, SolverConfig
from ..state import World


@dataclasses.dataclass
class Scene:
    """A world (or world batch) with the capacity and solver configuration
    it was built for. The single-world ``make_step``/``make_rollout`` of the
    JAX package need the XLA tier (ROADMAP.md A2)."""

    name: str
    world: World
    capacity: Capacity
    config: SolverConfig

    @property
    def n_bodies(self) -> int:
        return int(self.world.bodies.active.sum())
