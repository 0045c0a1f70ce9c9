"""Scene builders."""

from .base import Scene, add_ground, tighten_joint_colors
from .batched import batched_worlds, batchify
from .mechanism import mechanism
from .pile import pile, pile_compound
from .rope_bridge import rope_bridge

__all__ = ["Scene", "add_ground", "batched_worlds", "batchify", "mechanism",
           "pile", "pile_compound", "rope_bridge", "tighten_joint_colors"]
