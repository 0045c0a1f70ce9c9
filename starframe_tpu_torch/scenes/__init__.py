"""Scene builders."""

from .base import Scene, add_ground, tighten_joint_colors
from .batched import batched_worlds, batchify
from .mechanism import mechanism
from .pile import pile
from .rope_bridge import rope_bridge

__all__ = ["Scene", "add_ground", "batched_worlds", "batchify", "mechanism",
           "pile", "rope_bridge", "tighten_joint_colors"]
