"""Scene builders."""

from .base import Scene
from .batched import batched_worlds

__all__ = ["Scene", "batched_worlds"]
