"""A reference package that re-exports the benchmark's own
(``reference/``) and computes nothing of its own. A cell that names it
must read every number it reads with ``reference/``, bit for bit; its
modules are its own, so a test can watch each part of the interface."""

from . import frame, world
from reference import actions, config, world_state

__all__ = ["actions", "config", "frame", "world", "world_state"]
