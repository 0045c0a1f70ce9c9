"""The plain reference of the engine's semantics (plain PyTorch, no part of
the program): scene arrays from a description, and the frame.

It is the reference package of every configuration that names none
(``harness/cells.py``). A configuration whose physics this package lacks
names a package of its own under the benchmark's folder, and that package
gives the harness the same interface:

- ``world.build(desc, device)``: ``(geom, state)`` of a scene module's
  description; ``world.cast(state, dtype)`` and
  ``world.cast_geom(geom, dtype)``: the float fields in ``dtype`` (the
  bfloat16 control); ``world.shapes(desc)``: the counts the roofline
  counts read (``bodies``, ``colliders``, ``verts``, ``joints``);
- ``frame.frame(geom, st, cfg, stats=None)``: one frame from a state;
  ``frame.rollout(geom, st, cfg, n_frames, stats=None)``: ``n_frames``
  of them. ``stats`` adds each frame's counts: ``frames``, ``awake``,
  ``cand``, ``cand_live``, ``active``, ``solved`` and ``joints`` (summed),
  ``max_touching``, ``max_imminent`` and ``max_joint_rows`` (the largest);
  ``roofline/*.py`` and the entries' ``implied`` read them;
- ``config(solver, entry_name)``: the frame settings ``cfg`` from the
  configuration file's solver block (the harness adds ``gravity``);
- ``world_state(world)``: a call's input state, captured from the
  program's world before the call runs, with ``actions(world)``: the
  per-call inputs a control writes into the world, captured from the
  world the call is handed. A state the reference runs from carries
  them, and they take the place of the scene's.
"""

from . import frame, world
from .calls import actions, config, world_state

__all__ = ["actions", "config", "frame", "world", "world_state"]
