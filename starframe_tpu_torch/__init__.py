"""starframe_tpu_torch: the batched-worlds rollout and the single-world
tile engine of ``starframe_tpu`` on PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

``starframe_tpu`` (JAX, TPU) is the reference; this package imports torch
and numpy and never jax. It keeps the reference's ``World`` arrays, its
``SolverConfig``/``Capacity`` knobs, its snapshot keys and its overflow
counters. Kernels: ``hopper/slots.py`` (pair eligibility, contact slot
tables and joint slots), ``hopper/frame2.py`` (the whole batched frame,
with or without joints) and ``hopper/tiles.py`` (the tile engine's tables,
manifolds and per-substep project/apply pair, behind ``tiled.py``), each
with a plain PyTorch twin that CPU tensors take. Entry points run on the
card unless the caller passes ``device="cpu"``.
What is not ported yet raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from . import events, io, kernels, parallel, ropes, scenes, tiled
from .config import Capacity, SolverConfig
from .parallel import (
    batched_rollout,
    batched_step,
    frame2_elig,
    frame2_joint_slots,
    frame2_step,
    frame2_tables,
    make_batched_rollout,
    replicate_world,
)
from .shapes import Shape
from .state import Bodies, Colliders, Joints, World, WorldBuilder, expand_capacity
from .tiled import tiled_rollout, tiled_step, use_tiled

__all__ = [
    "Bodies", "Capacity", "Colliders", "Joints", "Shape", "SolverConfig",
    "World", "WorldBuilder", "batched_rollout", "batched_step", "events",
    "expand_capacity", "frame2_elig", "frame2_joint_slots", "frame2_step",
    "frame2_tables", "io", "kernels", "make_batched_rollout", "parallel",
    "replicate_world", "ropes", "scenes", "tiled", "tiled_rollout",
    "tiled_step", "use_tiled",
]
