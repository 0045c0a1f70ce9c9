"""starframe_tpu_torch: the batched-worlds rollout of ``starframe_tpu`` on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

``starframe_tpu`` (JAX, TPU) is the reference; this package imports torch
and numpy and never jax. It keeps the reference's ``World`` arrays, its
``SolverConfig``/``Capacity`` knobs, its snapshot keys and its overflow
counters. Kernels: ``hopper/slots.py`` (pair eligibility, contact slot
tables and joint slots) and ``hopper/frame2.py`` (the whole frame, with or
without joints), each with a plain PyTorch twin that CPU tensors take.
What is not ported yet raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from . import io, kernels, parallel, ropes, scenes
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

__all__ = [
    "Bodies", "Capacity", "Colliders", "Joints", "Shape", "SolverConfig",
    "World", "WorldBuilder", "batched_rollout", "batched_step",
    "expand_capacity", "frame2_elig", "frame2_joint_slots", "frame2_step",
    "frame2_tables", "io", "kernels", "make_batched_rollout", "parallel",
    "replicate_world", "ropes", "scenes",
]
