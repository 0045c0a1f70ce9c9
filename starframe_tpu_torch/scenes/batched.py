"""``n_worlds`` independent 256-body settling worlds (BASELINE.json:11): the
batched-rollout workload the throughput metric is defined on. The same
scene as ``starframe_tpu/scenes/batched.py``; the per-world velocity noise
is drawn with numpy's ``default_rng(seed)`` instead of ``jax.random``, so
worlds match the JAX package's in everything but the noise."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Capacity, SolverConfig
from ..parallel import replicate_world
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene


def _single_world(n_bodies: int, substeps: int, device):
    b = WorldBuilder(gravity=(0.0, -9.81))
    n_dyn = n_bodies - 3
    cols = int(np.ceil(np.sqrt(n_dyn * 2)))
    spacing = 1.1
    x0 = -(cols - 1) * spacing / 2
    # wall inner faces sit 0.7 past the spawn grid, so edge bodies
    # (half-extent 0.45) spawn with a 0.25 gap
    half_width = -x0 + 1.2
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(half_width + 2.0, 0.5), friction=0.5)
    wl = b.add_static(pos=(-half_width, 10.0))
    b.add_collider(wl, Shape.box(0.5, 20.0), friction=0.5)
    wr = b.add_static(pos=(half_width, 10.0))
    b.add_collider(wr, Shape.box(0.5, 20.0), friction=0.5)
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        body = b.add_body(pos=(x0 + col * spacing, 0.6 + row * spacing))
        if i % 2 == 0:
            b.add_collider(body, Shape.circle(0.45), friction=0.5)
        else:
            b.add_collider(body, Shape.box(0.45, 0.45), friction=0.5)
    cap = Capacity(max_bodies=n_bodies, max_colliders=n_bodies,
                   max_pairs=max(4 * n_bodies, 512), max_joints=0,
                   max_verts=4)
    world, cap = b.build(cap, device=device)
    # rollouts amortize the slot-table broadphase over 4 frames
    cfg = SolverConfig(dt=1 / 60, substeps=substeps, frames_per_broadphase=4)
    return world, cap, cfg


def batched_worlds(n_worlds: int = 4096, n_bodies: int = 256,
                   substeps: int = 10, seed: int = 0, device="cpu") -> Scene:
    """``n_worlds`` copies of a 256-body settling scene, with per-world
    velocity noise (0.1 m/s normal, dynamic bodies only) drawn from
    ``default_rng(seed)`` so worlds diverge but replays are identical."""
    world, cap, cfg = _single_world(n_bodies, substeps, device)
    batched = replicate_world(world, n_worlds)
    noise = 0.1 * np.random.default_rng(seed).standard_normal(
        (n_worlds, n_bodies, 2), dtype=np.float32)
    dyn = (batched.bodies.inv_mass > 0)[..., None]
    vel = torch.where(dyn, batched.bodies.vel + torch.as_tensor(
        noise, device=device), batched.bodies.vel)
    batched = dataclasses.replace(
        batched, bodies=dataclasses.replace(batched.bodies, vel=vel))
    return Scene("batched_worlds", batched, cap, cfg)
