"""World batches: ``n_worlds`` independent 256-body settling worlds
(BASELINE.json:11, the workload the throughput metric is defined on) and
:func:`batchify`, which turns any single-world scene into a batch. The same
scenes as ``starframe_tpu/scenes/batched.py``; the per-world velocity noise
is drawn with numpy's ``default_rng(seed)`` instead of ``jax.random``, so
worlds match the JAX package's in everything but the noise."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Capacity, SolverConfig
from ..parallel import replicate_world
from ..shapes import Shape
from ..state import WorldBuilder, expand_capacity
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


def _with_noise(batched, scale: float, seed: int):
    """Add ``scale``-sized normal velocity noise to every dynamic body of
    every world, drawn from ``default_rng(seed)``."""
    b = batched.bodies
    noise = scale * np.random.default_rng(seed).standard_normal(
        tuple(b.vel.shape), dtype=np.float32)
    dyn = (b.inv_mass > 0)[..., None]
    vel = torch.where(dyn, b.vel + torch.as_tensor(noise, device=b.vel.device),
                      b.vel)
    return dataclasses.replace(batched, bodies=dataclasses.replace(b, vel=vel))


def batchify(scene: Scene, n_worlds: int, seed: int = 0,
             noise: float = 0.05) -> Scene:
    """Turn a single-world scene into an ``n_worlds`` batch: pad the body
    and collider capacities to multiples of 128, replicate the world and
    add per-world velocity noise so the worlds diverge. The CUDA kernels do
    not need the padding (it is the TPU kernels' lane rule); it is kept so
    that both packages hold the same arrays. The scene keeps its
    ``joint_solver`` (the frame kernel runs both joint tiers)."""
    world = scene.world
    world = expand_capacity(world, extra_bodies=(-world.bodies.n) % 128,
                            extra_colliders=(-world.colliders.m) % 128)
    batched = _with_noise(replicate_world(world, n_worlds), noise, seed)
    cap = dataclasses.replace(scene.capacity, max_bodies=world.bodies.n,
                              max_colliders=world.colliders.m)
    return Scene(f"batched_{scene.name}", batched, cap, scene.config)


def batched_worlds(n_worlds: int = 4096, n_bodies: int = 256,
                   substeps: int = 10, seed: int = 0, device="cuda") -> Scene:
    """``n_worlds`` copies of a 256-body settling scene, with per-world
    velocity noise (0.1 m/s normal, dynamic bodies only) drawn from
    ``default_rng(seed)`` so worlds diverge but replays are identical."""
    world, cap, cfg = _single_world(n_bodies, substeps, device)
    batched = _with_noise(replicate_world(world, n_worlds), 0.1, seed)
    return Scene("batched_worlds", batched, cap, cfg)
