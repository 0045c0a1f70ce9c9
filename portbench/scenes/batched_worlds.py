"""Scene ``batched_worlds``: ``n_worlds`` copies of one 256-body settling
world (a floor, two walls, alternating circles and boxes of half-size 0.45
on a 1.1 m grid), each with its own 0.1 m/s normal velocity noise on the
dynamic bodies, drawn from the seed.

:func:`program` builds it with the program's scene builder;
:func:`describe` draws the same scene for the reference from the same seed
without the program."""

from __future__ import annotations

import numpy as np


def describe(args: dict, seed: int) -> dict:
    """The scene as numpy arrays (see ``reference.world.build``)."""
    W, N = args["n_worlds"], args["n_bodies"]
    n_dyn = N - 3
    cols = int(np.ceil(np.sqrt(n_dyn * 2)))
    spacing = 1.1
    x0 = -(cols - 1) * spacing / 2
    half_width = -x0 + 1.2
    pos = [(0.0, -0.5), (-half_width, 10.0), (half_width, 10.0)]
    box = _box
    verts = [box(half_width + 2.0, 0.5), box(0.5, 20.0), box(0.5, 20.0)]
    radius = [0.0, 0.0, 0.0]
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        pos.append((x0 + col * spacing, 0.6 + row * spacing))
        if i % 2 == 0:
            verts.append(np.zeros((1, 2), np.float32))
            radius.append(0.45)
        else:
            verts.append(box(0.45, 0.45))
            radius.append(0.0)
    dynamic = np.arange(N) >= 3
    noise = 0.1 * np.random.default_rng(seed).standard_normal(
        (W, N, 2), dtype=np.float32)
    vel = np.where(dynamic[None, :, None], noise, np.float32(0.0))
    return dict(W=W, N=N, M=N, body_pos=np.array(pos),
                body_angle=np.zeros(N), body_dynamic=dynamic, vel=vel,
                col_body=np.arange(N), col_verts=verts,
                col_radius=np.array(radius), col_friction=np.full(N, 0.5),
                col_restitution=np.zeros(N), gravity=(0.0, -9.81))


def _box(hx: float, hy: float) -> np.ndarray:
    return np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]], np.float32)


def program(args: dict, seed: int, device):
    """The program's world for this scene."""
    from starframe_tpu_torch import scenes

    return scenes.batched_worlds(
        n_worlds=args["n_worlds"], n_bodies=args["n_bodies"],
        substeps=args["substeps"], seed=seed, device=device).world
