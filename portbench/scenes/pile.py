"""Scene ``pile``: ``n_bodies`` convex bodies (circles of radius 0.45,
0.5 x 0.4 boxes and hexagons of circumradius 0.5, one of three drawn per
body) on a grid four times wider than tall above a floor between two walls,
each with a jittered position and an angle drawn from the seed, falling
into a pile several bodies deep.

:func:`program` builds it with the program's scene builder;
:func:`describe` draws the same scene for the reference from the same seed
without the program."""

from __future__ import annotations

import numpy as np


def _regular(n: int, r: float) -> np.ndarray:
    a = np.arange(n) * (2 * np.pi / n)
    return (r * np.stack([np.cos(a), np.sin(a)], axis=-1)).astype(np.float32)


def _box(hx: float, hy: float) -> np.ndarray:
    return np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]], np.float32)


def describe(args: dict, seed: int) -> dict:
    """The scene as numpy arrays (see ``reference.world.build``)."""
    n, half = args["n_bodies"], 0.5
    rng = np.random.default_rng(seed)
    cols = int(np.ceil(np.sqrt(n * 4)))
    rows = int(np.ceil(n / cols))
    spacing = half * 2.2
    width = cols * spacing / 2 + 2.0
    pos = [(0.0, -0.5), (-width, rows * spacing), (width, rows * spacing)]
    angle = [0.0, 0.0, 0.0]
    verts = [_box(width + 2.0, 0.5), _box(0.5, rows * spacing + 4.0),
             _box(0.5, rows * spacing + 4.0)]
    radius = [0.0, 0.0, 0.0]
    x0 = -(cols - 1) * spacing / 2
    count = 0
    for row in range(rows):
        for col in range(cols):
            if count >= n:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * half
            pos.append((x, half * 1.5 + row * spacing))
            angle.append(float(rng.uniform(0, np.pi)))
            kind = rng.integers(0, 3)
            if kind == 0:
                verts.append(np.zeros((1, 2), np.float32))
                radius.append(half * 0.9)
            elif kind == 1:
                verts.append(_box(half, half * 0.8))
                radius.append(0.0)
            else:
                verts.append(_regular(6, half))
                radius.append(0.0)
            count += 1
    N = n + 3
    return dict(W=1, N=N, M=N, body_pos=np.array(pos),
                body_angle=np.array(angle), body_dynamic=np.arange(N) >= 3,
                vel=np.zeros((1, N, 2), np.float32), col_body=np.arange(N),
                col_verts=verts, col_radius=np.array(radius),
                col_friction=np.full(N, 0.5), col_restitution=np.zeros(N),
                gravity=(0.0, -9.81))


def program(args: dict, seed: int, device):
    """The program's world for this scene."""
    from starframe_tpu_torch import scenes

    return scenes.pile(n_bodies=args["n_bodies"], substeps=args["substeps"],
                       sleep=args["sleep"], seed=seed, device=device).world
