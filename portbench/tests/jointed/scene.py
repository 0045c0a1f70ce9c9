"""Scene ``legged_hull``, the harness's jointed test scene: in each of
``n_worlds`` worlds a hull on one motorised two-segment leg above a terrain
of ``n_edges`` static edges, each on its own static body, whose heights
follow a random walk drawn from the seed, so each world has its own.

The parts follow Gymnasium's BipedalWalker-v3 (``SCALE`` 30): a 5-vertex
hull at density 5 and friction 0.1; a thigh of 8 x 34 px and a shin of
6.4 x 34 px at density 1 and friction 0.2, on collision layer 5 with mask
1, so they touch the terrain (layer 0, friction 2.5, an edge skin of
0.01 m) and never each other; a hip and a knee, each a pin, an angle range
(hip -0.8 to 1.1 rad, knee -1.6 to -0.1) and an angular motor. The hull's
x velocity is drawn from the seed (up to 1 m/s either way).

:func:`program` builds it with the program's scene builder; :func:`describe`
draws the same scene for the reference from the same seed without the
program."""

from __future__ import annotations

import numpy as np

SCALE = 30.0
# the hull, counter-clockwise (BipedalWalker's HULL_POLY, reversed)
HULL = np.array([(-30, -8), (34, -8), (34, 1), (6, 9), (-30, 9)],
                np.float32) / SCALE
LEG_H = 34 / SCALE
THIGH = (4 / SCALE, LEG_H / 2)  # half-extents
SHIN = (3.2 / SCALE, LEG_H / 2)
LEG_DOWN = -8 / SCALE  # the hip, in the hull's frame
HIP, KNEE = (-0.8, 1.1), (-1.6, -0.1)
TORQUE = 80.0
EDGE_W, SKIN = 1.0, 0.01
PARTS_LAYER, PARTS_MASK = 5, 1
# joint types and rows (the engine's numbers): hip pin, range, motor; knee
# the same; the greedy colouring gives each its own colour
PIN, RANGE, MOTOR = 2, 3, 4


def _layout(args: dict):
    """Body positions of the template: the edges' bodies at the origin, then
    the hull, the thigh and the shin."""
    T = args["n_edges"]
    y = 2 * LEG_H + 0.5
    return [(0.0, 0.0)] * T + [(0.0, y), (0.0, y + LEG_DOWN - LEG_H / 2),
                               (0.0, y + LEG_DOWN - 1.5 * LEG_H)]


def _terrain(args: dict, rng) -> np.ndarray:
    """``[W, T + 1]`` edge-end heights: a random walk from 0, steps of up to
    0.08 m, each world its own."""
    W, T = args["n_worlds"], args["n_edges"]
    steps = rng.uniform(-0.08, 0.08, (W, T)).astype(np.float32)
    return np.concatenate([np.zeros((W, 1), np.float32),
                           np.cumsum(steps, 1)], 1) - np.float32(0.3)


def _box(hx: float, hy: float) -> np.ndarray:
    return np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]], np.float32)


def _draw(args: dict, seed: int):
    """``(terrain heights, hull x velocities)`` from the seed."""
    rng = np.random.default_rng(seed)
    heights = _terrain(args, rng)
    vx = rng.uniform(-1.0, 1.0, args["n_worlds"]).astype(np.float32)
    return heights, vx


def _edge_verts(args: dict, heights) -> np.ndarray:
    """``[W, T, 2, 2]`` world ends of each edge."""
    T = args["n_edges"]
    x = (np.arange(T + 1, dtype=np.float32) - T / 2) * EDGE_W
    ends = np.stack([np.broadcast_to(x, heights.shape), heights], -1)
    return np.stack([ends[:, :-1], ends[:, 1:]], 2)


def describe(args: dict, seed: int) -> dict:
    """The scene as numpy arrays (see ``reference.world.build``)."""
    W, T = args["n_worlds"], args["n_edges"]
    N = M = T + 3
    heights, hull_vx = _draw(args, seed)
    V = len(HULL)
    verts = np.zeros((W, M, V, 2), np.float32)
    verts[:, :T, :2] = _edge_verts(args, heights)
    for k, shape in enumerate((HULL, _box(*THIGH), _box(*SHIN))):
        verts[:, T + k, :len(shape)] = shape
    nverts = np.array([2] * T + [V, 4, 4], np.int32)
    vel = np.zeros((W, N, 2), np.float32)
    vel[:, T, 0] = hull_vx
    hull, thigh, shin = T, T + 1, T + 2
    joints = dict(
        type=np.array([PIN, RANGE, MOTOR] * 2, np.int32),
        body_a=np.array([hull] * 3 + [thigh] * 3, np.int32),
        body_b=np.array([thigh] * 3 + [shin] * 3, np.int32),
        anchor_a=np.array([(0.0, LEG_DOWN)] + [(0.0, 0.0)] * 2
                          + [(0.0, -LEG_H / 2)] + [(0.0, 0.0)] * 2,
                          np.float32),
        anchor_b=np.array([(0.0, LEG_H / 2)] + [(0.0, 0.0)] * 2
                          + [(0.0, LEG_H / 2)] + [(0.0, 0.0)] * 2,
                          np.float32),
        rest=np.zeros(6, np.float32),
        lo=np.array([0.0, HIP[0], 0.0, 0.0, KNEE[0], 0.0], np.float32),
        hi=np.array([0.0, HIP[1], 0.0, 0.0, KNEE[1], 0.0], np.float32),
        compliance=np.zeros(6, np.float32), damping=np.zeros(6, np.float32),
        motor_speed=np.zeros(6, np.float32),
        motor_max=np.array([np.inf, np.inf, TORQUE] * 2, np.float32),
        color=np.arange(6, dtype=np.int32))
    return dict(W=W, N=N, M=M, body_pos=np.array(_layout(args), np.float32),
                body_angle=np.zeros(N), body_dynamic=np.arange(N) >= T,
                vel=vel, col_body=np.arange(M), col_verts=verts,
                col_nverts=nverts,
                col_radius=np.array([SKIN] * T + [0.0] * 3),
                col_friction=np.array([2.5] * T + [0.1, 0.2, 0.2]),
                col_restitution=np.zeros(M),
                col_layer=np.array([0] * T + [PARTS_LAYER] * 3, np.int32),
                col_mask=np.array([-1] * T + [PARTS_MASK] * 3, np.int32),
                col_density=np.array([1.0] * T + [5.0, 1.0, 1.0]),
                joints=joints, gravity=(0.0, -9.81))


def program(args: dict, seed: int, device):
    """The program's world for this scene: one world from the program's
    builder, replicated, then each world's terrain and hull velocity."""
    import dataclasses

    import torch
    from starframe_tpu_torch.parallel import replicate_world
    from starframe_tpu_torch.shapes import Shape
    from starframe_tpu_torch.state import WorldBuilder

    W, T = args["n_worlds"], args["n_edges"]
    heights, hull_vx = _draw(args, seed)
    ends = _edge_verts(args, heights)
    pos = _layout(args)
    b = WorldBuilder(gravity=(0.0, -9.81))
    for k in range(T):
        body = b.add_static(pos=pos[k])
        b.add_collider(body, Shape.segment(ends[0, k, 0], ends[0, k, 1],
                                           SKIN), friction=2.5)
    parts = []
    for k, (shape, density, friction) in enumerate((
            (Shape.polygon(HULL), 5.0, 0.1), (Shape.box(*THIGH), 1.0, 0.2),
            (Shape.box(*SHIN), 1.0, 0.2))):
        body = b.add_body(pos=pos[T + k])
        b.add_collider(body, shape, friction=friction, density=density,
                       layer=PARTS_LAYER, mask=PARTS_MASK)
        parts.append(body)
    hull, thigh, shin = parts
    for a, c, anchor_a, (lo, hi) in ((hull, thigh, (0.0, LEG_DOWN), HIP),
                                     (thigh, shin, (0.0, -LEG_H / 2), KNEE)):
        b.pin_joint(a, c, anchor_a=anchor_a, anchor_b=(0.0, LEG_H / 2))
        b.angle_limit(a, c, lo, hi)
        b.angular_motor(a, c, speed=0.0, max_torque=TORQUE)
    world, _ = b.build(device=device)
    world = replicate_world(world, W)
    c = world.colliders
    verts = c.verts.clone()
    verts[:, :T, :2] = torch.as_tensor(ends, device=verts.device)
    verts[:, :T, 2:] = verts[:, :T, :1]
    vel = world.bodies.vel.clone()
    vel[:, T, 0] = torch.as_tensor(hull_vx, device=vel.device)
    return dataclasses.replace(
        world, colliders=dataclasses.replace(c, verts=verts),
        bodies=dataclasses.replace(world.bodies, vel=vel))
