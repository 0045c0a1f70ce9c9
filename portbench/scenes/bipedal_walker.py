"""Scene ``bipedal_walker``: Gymnasium's BipedalWalker-v3 (normal terrain,
``gymnasium/envs/box2d/bipedal_walker.py``) as ``n_worlds`` envs, each on
its own terrain of ``n_edges`` static edges, each edge on its own static
body, as the source builds it.

The source's constants (``SCALE`` 30 px a metre):

- the hull ``HULL_POLY``, density 5, friction 0.1, category 0x20 and mask
  0x1 (collision layer 5, mask 1: the parts touch the terrain and never
  each other);
- two legs, each an upper box of ``LEG_W`` x ``LEG_H`` = 8 x 34 px and a
  lower box of 0.8 ``LEG_W`` x ``LEG_H``, density 1, friction 0.2, on the
  hull's layer and mask, tilted by -0.05 and +0.05 rad;
- a hip (-0.8 to 1.1 rad) and a knee (-1.6 to -0.1 rad) a leg, each a
  revolute joint with a limit and a motor of ``MOTORS_TORQUE`` 80; in the
  engine each is a pin, an angle range and an angular motor;
- the terrain: ``TERRAIN_LENGTH`` points ``TERRAIN_STEP`` = 14 px apart
  from x = 0, their heights the source's grass walk from
  ``TERRAIN_HEIGHT``, drawn for each world from the seed; each edge has
  friction 2.5, layer 0 with mask -1, and Box2D's 0.01 m skin;
- the spawn: the hull at ``init_x``, ``init_y`` (raised 16 px: see
  below), the hull pushed by a force of ``U(-5, 5)`` N along x for one
  step, which becomes an x velocity of force x dt / hull mass;
- gravity -10 m/s^2, pybox2d's ``b2World()`` default.

The source spawns the hull 16 px lower, with the hip anchors 16 px apart,
and lets Box2D close the gap; an XPBD pin closes it in one substep, so the
hull is raised to where its hip anchors meet the legs' (the legs stay
where the source puts them, their feet about 0.27 m above the pad).

Bodies: the edges, then the hull, then each leg's upper and lower part.
Joints (:data:`JOINTS`): for each leg the hip's three rows, then the
knee's. Action ``k`` of an env step drives the motor row
``ACTION_MOTORS[k]``, a hip where ``ACTION_HIP[k]``, as the source's
``joints[k]``.

:func:`program` builds it with the program's ``WorldBuilder``;
:func:`describe` draws the same scene for the reference from the same
seed without the program."""

from __future__ import annotations

import numpy as np

SCALE = 30.0
FPS = 50
# the hull, counter-clockwise (HULL_POLY, reversed)
HULL = np.array([(-30, -8), (34, -8), (34, 1), (6, 9), (-30, 9)],
                np.float32) / SCALE
LEG_DOWN = -8 / SCALE
LEG_W, LEG_H = 8 / SCALE, 34 / SCALE
UPPER = (LEG_W / 2, LEG_H / 2)  # half-extents
LOWER = (0.8 * LEG_W / 2, LEG_H / 2)
LEG_TILT = 0.05
HIP, KNEE = (-0.8, 1.1), (-1.6, -0.1)
MOTORS_TORQUE = 80.0
TERRAIN_STEP = 14 / SCALE
TERRAIN_HEIGHT = 400 / SCALE / 4  # VIEWPORT_H / SCALE / 4
TERRAIN_STARTPAD = 20
TERRAIN_GRASS = 10
INITIAL_RANDOM = 5.0  # N
HULL_DENSITY, LEG_DENSITY = 5.0, 1.0
HULL_FRICTION, LEG_FRICTION, TERRAIN_FRICTION = 0.1, 0.2, 2.5
SKIN = 0.01  # Box2D's polygon radius on an edge
PARTS_LAYER, PARTS_MASK = 5, 1
GRAVITY = (0.0, -10.0)
INIT_X = TERRAIN_STEP * TERRAIN_STARTPAD / 2
INIT_Y = TERRAIN_HEIGHT + 2 * LEG_H
HULL_RAISE = -2 * LEG_DOWN  # the hip anchors' gap at the source's spawn

# the engine's joint types (``reference.joints``)
PIN, RANGE, MOTOR = 2, 3, 4
# the engine's joints: (kind, type) for each leg's hip, then its knee
JOINTS = tuple((kind, t) for _ in range(2) for kind in ("hip", "knee")
               for t in (PIN, RANGE, MOTOR))
ACTION_MOTORS = tuple(k for k, (_, t) in enumerate(JOINTS) if t == MOTOR)
ACTION_HIP = tuple(JOINTS[k][0] == "hip" for k in ACTION_MOTORS)
# the colours the program's ``WorldBuilder`` gives these joints (greedy)
COLORS = (0, 1, 2, 3, 4, 5, 3, 4, 5, 0, 1, 2)


def hull_mass() -> float:
    """``HULL_DENSITY`` x the hull polygon's area (kg)."""
    v = HULL.astype(np.float64)
    q = np.roll(v, -1, axis=0)
    return HULL_DENSITY * 0.5 * float((v[:, 0] * q[:, 1]
                                       - v[:, 1] * q[:, 0]).sum())


def _layout(T: int):
    """``(pos [N, 2], angle [N])`` of the template: the edges' bodies at
    the origin, the hull, then each leg's upper and lower part."""
    pos = [(0.0, 0.0)] * T + [(INIT_X, INIT_Y + HULL_RAISE)]
    angle = [0.0] * (T + 1)
    for side in (-1, 1):
        pos += [(INIT_X, INIT_Y - LEG_H / 2 - LEG_DOWN),
                (INIT_X, INIT_Y - 1.5 * LEG_H - LEG_DOWN)]
        angle += [side * LEG_TILT] * 2
    return np.array(pos, np.float32), np.array(angle, np.float32)


def _terrain(W: int, T: int, rng) -> np.ndarray:
    """``[W, T + 1]`` terrain heights, the source's grass walk for each
    world: ``v = 0.8 v + 0.01 sign(TERRAIN_HEIGHT - y)``, past the start
    pad plus ``U(-1, 1) / SCALE``, then ``y += v``; the step after each
    grass stretch (``counter`` reaching 0, then 5 to 9 steps) keeps
    ``y``."""
    y = np.full(W, TERRAIN_HEIGHT, np.float64)
    v = np.zeros(W)
    counter = np.full(W, TERRAIN_STARTPAD)
    oneshot = np.zeros(W, bool)
    out = np.empty((W, T + 1), np.float64)
    for i in range(T + 1):
        noise = rng.uniform(-1.0, 1.0, W) / SCALE
        grass = rng.integers(TERRAIN_GRASS // 2, TERRAIN_GRASS, W)
        walk = ~oneshot
        nv = 0.8 * v + 0.01 * np.sign(TERRAIN_HEIGHT - y)
        if i > TERRAIN_STARTPAD:
            nv = nv + noise
        v = np.where(walk, nv, v)
        y = np.where(walk, y + v, y)
        out[:, i] = y
        counter -= 1
        oneshot = counter == 0
        counter = np.where(oneshot, grass, counter)
    return out.astype(np.float32)


def _draw(args: dict, seed: int):
    """``(terrain heights [W, T + 1], hull x velocities [W])`` from the
    seed."""
    W, T = args["n_worlds"], args["n_edges"]
    rng = np.random.default_rng(seed)
    heights = _terrain(W, T, rng)
    force = rng.uniform(-INITIAL_RANDOM, INITIAL_RANDOM, W)
    vx = (force / FPS / hull_mass()).astype(np.float32)
    return heights, vx


def _edge_verts(heights) -> np.ndarray:
    """``[W, T, 2, 2]`` world ends of each edge."""
    x = np.arange(heights.shape[1], dtype=np.float32) * np.float32(
        TERRAIN_STEP)
    ends = np.stack([np.broadcast_to(x, heights.shape), heights], -1)
    return np.stack([ends[:, :-1], ends[:, 1:]], 2)


def _box(hx: float, hy: float) -> np.ndarray:
    return np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]], np.float32)


def _joint_rows(T: int):
    """Each engine joint's ``(body a, body b, anchor a, anchor b, lo, hi,
    motor speed)``, in :data:`JOINTS`' order; the motors' speeds are the
    source's at reset (the hip's the leg's side, the knee's 1), which the
    first action replaces."""
    hull = T
    rows = []
    for k, side in enumerate((-1, 1)):
        upper, lower = T + 1 + 2 * k, T + 2 + 2 * k
        for a, b, anchor_a, (lo, hi), speed in (
                (hull, upper, (0.0, LEG_DOWN), HIP, float(side)),
                (upper, lower, (0.0, -LEG_H / 2), KNEE, 1.0)):
            anchor_b = (0.0, LEG_H / 2)
            rows += [(a, b, anchor_a, anchor_b, 0.0, 0.0, 0.0),
                     (a, b, (0.0, 0.0), (0.0, 0.0), lo, hi, 0.0),
                     (a, b, (0.0, 0.0), (0.0, 0.0), 0.0, 0.0, speed)]
    return rows


def describe(args: dict, seed: int) -> dict:
    """The scene as numpy arrays (see ``reference.world.build``)."""
    W, T = args["n_worlds"], args["n_edges"]
    N = M = T + 5
    heights, hull_vx = _draw(args, seed)
    V = len(HULL)
    verts = np.zeros((W, M, V, 2), np.float32)
    verts[:, :T, :2] = _edge_verts(heights)
    parts = (HULL,) + (_box(*UPPER), _box(*LOWER)) * 2
    for k, shape in enumerate(parts):
        verts[:, T + k, :len(shape)] = shape
    vel = np.zeros((W, N, 2), np.float32)
    vel[:, T, 0] = hull_vx
    rows = _joint_rows(T)
    J = len(rows)
    types = np.array([t for _, t in JOINTS], np.int32)
    pos, angle = _layout(T)
    joints = dict(
        type=types,
        body_a=np.array([r[0] for r in rows], np.int32),
        body_b=np.array([r[1] for r in rows], np.int32),
        anchor_a=np.array([r[2] for r in rows], np.float32),
        anchor_b=np.array([r[3] for r in rows], np.float32),
        rest=np.zeros(J, np.float32),
        lo=np.array([r[4] for r in rows], np.float32),
        hi=np.array([r[5] for r in rows], np.float32),
        compliance=np.zeros(J, np.float32), damping=np.zeros(J, np.float32),
        motor_speed=np.array([r[6] for r in rows], np.float32),
        motor_max=np.where(types == MOTOR, MOTORS_TORQUE,
                           np.inf).astype(np.float32),
        color=np.array(COLORS, np.int32))
    return dict(W=W, N=N, M=M, body_pos=pos, body_angle=angle,
                body_dynamic=np.arange(N) >= T, vel=vel,
                col_body=np.arange(M), col_verts=verts,
                col_nverts=np.array([2] * T + [len(s) for s in parts],
                                    np.int32),
                col_radius=np.array([SKIN] * T + [0.0] * 5),
                col_friction=np.array([TERRAIN_FRICTION] * T
                                      + [HULL_FRICTION] + [LEG_FRICTION] * 4),
                col_restitution=np.zeros(M),
                col_layer=np.array([0] * T + [PARTS_LAYER] * 5, np.int32),
                col_mask=np.array([-1] * T + [PARTS_MASK] * 5, np.int32),
                col_density=np.array([1.0] * T + [HULL_DENSITY]
                                     + [LEG_DENSITY] * 4),
                joints=joints, gravity=GRAVITY)


def program(args: dict, seed: int, device):
    """The program's world for this scene: one world from the program's
    ``WorldBuilder`` (world 0's terrain), replicated, then each world's
    terrain and hull velocity."""
    import dataclasses

    import torch
    from starframe_tpu_torch.parallel import replicate_world
    from starframe_tpu_torch.shapes import Shape
    from starframe_tpu_torch.state import WorldBuilder

    W, T = args["n_worlds"], args["n_edges"]
    heights, hull_vx = _draw(args, seed)
    ends = _edge_verts(heights)
    pos, angle = _layout(T)
    b = WorldBuilder(gravity=GRAVITY)
    for k in range(T):
        body = b.add_static(pos=pos[k])
        b.add_collider(body, Shape.segment(ends[0, k, 0], ends[0, k, 1],
                                           SKIN), friction=TERRAIN_FRICTION)
    parts = ((Shape.polygon(HULL), HULL_DENSITY, HULL_FRICTION),)
    parts += ((Shape.box(*UPPER), LEG_DENSITY, LEG_FRICTION),
              (Shape.box(*LOWER), LEG_DENSITY, LEG_FRICTION)) * 2
    for k, (shape, density, friction) in enumerate(parts):
        body = b.add_body(pos=pos[T + k], angle=float(angle[T + k]))
        b.add_collider(body, shape, friction=friction, density=density,
                       layer=PARTS_LAYER, mask=PARTS_MASK)
    for (_, t), (a, c, anchor_a, anchor_b, lo, hi, speed) in zip(
            JOINTS, _joint_rows(T)):
        if t == PIN:
            b.pin_joint(a, c, anchor_a=anchor_a, anchor_b=anchor_b)
        elif t == RANGE:
            b.angle_limit(a, c, lo, hi)
        else:
            b.angular_motor(a, c, speed=speed, max_torque=MOTORS_TORQUE)
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
