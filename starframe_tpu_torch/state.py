"""World state: fixed-capacity SoA tensors + host-side scene builder.

The PyTorch counterpart of ``starframe_tpu/state.py``. The same fields, in
the same dtypes (f32 and i32), with the same flag constants:

- :class:`World` is a frozen dataclass of tensors; every field may carry a
  leading world axis (``[W, N, 2]`` for a batch, ``[N, 2]`` for one world).
- :class:`WorldBuilder` assembles numpy arrays exactly as the JAX builder
  does and converts them once, at the end, with
  ``torch.as_tensor(..., device=)``.

Joints are rows of the same fixed-capacity SoA. The builder colours the
joint graph at build time (:func:`native.greedy_color`), as the JAX builder
does, so the frame kernel can run one Gauss-Seidel pass per colour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import Capacity
from .native import greedy_color
from .shapes import Shape

# Body flags
BODY_ACTIVE = 1
BODY_KINEMATIC = 2
BODY_DYNAMIC = 4  # declared dynamic (may transiently be massless at spawn)
BODY_BULLET = 8  # continuous collision: TOI-clamp this body's advance

# Collider flags
COL_ACTIVE = 1
COL_SENSOR = 2

# Joint types (stored in Joints.jtype)
JOINT_OFF = 0
JOINT_DISTANCE = 1  # |pa - pb| constrained into [lo, hi]
JOINT_PIN = 2  # pa == pb (2-dof point attachment / revolute)
JOINT_ANGLE_RANGE = 3  # relative angle constrained into [lo, hi]
JOINT_ANGULAR_MOTOR = 4  # drive relative angular velocity to motor_speed
JOINT_WELD = 5  # pin + relative angle locked to `rest`


@dataclasses.dataclass(frozen=True)
class Bodies:
    """Rigid-body dynamic state, SoA over the body axis ``[..., N]``."""

    pos: torch.Tensor  # [..., N, 2] f32
    angle: torch.Tensor  # [..., N] f32
    vel: torch.Tensor  # [..., N, 2] f32
    ang_vel: torch.Tensor  # [..., N] f32
    inv_mass: torch.Tensor  # [..., N] f32
    inv_inertia: torch.Tensor  # [..., N] f32
    flags: torch.Tensor  # [..., N] i32
    prev_pos: torch.Tensor  # [..., N, 2] f32
    prev_angle: torch.Tensor  # [..., N] f32
    sleep_count: torch.Tensor  # [..., N] i32

    @property
    def active(self):
        return (self.flags & BODY_ACTIVE) != 0

    @property
    def n(self) -> int:
        return self.pos.shape[-2]


@dataclasses.dataclass(frozen=True)
class Colliders:
    """Collision shapes (rounded convex polygons), SoA over ``[..., M]``."""

    body_idx: torch.Tensor  # [..., M] i32 (owning body)
    verts: torch.Tensor  # [..., M, V, 2] f32 core vertices, CCW, body frame
    nverts: torch.Tensor  # [..., M] i32 (1..V)
    radius: torch.Tensor  # [..., M] f32 dilation radius (>= 0)
    friction: torch.Tensor  # [..., M] f32
    restitution: torch.Tensor  # [..., M] f32
    layer: torch.Tensor  # [..., M] i32 collision layer index (0..31)
    mask: torch.Tensor  # [..., M] i32 bitmask of layers this collider hits
    flags: torch.Tensor  # [..., M] i32

    @property
    def active(self):
        return (self.flags & COL_ACTIVE) != 0

    @property
    def is_sensor(self):
        return (self.flags & COL_SENSOR) != 0

    @property
    def m(self) -> int:
        return self.verts.shape[-3]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[-2]


@dataclasses.dataclass(frozen=True)
class Joints:
    """User constraints (distance/pin/weld joints, angle limits, motors)."""

    jtype: torch.Tensor  # [..., J] i32
    body_a: torch.Tensor  # [..., J] i32
    body_b: torch.Tensor  # [..., J] i32
    anchor_a: torch.Tensor  # [..., J, 2] f32 (body-local)
    anchor_b: torch.Tensor  # [..., J, 2] f32 (body-local)
    rest: torch.Tensor  # [..., J] f32
    lo: torch.Tensor  # [..., J] f32
    hi: torch.Tensor  # [..., J] f32
    compliance: torch.Tensor  # [..., J] f32
    damping: torch.Tensor  # [..., J] f32
    motor_speed: torch.Tensor  # [..., J] f32
    motor_max: torch.Tensor  # [..., J] f32
    color: torch.Tensor  # [..., J] i32 graph-colouring batch index

    @property
    def active(self):
        return self.jtype != JOINT_OFF

    @property
    def j(self) -> int:
        return self.jtype.shape[-1]


@dataclasses.dataclass(frozen=True)
class World:
    """The whole simulation state."""

    bodies: Bodies
    colliders: Colliders
    joints: Joints
    gravity: torch.Tensor  # [..., 2] f32
    step_count: torch.Tensor  # [...] i32


def map_world(fn, world: World) -> World:
    """Apply ``fn`` to every tensor of ``world`` (the pytree map of the JAX
    package, written out for the four dataclasses)."""
    def each(obj):
        return dataclasses.replace(
            obj, **{f.name: fn(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)})

    return World(
        bodies=each(world.bodies), colliders=each(world.colliders),
        joints=each(world.joints), gravity=fn(world.gravity),
        step_count=fn(world.step_count))


def _empty_arrays(cap: Capacity, gravity) -> dict:
    """numpy arrays of an all-inactive world, keyed like ``io`` keys."""
    nb, nc, nj, nv = (cap.max_bodies, cap.max_colliders, cap.max_joints,
                      cap.max_verts)
    f32, i32 = np.float32, np.int32
    return {
        "bodies/pos": np.zeros((nb, 2), f32),
        "bodies/angle": np.zeros(nb, f32),
        "bodies/vel": np.zeros((nb, 2), f32),
        "bodies/ang_vel": np.zeros(nb, f32),
        "bodies/inv_mass": np.zeros(nb, f32),
        "bodies/inv_inertia": np.zeros(nb, f32),
        "bodies/flags": np.zeros(nb, i32),
        "bodies/prev_pos": np.zeros((nb, 2), f32),
        "bodies/prev_angle": np.zeros(nb, f32),
        "bodies/sleep_count": np.zeros(nb, i32),
        "colliders/body_idx": np.zeros(nc, i32),
        "colliders/verts": np.zeros((nc, nv, 2), f32),
        "colliders/nverts": np.ones(nc, i32),
        "colliders/radius": np.zeros(nc, f32),
        "colliders/friction": np.full(nc, 0.5, f32),
        "colliders/restitution": np.zeros(nc, f32),
        "colliders/layer": np.zeros(nc, i32),
        "colliders/mask": np.full(nc, -1, i32),
        "colliders/flags": np.zeros(nc, i32),
        "joints/jtype": np.zeros(nj, i32),
        "joints/body_a": np.zeros(nj, i32),
        "joints/body_b": np.zeros(nj, i32),
        "joints/anchor_a": np.zeros((nj, 2), f32),
        "joints/anchor_b": np.zeros((nj, 2), f32),
        "joints/rest": np.zeros(nj, f32),
        "joints/lo": np.zeros(nj, f32),
        "joints/hi": np.zeros(nj, f32),
        "joints/compliance": np.zeros(nj, f32),
        "joints/damping": np.zeros(nj, f32),
        "joints/motor_speed": np.zeros(nj, f32),
        "joints/motor_max": np.full(nj, np.inf, f32),
        "joints/color": np.zeros(nj, i32),
        "gravity": np.asarray(gravity, f32),
        "step_count": np.zeros((), i32),
    }


def empty_world(cap: Capacity, gravity=(0.0, -9.81), device="cuda") -> World:
    """An all-inactive world with the given capacities, on ``device`` (the
    card unless the caller asks for the CPU)."""
    from .io import world_from_numpy

    return world_from_numpy(_empty_arrays(cap, gravity), device)


class WorldBuilder:
    """Host-side scene construction (numpy), producing a :class:`World`.

    The same API and the same arrays as ``starframe_tpu.state.WorldBuilder``
    for bodies, colliders and joints; mass and inertia come from the
    attached collider shapes unless overridden.
    """

    def __init__(self, gravity=(0.0, -9.81)):
        self.gravity = tuple(gravity)
        self._bodies: list[dict] = []
        self._colliders: list[dict] = []
        self._joints: list[dict] = []

    # -- bodies -----------------------------------------------------------

    def add_body(self, pos=(0.0, 0.0), angle: float = 0.0, vel=(0.0, 0.0),
                 ang_vel: float = 0.0, body_type: str = "dynamic",
                 mass: Optional[float] = None,
                 inertia: Optional[float] = None,
                 bullet: bool = False) -> int:
        if body_type not in ("dynamic", "static", "kinematic"):
            raise ValueError(f"unknown body_type {body_type!r}")
        self._bodies.append(dict(
            pos=np.asarray(pos, np.float32), angle=float(angle),
            vel=np.asarray(vel, np.float32), ang_vel=float(ang_vel),
            body_type=body_type, mass=mass, inertia=inertia,
            bullet=bool(bullet)))
        return len(self._bodies) - 1

    def add_static(self, pos=(0.0, 0.0), angle: float = 0.0) -> int:
        return self.add_body(pos=pos, angle=angle, body_type="static")

    def add_particle(self, pos, mass: float, vel=(0.0, 0.0)) -> int:
        """Point-mass body (no rotational dof)."""
        return self.add_body(pos=pos, vel=vel, mass=mass, inertia=np.inf)

    # -- colliders ---------------------------------------------------------

    def add_collider(self, body: int, shape: Shape, friction: float = 0.5,
                     restitution: float = 0.0, density: float = 1.0,
                     layer: int = 0, mask: int = -1, sensor: bool = False,
                     offset=(0.0, 0.0), offset_angle: float = 0.0) -> int:
        """Attach a collider to ``body``; the offset pose is baked into the
        stored vertices."""
        off = np.asarray(offset, np.float32)
        c, s = np.cos(offset_angle), np.sin(offset_angle)
        rot = np.array([[c, -s], [s, c]], np.float32)
        verts = shape.verts @ rot.T + off
        self._colliders.append(dict(
            body=int(body), verts=verts.astype(np.float32),
            radius=float(shape.radius), friction=float(friction),
            restitution=float(restitution), density=float(density),
            layer=int(layer), mask=int(mask), sensor=bool(sensor)))
        return len(self._colliders) - 1

    # -- joints -------------------------------------------------------------

    def _add_joint(self, **kw) -> int:
        row = dict(jtype=JOINT_OFF, body_a=0, body_b=0, anchor_a=(0.0, 0.0),
                   anchor_b=(0.0, 0.0), rest=0.0, lo=0.0, hi=0.0,
                   compliance=0.0, damping=0.0, motor_speed=0.0,
                   motor_max=np.inf)
        row.update(kw)
        if row["anchor_a"] is None or row["anchor_b"] is None:
            # a None anchor would become NaN and poison the whole solve
            raise ValueError(
                "joint anchors must not be None: pass world_point or "
                "explicit anchor_a/anchor_b")
        self._joints.append(row)
        return len(self._joints) - 1

    def distance_joint(self, body_a: int, body_b: int, anchor_a=(0.0, 0.0),
                       anchor_b=(0.0, 0.0), rest: Optional[float] = None,
                       limits: Optional[tuple] = None,
                       compliance: float = 0.0, damping: float = 0.0) -> int:
        """Distance constraint between body-local anchor points; with
        ``limits=(lo, hi)`` the length is only held inside that range."""
        if rest is None:
            pa = self._world_anchor(body_a, anchor_a)
            pb = self._world_anchor(body_b, anchor_b)
            rest = float(np.linalg.norm(pa - pb))
        lo, hi = limits if limits is not None else (rest, rest)
        return self._add_joint(
            jtype=JOINT_DISTANCE, body_a=body_a, body_b=body_b,
            anchor_a=anchor_a, anchor_b=anchor_b, rest=rest, lo=lo, hi=hi,
            compliance=compliance, damping=damping)

    def _point_anchors(self, body_a, body_b, world_point, anchor_a,
                       anchor_b):
        """Anchors of a point joint: from a world point (the bodies'
        midpoint when nothing is given) or as passed."""
        if world_point is None and anchor_a is None and anchor_b is None:
            world_point = 0.5 * (np.asarray(self._bodies[body_a]["pos"])
                                 + np.asarray(self._bodies[body_b]["pos"]))
        if world_point is not None:
            anchor_a = self._local_anchor(body_a, world_point)
            anchor_b = self._local_anchor(body_b, world_point)
        return anchor_a, anchor_b

    def pin_joint(self, body_a: int, body_b: int, world_point=None,
                  anchor_a=None, anchor_b=None, compliance: float = 0.0,
                  damping: float = 0.0) -> int:
        """Point attachment (revolute joint): the two anchors coincide and
        rotation stays free."""
        anchor_a, anchor_b = self._point_anchors(body_a, body_b, world_point,
                                                 anchor_a, anchor_b)
        return self._add_joint(
            jtype=JOINT_PIN, body_a=body_a, body_b=body_b, anchor_a=anchor_a,
            anchor_b=anchor_b, compliance=compliance, damping=damping)

    def weld_joint(self, body_a, body_b, world_point=None, anchor_a=None,
                   anchor_b=None, compliance: float = 0.0) -> int:
        """Pin + relative angle locked at its build-time value."""
        anchor_a, anchor_b = self._point_anchors(body_a, body_b, world_point,
                                                 anchor_a, anchor_b)
        rel = self._bodies[body_b]["angle"] - self._bodies[body_a]["angle"]
        return self._add_joint(
            jtype=JOINT_WELD, body_a=body_a, body_b=body_b, anchor_a=anchor_a,
            anchor_b=anchor_b, rest=rel, compliance=compliance)

    def angle_limit(self, body_a, body_b, lo, hi,
                    compliance: float = 0.0) -> int:
        """Constrain the relative angle (angle_b - angle_a) into [lo, hi]."""
        return self._add_joint(jtype=JOINT_ANGLE_RANGE, body_a=body_a,
                               body_b=body_b, lo=lo, hi=hi,
                               compliance=compliance)

    def angular_motor(self, body_a, body_b, speed, max_torque=np.inf) -> int:
        """Drive the relative angular velocity (w_b - w_a) toward ``speed``
        within a torque budget."""
        return self._add_joint(jtype=JOINT_ANGULAR_MOTOR, body_a=body_a,
                               body_b=body_b, motor_speed=speed,
                               motor_max=max_torque)

    def _world_anchor(self, body: int, local) -> np.ndarray:
        b = self._bodies[body]
        c, s = np.cos(b["angle"]), np.sin(b["angle"])
        la = np.asarray(local, np.float32)
        return b["pos"] + np.array([c * la[0] - s * la[1],
                                    s * la[0] + c * la[1]])

    def _local_anchor(self, body: int, world) -> np.ndarray:
        b = self._bodies[body]
        c, s = np.cos(-b["angle"]), np.sin(-b["angle"])
        d = np.asarray(world, np.float32) - b["pos"]
        return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]],
                        np.float32)

    # -- build ---------------------------------------------------------------

    def _collider_extents(self, margin: float = 0.05):
        """Host-side per-collider AABB extents and centres at build poses
        (numpy)."""
        exts = []
        centers = []
        for c in self._colliders:
            b = self._bodies[c["body"]]
            co, si = np.cos(b["angle"]), np.sin(b["angle"])
            rot = np.array([[co, -si], [si, co]], np.float32)
            wv = c["verts"] @ rot.T + b["pos"]
            lo = wv.min(0) - c["radius"] - margin
            hi = wv.max(0) + c["radius"] + margin
            exts.append(hi - lo)
            centers.append((lo + hi) / 2)
        return np.asarray(exts, np.float32), np.asarray(centers, np.float32)

    def suggest_grid_cell_capacity(self, margin: float = 0.05) -> int:
        """Grid-broadphase per-cell fan-out from the scene's size
        distribution: how many of the smallest colliders can crowd one
        broadphase cell when packed. Scenes pass this to
        ``SolverConfig(grid_cell_capacity=...)``."""
        if not self._colliders:
            return 8
        exts, _ = self._collider_extents(margin)
        max_ext = exts.max(-1)
        cell = 1.5 * float(np.mean(max_ext))
        small = float(np.percentile(max_ext, 10))
        # the smallest colliders tile a (cell + ext)^2 window whose centres
        # hash to one cell; 1.2x safety over the packing bound
        packed = (cell / max(small, 1e-3) + 1.0) ** 2
        return int(max(8, np.ceil(1.2 * packed)))

    def _auto_capacity(self, cap: Optional[Capacity],
                       reserve=(0, 0, 0)) -> Capacity:
        nb = len(self._bodies) + reserve[0]
        nc = len(self._colliders) + reserve[1]
        nj = len(self._joints) + reserve[2]
        nv = max([2] + [len(c["verts"]) for c in self._colliders])
        if cap is not None:
            if (cap.max_bodies < nb or cap.max_colliders < nc
                    or cap.max_joints < nj or cap.max_verts < nv):
                raise ValueError("capacity too small for scene")
            return cap
        max_pairs = -(-max(4 * nc, 64) // 512) * 512
        return Capacity(max_bodies=max(nb, 1), max_colliders=max(nc, 1),
                        max_pairs=max_pairs, max_joints=nj, max_verts=nv)

    def build(self, capacity: Optional[Capacity] = None,
              reserve_bodies: int = 0, reserve_colliders: int = 0,
              reserve_joints: int = 0, device="cuda"
              ) -> tuple[World, Capacity]:
        """Materialize the scene on ``device`` (the card unless the caller
        asks for the CPU; without a card the default raises)."""
        cap = self._auto_capacity(
            capacity, (reserve_bodies, reserve_colliders, reserve_joints))
        arrays = _empty_arrays(cap, self.gravity)

        mass = np.zeros(len(self._bodies), np.float64)
        inertia = np.zeros(len(self._bodies), np.float64)
        for c in self._colliders:
            if c["sensor"]:
                continue
            sh = Shape(verts=c["verts"], radius=c["radius"])
            m, i_origin = sh.mass_properties(c["density"])
            mass[c["body"]] += m
            inertia[c["body"]] += i_origin

        b_pos = arrays["bodies/pos"]
        for i, b in enumerate(self._bodies):
            b_pos[i] = b["pos"]
            arrays["bodies/angle"][i] = b["angle"]
            arrays["bodies/vel"][i] = b["vel"]
            arrays["bodies/ang_vel"][i] = b["ang_vel"]
            arrays["bodies/flags"][i] = (
                BODY_ACTIVE
                | (BODY_KINEMATIC if b["body_type"] == "kinematic" else 0)
                | (BODY_DYNAMIC if b["body_type"] == "dynamic" else 0)
                | (BODY_BULLET if b["bullet"] else 0))
            if b["body_type"] == "dynamic":
                m = b["mass"] if b["mass"] is not None else mass[i]
                inr = b["inertia"] if b["inertia"] is not None else inertia[i]
                if m <= 0:
                    raise ValueError(f"dynamic body {i} has no mass (attach "
                                     "a collider or pass mass=)")
                arrays["bodies/inv_mass"][i] = 1.0 / m
                arrays["bodies/inv_inertia"][i] = (
                    0.0 if np.isinf(inr) else (1.0 / inr if inr > 0 else 0.0))
        arrays["bodies/prev_pos"] = b_pos.copy()
        arrays["bodies/prev_angle"] = arrays["bodies/angle"].copy()

        for i, c in enumerate(self._colliders):
            v = c["verts"]
            arrays["colliders/body_idx"][i] = c["body"]
            arrays["colliders/verts"][i, : len(v)] = v
            # pad unused vertex slots with the first vertex so min/max scans
            # over the full buffer stay exact without masking
            arrays["colliders/verts"][i, len(v):] = v[0]
            arrays["colliders/nverts"][i] = len(v)
            arrays["colliders/radius"][i] = c["radius"]
            arrays["colliders/friction"][i] = c["friction"]
            arrays["colliders/restitution"][i] = c["restitution"]
            arrays["colliders/layer"][i] = c["layer"]
            arrays["colliders/mask"][i] = c["mask"]
            arrays["colliders/flags"][i] = (
                COL_ACTIVE | (COL_SENSOR if c["sensor"] else 0))

        keys = ("jtype", "body_a", "body_b", "anchor_a", "anchor_b", "rest",
                "lo", "hi", "compliance", "damping", "motor_speed",
                "motor_max")
        for i, row in enumerate(self._joints):
            for k in keys:
                arrays[f"joints/{k}"][i] = row[k]
        nj = len(self._joints)
        if nj > 0:
            # static bodies never conflict: no impulse moves them
            flags = arrays["bodies/flags"]
            body_static = ((arrays["bodies/inv_mass"] == 0.0)
                           & (arrays["bodies/inv_inertia"] == 0.0)
                           & ((flags & BODY_KINEMATIC) == 0))
            jtype = arrays["joints/jtype"][:nj]
            arrays["joints/color"][:nj], _ = greedy_color(
                arrays["joints/body_a"][:nj], arrays["joints/body_b"][:nj],
                active=jtype != JOINT_OFF, body_is_static=body_static,
                n_bodies=cap.max_bodies)

        from .io import world_from_numpy

        return world_from_numpy(arrays, device), cap


def expand_capacity(world: World, extra_bodies: int = 0,
                    extra_colliders: int = 0, extra_joints: int = 0) -> World:
    """Grow a single world's capacities by appending inactive rows."""
    cap = Capacity(
        max_bodies=world.bodies.n + extra_bodies,
        max_colliders=world.colliders.m + extra_colliders,
        max_pairs=1,
        max_joints=world.joints.j + extra_joints,
        max_verts=world.colliders.max_verts,
    )
    blank = empty_world(cap, device=world.gravity.device)

    def pad(old, new):
        if old.shape == new.shape:
            return old
        n_extra = new.shape[0] - old.shape[0]
        return torch.cat([old, new[new.shape[0] - n_extra:]], dim=0)

    def pad_all(old_obj, new_obj):
        return dataclasses.replace(old_obj, **{
            f.name: pad(getattr(old_obj, f.name), getattr(new_obj, f.name))
            for f in dataclasses.fields(old_obj)})

    return dataclasses.replace(
        world, bodies=pad_all(world.bodies, blank.bodies),
        colliders=pad_all(world.colliders, blank.colliders),
        joints=pad_all(world.joints, blank.joints))
