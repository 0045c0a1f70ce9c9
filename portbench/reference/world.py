"""The reference's world arrays, made from a scene description (numpy
arrays that a scene module of the benchmark draws from the seed): shapes to
padded local vertices, mass properties from the shapes (at density 1 unless
the description gives densities), collision layers, joints, and the flat
body, collider and joint axes of a world batch."""

from __future__ import annotations

import numpy as np
import torch

from . import joints as ref_joints
from .frame import STATE


def mass_properties(verts: np.ndarray, radius: float, density: float = 1.0):
    """``(mass, inertia about the body origin)`` in float64 of a circle (one
    vertex) or a sharp convex polygon (CCW vertices)."""
    v = verts.astype(np.float64)
    if len(v) == 1:
        m = density * np.pi * radius * radius
        return m, m * (0.5 * radius * radius + v[0] @ v[0])
    if radius != 0.0:
        raise NotImplementedError("rounded polygons have no reference mass")
    q = np.roll(v, -1, axis=0)
    cross = v[:, 0] * q[:, 1] - v[:, 1] * q[:, 0]
    m = 0.5 * density * cross.sum()
    inertia = density / 12.0 * (cross * ((v * v).sum(1) + (v * q).sum(1)
                                         + (q * q).sum(1))).sum()
    return m, inertia


def _body_masses(verts, desc: dict, cols) -> tuple:
    """``(mass, inertia [N])`` of one world's bodies from the colliders
    ``cols`` (those of dynamic bodies) of its vertex lists ``verts``."""
    mass, inertia = np.zeros(desc["N"]), np.zeros(desc["N"])
    density = desc.get("col_density")
    for k in cols:
        m, i = mass_properties(verts[k], float(desc["col_radius"][k]),
                               1.0 if density is None else float(density[k]))
        mass[desc["col_body"][k]] += m
        inertia[desc["col_body"][k]] += i
    return mass, inertia


def build(desc: dict, device, dtype=torch.float32):
    """``(geom, state)`` of a description: ``W`` worlds of the template's
    ``N`` bodies and ``M`` colliders. Keys: ``body_pos [N, 2]``,
    ``body_angle [N]``, ``body_dynamic [N]`` bool, ``vel [W, N, 2]``
    float32, ``col_body [M]``, ``col_verts`` (a list of ``[k, 2]`` float32
    arrays), ``col_radius``, ``col_friction``, ``col_restitution [M]``,
    ``gravity``. Optional keys, each absent in a world of one contact
    layer at density 1 with no joints:

    - ``col_layer``, ``col_mask [M]`` int32: the collision layer (0-31) and
      the mask of layers a collider hits (default 0 and -1);
    - ``col_density [M]``: mass and inertia are density times the shape's;
    - ``col_verts`` as one ``[W, M, V, 2]`` float32 array, padded with each
      shape's first vertex, with ``col_nverts [M]``: each world's own
      geometry (its terrain); mass properties are then each world's;
    - ``joints``: a dict of ``[J]`` or ``[W, J]`` arrays in the engine's
      model: ``type`` (``reference.joints``' numbers), ``body_a``,
      ``body_b``, body-local ``anchor_a`` and ``anchor_b`` (``[..., 2]``),
      ``rest``, ``lo``, ``hi``, ``compliance``, ``damping``,
      ``motor_speed``, ``motor_max`` and ``color``; ``geom["joints"]``
      then holds them flat (``reference.joints.build``).

    On the card the reference's float32 stays float32: TF32 is turned off
    for matrix products and convolutions."""
    W, N, M = desc["W"], desc["N"], desc["M"]
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dyn = np.asarray(desc["body_dynamic"], bool)
    cols = [k for k in range(M) if dyn[desc["col_body"][k]]]
    per_world = isinstance(desc["col_verts"], np.ndarray)
    if per_world:
        lv = desc["col_verts"].astype(np.float32)
        nv = np.asarray(desc["col_nverts"], np.int32)
        for k in range(M):
            lv[:, k, nv[k]:] = lv[:, k, :1]
        mass, inertia = (np.stack(x) for x in zip(*(
            _body_masses({k: lv[w, k, :nv[k]] for k in cols}, desc, cols)
            for w in range(W))))
    else:
        V = max(len(v) for v in desc["col_verts"])
        lv = np.zeros((M, V, 2), np.float32)
        nv = np.zeros(M, np.int32)
        for k, v in enumerate(desc["col_verts"]):
            lv[k, :len(v)] = v
            lv[k, len(v):] = v[0]
            nv[k] = len(v)
        mass, inertia = _body_masses(desc["col_verts"], desc, cols)
    invm = np.where(dyn, 1.0 / np.where(dyn, mass, 1.0), 0.0).astype(
        np.float32)
    invi = np.where(dyn & (inertia > 0),
                    1.0 / np.where(inertia > 0, inertia, 1.0), 0.0).astype(
        np.float32)

    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), device=device).to(dt)

    def per_body(x, dt=dtype):
        return t(np.broadcast_to(x, (W, N)).reshape(W * N), dt)

    def per_col(x, dt=dtype):
        x = np.asarray(x)
        return t(np.broadcast_to(x, (W,) + x.shape).reshape((W * M,)
                                                             + x.shape[1:]),
                 dt)

    def verts(x):
        return t(x.reshape(W * M, -1)) if per_world else per_col(x)

    off = (np.arange(W)[:, None] * N + np.asarray(desc["col_body"])[None])
    dyn_b = per_body(dyn, torch.bool)
    geom = dict(
        W=W, M=M, N=N,
        cbody=t(off.reshape(W * M), torch.long),
        lvx=verts(lv[..., 0]), lvy=verts(lv[..., 1]),
        nv=per_col(nv, torch.int32), rad=per_col(desc["col_radius"]),
        fric=per_col(desc["col_friction"]),
        rest=per_col(desc["col_restitution"]),
        sensor=per_col(np.zeros(M)), active=per_col(np.ones(M), torch.bool),
        layer=per_col(desc.get("col_layer", np.zeros(M)), torch.int32),
        mask=per_col(desc.get("col_mask", np.full(M, -1)), torch.int32),
        invm=per_body(invm), invi=per_body(invi),
        responds=dyn_b, moves=dyn_b,
        kinematic=torch.zeros(W * N, dtype=torch.bool, device=device))
    if "joints" in desc:
        geom["joints"] = ref_joints.build(desc["joints"], W, N, device,
                                          dtype)
    vel = np.asarray(desc["vel"], np.float32).reshape(W * N, 2)
    state = dict(px=per_body(desc["body_pos"][:, 0]),
                 py=per_body(desc["body_pos"][:, 1]),
                 an=per_body(desc["body_angle"]),
                 vx=t(vel[:, 0]), vy=t(vel[:, 1]),
                 om=torch.zeros(W * N, dtype=dtype, device=device),
                 sleep=torch.zeros(W * N, dtype=torch.int32, device=device))
    return geom, state


def shapes(desc: dict) -> dict:
    """The batch's counts of bodies, colliders and joint rows, and the
    most vertices a collider has (the roofline counts' shapes)."""
    verts = desc["col_verts"]
    V = (verts.shape[2] if isinstance(verts, np.ndarray)
         else max(len(v) for v in verts))
    J = (np.asarray(desc["joints"]["type"]).shape[-1] if "joints" in desc
         else 0)
    W = desc["W"]
    return dict(colliders=desc["M"] * W, bodies=desc["N"] * W, verts=V,
                joints=J * W)


def cast(state: dict, dtype) -> dict:
    """``state`` with its float fields (the bodies' and the joints' per-call
    parameters) in ``dtype``."""
    return {k: (v.to(dtype) if k in STATE or k in ref_joints.STATE else v)
            for k, v in state.items()}


def cast_geom(geom: dict, dtype) -> dict:
    """``geom`` with its float arrays (the joints' too) in ``dtype``."""
    return {k: (cast_geom(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v) for k, v in geom.items()}
