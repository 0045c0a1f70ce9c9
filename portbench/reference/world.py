"""The reference's world arrays, made from a scene description (numpy
arrays that a scene module of the benchmark draws from the seed): shapes to
padded local vertices, mass properties from the shapes at density 1, and
the flat body and collider axes of a world batch."""

from __future__ import annotations

import numpy as np
import torch

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


def build(desc: dict, device, dtype=torch.float32):
    """``(geom, state)`` of a description: ``W`` worlds of the template's
    ``N`` bodies and ``M`` colliders. Keys: ``body_pos [N, 2]``,
    ``body_angle [N]``, ``body_dynamic [N]`` bool, ``vel [W, N, 2]``
    float32, ``col_body [M]``, ``col_verts`` (a list of ``[k, 2]`` float32
    arrays), ``col_radius``, ``col_friction``, ``col_restitution [M]``,
    ``gravity``."""
    W, N, M = desc["W"], desc["N"], desc["M"]
    V = max(len(v) for v in desc["col_verts"])
    lv = np.zeros((M, V, 2), np.float32)
    nv = np.zeros(M, np.int32)
    for k, v in enumerate(desc["col_verts"]):
        lv[k, :len(v)] = v
        lv[k, len(v):] = v[0]
        nv[k] = len(v)
    mass = np.zeros(N)
    inertia = np.zeros(N)
    for k, v in enumerate(desc["col_verts"]):
        m, i = mass_properties(v, float(desc["col_radius"][k]))
        mass[desc["col_body"][k]] += m
        inertia[desc["col_body"][k]] += i
    dyn = np.asarray(desc["body_dynamic"], bool)
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

    off = (np.arange(W)[:, None] * N + np.asarray(desc["col_body"])[None])
    dyn_b = per_body(dyn, torch.bool)
    geom = dict(
        W=W, M=M, N=N,
        cbody=t(off.reshape(W * M), torch.long),
        lvx=per_col(lv[..., 0]), lvy=per_col(lv[..., 1]),
        nv=per_col(nv, torch.int32), rad=per_col(desc["col_radius"]),
        fric=per_col(desc["col_friction"]),
        rest=per_col(desc["col_restitution"]),
        sensor=per_col(np.zeros(M)), active=per_col(np.ones(M), torch.bool),
        layer=per_col(np.zeros(M), torch.int32),
        mask=per_col(np.full(M, -1), torch.int32),
        invm=per_body(invm), invi=per_body(invi),
        responds=dyn_b, moves=dyn_b,
        kinematic=torch.zeros(W * N, dtype=torch.bool, device=device))
    vel = np.asarray(desc["vel"], np.float32).reshape(W * N, 2)
    state = dict(px=per_body(desc["body_pos"][:, 0]),
                 py=per_body(desc["body_pos"][:, 1]),
                 an=per_body(desc["body_angle"]),
                 vx=t(vel[:, 0]), vy=t(vel[:, 1]),
                 om=torch.zeros(W * N, dtype=dtype, device=device),
                 sleep=torch.zeros(W * N, dtype=torch.int32, device=device))
    return geom, state


def cast(state: dict, dtype) -> dict:
    """``state`` with its float fields in ``dtype``."""
    return {k: (v.to(dtype) if k in STATE else v) for k, v in state.items()}


def cast_geom(geom: dict, dtype) -> dict:
    """``geom`` with its float arrays in ``dtype``."""
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v) for k, v in geom.items()}
