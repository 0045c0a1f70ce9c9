"""Joints in the plain reference: the engine's user constraints, written
from its stated semantics (the XPBD substep's coloured joint passes and its
velocity pass) over a flat joint axis ``[W * J]`` whose body indices are
flat too (a world's joints never leave it).

Semantics, as the engine states them: in each substep and iteration, after
the contact projection is applied, the joint rows are projected one colour
after another in ascending ``color``, the last pass taking every colour at
or above ``joint_colors - 1``. Within a pass each body's corrections are
summed over its rows and divided by its count of active rows, with no
relaxation, and clipped at the configuration's raw ``max_dpos`` (joints are
constraint upkeep, not depenetration). Pin, weld and distance rows act on
the gap between the anchors (pin and weld hold it at 0, distance inside
``[lo, hi]``); weld and angle range act on the wrapped relative angle
``angle_b - angle_a - rest`` (weld holds it at 0, angle range inside
``[lo, hi]``). Compliance is ``compliance / h^2``. In the velocity pass an
angular motor drives ``w_b - w_a`` toward ``motor_speed`` with an impulse
clipped at ``motor_max * h``, and a damped row bleeds the anchors' relative
velocity by ``min(damping * h, 1)``; both are summed into the contacts'
velocity accumulation, counts included.

A motor's ``motor_speed`` and ``motor_max`` are per-call parameters: a
state dict may carry them (``STATE``), and they then take the place of the
scene's."""

from __future__ import annotations

import math

import numpy as np
import torch

DISTANCE, PIN, ANGLE_RANGE, ANGULAR_MOTOR, WELD = 1, 2, 3, 4, 5
EPS = 1e-10
# the joint parameters a state dict may carry (a control rewrites them)
STATE = ("motor_speed", "motor_max")
FLOATS = ("rest", "lo", "hi", "compliance", "damping", "motor_speed",
          "motor_max")


def build(joints: dict, W: int, N: int, device, dtype) -> dict:
    """Flat ``[W * J]`` tensors of a description's ``joints`` (each a
    ``[J]`` or ``[W, J]`` array; anchors ``[J, 2]`` or ``[W, J, 2]``)."""
    J = np.asarray(joints["type"]).shape[-1]

    def flat(key, dt):
        x = np.asarray(joints[key])
        tail = x.shape[x.ndim - (2 if key.startswith("anchor") else 1):]
        x = np.broadcast_to(x, (W,) + tail).reshape((W * J,) + tail[1:])
        return torch.as_tensor(np.array(x), device=device).to(dt)

    off = torch.arange(W, device=device).repeat_interleave(J) * N
    out = {k: flat(k, dtype) for k in FLOATS}
    aa, ab = flat("anchor_a", dtype), flat("anchor_b", dtype)
    out.update(type=flat("type", torch.int32), color=flat("color",
                                                          torch.int32),
               ba=flat("body_a", torch.long) + off,
               bb=flat("body_b", torch.long) + off,
               aax=aa[:, 0].contiguous(), aay=aa[:, 1].contiguous(),
               abx=ab[:, 0].contiguous(), aby=ab[:, 1].contiguous())
    return out


def _safe_div(num, den):
    return torch.where(den > EPS, num / torch.clamp(den, min=EPS),
                       torch.zeros_like(num))


def _wrap(a):
    """``a`` wrapped to ``(-pi, pi]``."""
    return a - 2.0 * math.pi * torch.round(a / (2.0 * math.pi))


def _arms(jg, px, py, an):
    """Each row's world anchor offsets from its bodies' origins and the
    anchors' gap: ``(rax, ray, rbx, rby, dx, dy)``."""
    ba, bb = jg["ba"], jg["bb"]
    ca, sa = torch.cos(an[ba]), torch.sin(an[ba])
    cb, sb = torch.cos(an[bb]), torch.sin(an[bb])
    rax = ca * jg["aax"] - sa * jg["aay"]
    ray = sa * jg["aax"] + ca * jg["aay"]
    rbx = cb * jg["abx"] - sb * jg["aby"]
    rby = sb * jg["abx"] + cb * jg["aby"]
    dx = (px[bb] + rbx) - (px[ba] + rax)
    dy = (py[bb] + rby) - (py[ba] + ray)
    return rax, ray, rbx, rby, dx, dy


def _to_bodies(n: int, jg, a_vals, b_vals):
    """Per-body sums ``[4, n]`` of the rows' ``(dx, dy, dang, count)`` for
    endpoint ``a`` and for endpoint ``b``."""
    a = torch.stack(a_vals)
    out = torch.zeros((4, n), dtype=a.dtype, device=a.device)
    out.index_add_(1, jg["ba"], a)
    out.index_add_(1, jg["bb"], torch.stack(b_vals))
    return out


def position_sums(jg, sel, px, py, an, invm, invi, h: float):
    """One pass of the position projection over the rows ``sel`` picks:
    the per-body sums ``[4, n]`` (dx, dy, dang, count)."""
    ba, bb, jt = jg["ba"], jg["bb"], jg["type"]
    ima, imb, iia, iib = invm[ba], invm[bb], invi[ba], invi[bb]
    rax, ray, rbx, rby, dx, dy = _arms(jg, px, py, an)
    d = torch.sqrt(dx * dx + dy * dy)
    nx = dx / torch.clamp(d, min=EPS)
    ny = dy / torch.clamp(d, min=EPS)
    zero = torch.zeros_like(d)
    is_dist = jt == DISTANCE
    is_point = (jt == PIN) | (jt == WELD)
    lo = torch.where(is_point, zero, jg["lo"])
    hi = torch.where(is_point, zero, jg["hi"])
    c = torch.where(d > hi, d - hi, torch.where(d < lo, d - lo, zero))
    lin = (is_dist | is_point) & (torch.abs(c) > 0.0) & (d > EPS) & sel
    cra, crb = rax * ny - ray * nx, rbx * ny - rby * nx
    alpha = jg["compliance"] / (h * h)
    den = ima + iia * cra * cra + (imb + iib * crb * crb) + alpha
    dlam = torch.where(lin, _safe_div(-c, den), zero)
    pxi, pyi = dlam * nx, dlam * ny
    phi = _wrap(an[bb] - an[ba] - jg["rest"])
    is_weld = jt == WELD
    c_ang = torch.where(is_weld, phi, torch.where(
        phi > jg["hi"], phi - jg["hi"], torch.where(
            phi < jg["lo"], phi - jg["lo"], zero)))
    ang = (is_weld | (jt == ANGLE_RANGE)) & (torch.abs(c_ang) > 0.0) & sel
    dlam_a = torch.where(ang, _safe_div(-c_ang, iia + iib + alpha), zero)
    cnt = lin.to(d.dtype) + ang.to(d.dtype)
    return _to_bodies(
        px.shape[0], jg,
        (-pxi * ima, -pyi * ima,
         -iia * (rax * pyi - ray * pxi) - dlam_a * iia, cnt),
        (pxi * imb, pyi * imb, iib * (rbx * pyi - rby * pxi) + dlam_a * iib,
         cnt))


def velocity_sums(jg, motor_speed, motor_max, px, py, an, vx, vy, om, invm,
                  invi, h: float):
    """The motors' and the damped rows' velocity changes as per-body sums
    ``[4, n]`` (dvx, dvy, dw, count)."""
    ba, bb, jt = jg["ba"], jg["bb"], jg["type"]
    ima, imb, iia, iib = invm[ba], invm[bb], invi[ba], invi[bb]
    motor = jt == ANGULAR_MOTOR
    lam = _safe_div(motor_speed - (om[bb] - om[ba]), iia + iib)
    lam = torch.minimum(torch.maximum(lam, -motor_max * h), motor_max * h)
    lam = torch.where(motor, lam, torch.zeros_like(lam))
    damped = (jt != 0) & (jg["damping"] > 0.0)
    rax, ray, rbx, rby, _, _ = _arms(jg, px, py, an)
    ux = vx[bb] - om[bb] * rby - (vx[ba] - om[ba] * ray)
    uy = vy[bb] + om[bb] * rbx - (vy[ba] + om[ba] * rax)
    f = _safe_div(torch.clamp(jg["damping"] * h, max=1.0), ima + imb)
    zero = torch.zeros_like(ux)
    pdx = torch.where(damped, -ux * f, zero)
    pdy = torch.where(damped, -uy * f, zero)
    cnt = (motor | damped).to(ux.dtype)
    return _to_bodies(
        px.shape[0], jg,
        (-pdx * ima, -pdy * ima, -lam * iia - iia * (rax * pdy - ray * pdx),
         cnt),
        (pdx * imb, pdy * imb, lam * iib + iib * (rbx * pdy - rby * pdx),
         cnt))


def count(jg, invm, invi, stats: dict) -> None:
    """Add a frame's joint counts to ``stats``: ``joints``, the rows solved
    (active, with an end that moves), and ``max_joint_rows``, the most
    active rows on one body (what its joint slots have to hold)."""
    act = jg["type"] != 0
    moves = (invm > 0) | (invi > 0)
    live = act & (moves[jg["ba"]] | moves[jg["bb"]])
    stats["joints"] = stats.get("joints", 0) + int(live.sum())
    ends = torch.cat([jg["ba"][act], jg["bb"][act]])
    top = int(torch.bincount(ends).max()) if ends.numel() else 0
    stats["max_joint_rows"] = max(stats.get("max_joint_rows", 0), top)
