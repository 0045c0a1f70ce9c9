"""Contact and joint math over any trailing shape: narrowphase manifold,
XPBD contact projection, the velocity pass, and the slot-form joint solve.

The PyTorch counterpart of the batched half of ``starframe_tpu/kernels.py``,
written op for op in the same order so the two agree to float32 rounding.
Every function takes tensors whose leading axis (where there is one) is the
per-vertex ``[V, ...]`` or per-point ``[2, ...]`` axis and broadcasts over
the rest. The plain twin of the frame kernel (``hopper/frame2.py``) calls
these; the CUDA frame kernel (``csrc/frame2.cu``) is a per-thread scalar
transcription of the same sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from .state import (
    JOINT_ANGLE_RANGE,
    JOINT_ANGULAR_MOTOR,
    JOINT_DISTANCE,
    JOINT_PIN,
    JOINT_WELD,
)

_EPS = 1e-10
_PARALLEL_COS = 0.98
# surfaces within this slop count as "touching" for contact events
TOUCH_SLOP = 1e-3
_INF = float("inf")


class ManifoldB(NamedTuple):
    """Manifold arrays, 2 candidate points per pair (P = trailing shape)."""

    n_x: torch.Tensor  # [P] contact normal (A->B)
    n_y: torch.Tensor  # [P]
    wa_x: torch.Tensor  # [2, P] surface points on A
    wa_y: torch.Tensor  # [2, P]
    wb_x: torch.Tensor  # [2, P]
    wb_y: torch.Tensor  # [2, P]
    sep: torch.Tensor  # [2, P]
    pmask: torch.Tensor  # [2, P] f32 0/1 mask


def _edge_data_b(vx, vy, n_valid):
    """Edges + outward normals for padded CCW polys. vx, vy: [V, P];
    n_valid: [P]."""
    V = vx.shape[0]
    idx = torch.arange(V, device=vx.device).view((V,) + (1,) * (vx.ndim - 1))
    nv = n_valid[None]
    wrap = idx == (nv - 1)
    e1x = torch.where(wrap, vx[0][None], torch.roll(vx, -1, dims=0))
    e1y = torch.where(wrap, vy[0][None], torch.roll(vy, -1, dims=0))
    dx = e1x - vx
    dy = e1y - vy
    length = torch.sqrt(dx * dx + dy * dy)
    valid = (idx < nv) & (nv >= 2) & (length > 1e-9)
    inv = 1.0 / torch.clamp(length, min=_EPS)
    # outward normal of CCW edge: perp_cw(d) = (dy, -dx)
    nx = dy * inv
    ny = -dx * inv
    return vx, vy, e1x, e1y, nx, ny, valid


def _first_true(mask):
    """f32 one-hot of the first True row per column."""
    seen = mask[0]
    rows = [mask[0].to(torch.float32)]
    for i in range(1, mask.shape[0]):
        rows.append((mask[i] & ~seen).to(torch.float32))
        seen = seen | mask[i]
    return torch.stack(rows)


def _sat_b(e0x, e0y, nx, ny, valid, ox, oy):
    """Max separation over edge normals vs the other shape's verts.
    Returns (sep[P], onehot[V, P] of the argmax edge)."""
    mn = nx * ox[0][None] + ny * oy[0][None]
    for j in range(1, ox.shape[0]):
        mn = torch.minimum(mn, nx * ox[j][None] + ny * oy[j][None])
    sep = mn - (nx * e0x + ny * e0y)
    sep = torch.where(valid, sep, -_INF)
    best = sep.amax(dim=0)
    return best, _first_true(sep == best[None])


def _select_b(onehot, rows):
    """Masked-sum row selection. onehot: [V, P] f32 0/1; rows: [V, P]."""
    return (onehot * rows).sum(dim=0)


def _closest_seg_seg_b(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    """Segment-segment closest points (Ericson 5.1.9), degenerate-safe."""
    d1x, d1y = q1x - p1x, q1y - p1y
    d2x, d2y = q2x - p2x, q2y - p2y
    rx, ry = p1x - p2x, p1y - p2y
    a = d1x * d1x + d1y * d1y
    e = d2x * d2x + d2y * d2y
    f = d2x * rx + d2y * ry
    c = d1x * rx + d1y * ry
    b = d1x * d2x + d1y * d2y
    denom = a * e - b * b

    a_deg = a <= _EPS
    e_deg = e <= _EPS
    a_safe = torch.where(a_deg, 1.0, a)
    e_safe = torch.where(e_deg, 1.0, e)

    s_gen = torch.where(
        denom > _EPS,
        torch.clamp((b * f - c * e) / torch.where(denom > _EPS, denom, 1.0),
                    0.0, 1.0),
        0.0)
    t_gen = (b * s_gen + f) / e_safe
    t_cl = torch.clamp(t_gen, 0.0, 1.0)
    s_re = torch.clamp((b * t_cl - c) / a_safe, 0.0, 1.0)
    s_gen = torch.where((t_gen < 0.0) | (t_gen > 1.0), s_re, s_gen)
    t_gen = t_cl

    zero = torch.zeros_like(a)
    s = torch.where(a_deg & e_deg, zero, torch.where(
        a_deg, zero,
        torch.where(e_deg, torch.clamp(-c / a_safe, 0.0, 1.0), s_gen)))
    t = torch.where(a_deg & e_deg, zero, torch.where(
        a_deg, torch.clamp(f / e_safe, 0.0, 1.0),
        torch.where(e_deg, zero, t_gen)))
    return p1x + d1x * s, p1y + d1y * s, p2x + d2x * t, p2y + d2y * t


def manifold_batch(vax, vay, na, ra, vbx, vby, nb, rb, margin) -> ManifoldB:
    """Contact manifolds for rounded convex polygons.

    va*/vb*: [V, P] world verts (padded with v0); na/nb/ra/rb/margin: [P].
    """
    e0ax, e0ay, e1ax, e1ay, nax, nay, eva = _edge_data_b(vax, vay, na)
    e0bx, e0by, e1bx, e1by, nbx, nby, evb = _edge_data_b(vbx, vby, nb)

    sep_a, oh_a = _sat_b(e0ax, e0ay, nax, nay, eva, vbx, vby)
    sep_b, oh_b = _sat_b(e0bx, e0by, nbx, nby, evb, vax, vay)

    a_has = na >= 2
    b_has = nb >= 2
    both_points = ~(a_has | b_has)

    flip = sep_b > sep_a + 1e-5
    s_core = torch.maximum(sep_a, sep_b)

    def pick(fa, fb):
        return torch.where(flip, fb, fa)

    r0x = pick(_select_b(oh_a, e0ax), _select_b(oh_b, e0bx))
    r0y = pick(_select_b(oh_a, e0ay), _select_b(oh_b, e0by))
    r1x = pick(_select_b(oh_a, e1ax), _select_b(oh_b, e1bx))
    r1y = pick(_select_b(oh_a, e1ay), _select_b(oh_b, e1by))
    n_refx = pick(_select_b(oh_a, nax), _select_b(oh_b, nbx))
    n_refy = pick(_select_b(oh_a, nay), _select_b(oh_b, nby))
    r_ref = pick(ra, rb)
    r_inc = pick(rb, ra)

    # incident edge: most anti-parallel normal on the other shape
    inc_a = torch.where(eva, nax * n_refx[None] + nay * n_refy[None], _INF)
    inc_b = torch.where(evb, nbx * n_refx[None] + nby * n_refy[None], _INF)
    mina = inc_a.amin(dim=0)
    minb = inc_b.amin(dim=0)
    oha = _first_true(inc_a == mina[None])
    ohb = _first_true(inc_b == minb[None])
    i_has = (flip & a_has) | (~flip & b_has)
    i0x = pick(torch.where(b_has, _select_b(ohb, e0bx), vbx[0]),
               torch.where(a_has, _select_b(oha, e0ax), vax[0]))
    i0y = pick(torch.where(b_has, _select_b(ohb, e0by), vby[0]),
               torch.where(a_has, _select_b(oha, e0ay), vay[0]))
    i1x = pick(torch.where(b_has, _select_b(ohb, e1bx), vbx[0]),
               torch.where(a_has, _select_b(oha, e1ax), vax[0]))
    i1y = pick(torch.where(b_has, _select_b(ohb, e1by), vby[0]),
               torch.where(a_has, _select_b(oha, e1ay), vay[0]))
    inc_dot = pick(minb, mina)

    # ---- clip path ----
    tdx = r1x - r0x
    tdy = r1y - r0y
    t_len = torch.sqrt(tdx * tdx + tdy * tdy)
    inv_t = 1.0 / torch.clamp(t_len, min=_EPS)
    thx = tdx * inv_t
    thy = tdy * inv_t
    lo = thx * r0x + thy * r0y
    hi = thx * r1x + thy * r1y
    s0 = thx * i0x + thy * i0y
    s1 = thx * i1x + thy * i1y
    ds = s1 - s0
    ds_ok = torch.abs(ds) > 1e-6
    inv_ds = torch.where(ds_ok, 1.0 / torch.where(ds_ok, ds, 1.0), 0.0)
    lo_ = torch.minimum(lo, hi)
    hi_ = torch.maximum(lo, hi)
    cs0 = torch.minimum(torch.maximum(s0, lo_), hi_)
    cs1 = torch.minimum(torch.maximum(s1, lo_), hi_)
    f0 = (cs0 - s0) * inv_ds
    f1 = (cs1 - s0) * inv_ds
    q0x = i0x + (i1x - i0x) * f0
    q0y = i0y + (i1y - i0y) * f0
    q1x = i0x + (i1x - i0x) * f1
    q1y = i0y + (i1y - i0y) * f1
    # perpendicular-incident degenerate clip: take the deepest endpoint
    deep0 = (n_refx * i0x + n_refy * i0y) <= (n_refx * i1x + n_refy * i1y)
    dpx = torch.where(deep0, i0x, i1x)
    dpy = torch.where(deep0, i0y, i1y)
    q0x = torch.where(ds_ok, q0x, dpx)
    q0y = torch.where(ds_ok, q0y, dpy)
    q1x = torch.where(ds_ok, q1x, dpx)
    q1y = torch.where(ds_ok, q1y, dpy)

    def clip_point(qx, qy):
        plane = n_refx * (qx - r0x) + n_refy * (qy - r0y)
        sep = plane - r_ref - r_inc
        wrx = qx - n_refx * plane + n_refx * r_ref
        wry = qy - n_refy * plane + n_refy * r_ref
        wix = qx - n_refx * r_inc
        wiy = qy - n_refy * r_inc
        return sep, wrx, wry, wix, wiy

    csep0, cwr0x, cwr0y, cwi0x, cwi0y = clip_point(q0x, q0y)
    csep1, cwr1x, cwr1y, cwi1x, cwi1y = clip_point(q1x, q1y)
    clip_distinct = torch.sqrt((q1x - q0x) ** 2 + (q1y - q0y) ** 2) > 1e-6

    # ---- closest path ----
    c1x, c1y, c2x, c2y = _closest_seg_seg_b(r0x, r0y, r1x, r1y,
                                            i0x, i0y, i1x, i1y)
    c1x = torch.where(both_points, pick(vax[0], vbx[0]), c1x)
    c1y = torch.where(both_points, pick(vay[0], vby[0]), c1y)
    c2x = torch.where(both_points, pick(vbx[0], vax[0]), c2x)
    c2y = torch.where(both_points, pick(vby[0], vay[0]), c2y)
    dvx = c2x - c1x
    dvy = c2y - c1y
    d_len = torch.sqrt(dvx * dvx + dvy * dvy)
    inv_d = 1.0 / torch.clamp(d_len, min=_EPS)
    ncx = torch.where(d_len > 1e-9, dvx * inv_d,
                      torch.where(both_points, 0.0, n_refx))
    ncy = torch.where(d_len > 1e-9, dvy * inv_d,
                      torch.where(both_points, 1.0, n_refy))
    psep = d_len - r_ref - r_inc
    pwrx = c1x + ncx * r_ref
    pwry = c1y + ncy * r_ref
    pwix = c2x - ncx * r_inc
    pwiy = c2y - ncy * r_inc

    # ---- choose path ----
    parallel = i_has & (inc_dot < -_PARALLEL_COS)
    clip_has_extent = torch.abs(cs1 - cs0) > 1e-6
    both_thin = (na <= 2) & (nb <= 2)
    deep_clip = (s_core <= 0.0) & ~both_thin
    use_clip = ~both_points & (deep_clip | (parallel & clip_has_extent))

    uc = use_clip[None]
    noutx = torch.where(use_clip, n_refx, ncx)
    nouty = torch.where(use_clip, n_refy, ncy)
    wrx = torch.where(uc, torch.stack([cwr0x, cwr1x]), torch.stack([pwrx, pwrx]))
    wry = torch.where(uc, torch.stack([cwr0y, cwr1y]), torch.stack([pwry, pwry]))
    wix = torch.where(uc, torch.stack([cwi0x, cwi1x]), torch.stack([pwix, pwix]))
    wiy = torch.where(uc, torch.stack([cwi0y, cwi1y]), torch.stack([pwiy, pwiy]))
    seps = torch.where(uc, torch.stack([csep0, csep1]), torch.stack([psep, psep]))

    pmask0 = (seps[0] < margin).to(torch.float32)
    pmask1 = (use_clip & clip_distinct & (seps[1] < margin)).to(torch.float32)
    pmask = torch.stack([pmask0, pmask1])

    flipn = torch.where(flip, -1.0, 1.0)
    fl = flip[None]
    return ManifoldB(
        noutx * flipn, nouty * flipn,
        torch.where(fl, wix, wrx), torch.where(fl, wiy, wry),
        torch.where(fl, wrx, wix), torch.where(fl, wry, wiy),
        seps, pmask)


# ---------------------------------------------------------------------------
# contact position solve + velocity pass
# ---------------------------------------------------------------------------


class PairPose(NamedTuple):
    """Per-pair poses (position + cos/sin) of bodies A and B."""

    pax: torch.Tensor
    pay: torch.Tensor
    ca: torch.Tensor
    sa: torch.Tensor
    pbx: torch.Tensor
    pby: torch.Tensor
    cb: torch.Tensor
    sb: torch.Tensor


class PairVel(NamedTuple):
    """Per-pair velocities of bodies A and B."""

    vax: torch.Tensor
    vay: torch.Tensor
    oa: torch.Tensor
    vbx: torch.Tensor
    vby: torch.Tensor
    ob: torch.Tensor


def _pair_kinematics(cb_, pose: PairPose):
    """World-space contact geometry at the given pair poses. ``cb_`` holds
    the body-local normal ``n_ax, n_ay`` [P] and anchors ``a_ax, a_ay,
    b_ax, b_ay`` [2, P]."""
    pax, pay, ca, sa, pbx, pby, cb, sb = pose
    nx = ca * cb_.n_ax - sa * cb_.n_ay
    ny = sa * cb_.n_ax + ca * cb_.n_ay
    rax = ca[None] * cb_.a_ax - sa[None] * cb_.a_ay  # anchor offset from COM
    ray = sa[None] * cb_.a_ax + ca[None] * cb_.a_ay
    rbx = cb[None] * cb_.b_ax - sb[None] * cb_.b_ay
    rby = sb[None] * cb_.b_ax + cb[None] * cb_.b_ay
    wax = pax[None] + rax
    way = pay[None] + ray
    wbx = pbx[None] + rbx
    wby = pby[None] + rby
    return nx, ny, rax, ray, rbx, rby, wax, way, wbx, wby


def solve_contacts_b(pose: PairPose, pose0, pd, cb_, h: float,
                     contact_compliance: float, kin0=None):
    """XPBD contact projection. Returns (vals_a[4, P], vals_b[4, P],
    lam_n[2, P]); vals rows are (dpos_x, dpos_y, dang, count).

    ``kin0``: the substep-start anchor world positions ``(wax0, way0,
    wbx0, wby0)`` (the static-friction reference); when given, ``pose0`` may
    be None."""
    im_a = pd.inv_mass_a[None]
    im_b = pd.inv_mass_b[None]
    ii_a = pd.inv_inertia_a[None]
    ii_b = pd.inv_inertia_b[None]

    nx, ny, rax, ray, rbx, rby, wax, way, wbx, wby = _pair_kinematics(cb_, pose)
    nxp = nx[None]
    nyp = ny[None]

    c = (wbx - wax) * nxp + (wby - way) * nyp
    active = (c < 0.0) & (cb_.solve_mask > 0.0)

    cr_a = rax * nyp - ray * nxp
    cr_b = rbx * nyp - rby * nxp
    w_a = im_a + ii_a * cr_a * cr_a
    w_b = im_b + ii_b * cr_b * cr_b
    alpha_t = contact_compliance / (h * h)
    den = w_a + w_b + alpha_t
    dlam = torch.where(active & (den > _EPS),
                       -c / torch.clamp(den, min=_EPS), 0.0)
    p_x = dlam * nxp
    p_y = dlam * nyp

    # static friction at position level
    if kin0 is not None:
        wax0, way0, wbx0, wby0 = kin0
    else:
        _, _, _, _, _, _, wax0, way0, wbx0, wby0 = _pair_kinematics(cb_, pose0)
    dpx = (wax - wax0) - (wbx - wbx0)
    dpy = (way - way0) - (wby - wby0)
    dpn = dpx * nxp + dpy * nyp
    tx = dpx - dpn * nxp
    ty = dpy - dpn * nyp
    ct = torch.sqrt(tx * tx + ty * ty)
    inv_ct = 1.0 / torch.clamp(ct, min=_EPS)
    thx = tx * inv_ct
    thy = ty * inv_ct
    cr_at = rax * thy - ray * thx
    cr_bt = rbx * thy - rby * thx
    w_at = im_a + ii_a * cr_at * cr_at
    w_bt = im_b + ii_b * cr_bt * cr_bt
    dent = w_at + w_bt
    dlam_t = torch.where(dent > _EPS, -ct / torch.clamp(dent, min=_EPS), 0.0)
    stick = active & (torch.abs(dlam_t) < pd.friction[None] * dlam)
    pt_x = torch.where(stick, dlam_t * thx, 0.0)
    pt_y = torch.where(stick, dlam_t * thy, 0.0)

    # per-body contributions summed over the 2 points
    ca_x = (-p_x + pt_x).sum(0)
    ca_y = (-p_y + pt_y).sum(0)
    cb_x = (p_x - pt_x).sum(0)
    cb_y = (p_y - pt_y).sum(0)
    dang_a = (ii_a * (-(rax * p_y - ray * p_x)
                      + (rax * pt_y - ray * pt_x))).sum(0)
    dang_b = (ii_b * ((rbx * p_y - rby * p_x)
                      - (rbx * pt_y - rby * pt_x))).sum(0)
    n_act = active.sum(0).to(torch.float32)

    vals_a = torch.stack([ca_x * pd.inv_mass_a, ca_y * pd.inv_mass_a,
                          dang_a, n_act])
    vals_b = torch.stack([cb_x * pd.inv_mass_b, cb_y * pd.inv_mass_b,
                          dang_b, n_act])
    return vals_a, vals_b, dlam


def velocity_contacts_b(pose: PairPose, pvel: PairVel, pvel0: PairVel,
                        pd, cb_, lam_n, h: float,
                        restitution_threshold: float, kin=None):
    """Restitution + dynamic friction velocity impulses. Returns
    (vals_a[4, P], vals_b[4, P]) (rows: dvx, dvy, dang, count). ``kin``:
    optional precomputed ``_pair_kinematics(cb_, pose)``."""
    im_a = pd.inv_mass_a[None]
    im_b = pd.inv_mass_b[None]
    ii_a = pd.inv_inertia_a[None]
    ii_b = pd.inv_inertia_b[None]

    nx, ny, rax, ray, rbx, rby, *_ = (
        kin if kin is not None else _pair_kinematics(cb_, pose))
    nxp, nyp = nx[None], ny[None]

    def point_vel(vx, vy, om, rx, ry):
        return vx[None] - om[None] * ry, vy[None] + om[None] * rx

    uax, uay = point_vel(pvel.vax, pvel.vay, pvel.oa, rax, ray)
    ubx, uby = point_vel(pvel.vbx, pvel.vby, pvel.ob, rbx, rby)
    relx = ubx - uax
    rely = uby - uay
    vn = relx * nxp + rely * nyp
    utx = relx - vn * nxp
    uty = rely - vn * nyp
    vt = torch.sqrt(utx * utx + uty * uty)

    ua0x, ua0y = point_vel(pvel0.vax, pvel0.vay, pvel0.oa, rax, ray)
    ub0x, ub0y = point_vel(pvel0.vbx, pvel0.vby, pvel0.ob, rbx, rby)
    vn0 = (ub0x - ua0x) * nxp + (ub0y - ua0y) * nyp

    active = (lam_n > 0.0) & (cb_.solve_mask > 0.0)

    cr_a = rax * nyp - ray * nxp
    cr_b = rbx * nyp - rby * nxp
    w_n = im_a + ii_a * cr_a * cr_a + im_b + ii_b * cr_b * cr_b

    e = torch.where(vn0 < -restitution_threshold, pd.restitution[None], 0.0)
    dv_n = torch.where(active, -vn + torch.clamp(-e * vn0, min=0.0), 0.0)
    lam_v = torch.where(w_n > _EPS, dv_n / torch.clamp(w_n, min=_EPS), 0.0)
    pnx = lam_v * nxp
    pny = lam_v * nyp

    inv_vt = 1.0 / torch.clamp(vt, min=_EPS)
    thx = utx * inv_vt
    thy = uty * inv_vt
    cr_at = rax * thy - ray * thx
    cr_bt = rbx * thy - rby * thx
    w_t = im_a + ii_a * cr_at * cr_at + im_b + ii_b * cr_bt * cr_bt
    lam_f = torch.minimum(
        torch.where(w_t > _EPS, vt / torch.clamp(w_t, min=_EPS), 0.0),
        pd.friction[None] * lam_n / h,
    )
    lam_f = torch.where(active, lam_f, 0.0)
    pfx = lam_f * thx
    pfy = lam_f * thy

    impx = pnx - pfx  # applied +imp to b, -imp to a
    impy = pny - pfy
    cb_x = impx.sum(0)
    cb_y = impy.sum(0)
    dang_b = (ii_b * (rbx * impy - rby * impx)).sum(0)
    dang_a = -(ii_a * (rax * impy - ray * impx)).sum(0)
    n_act = active.sum(0).to(torch.float32)

    vals_a = torch.stack([-cb_x * pd.inv_mass_a, -cb_y * pd.inv_mass_a,
                          dang_a, n_act])
    vals_b = torch.stack([cb_x * pd.inv_mass_b, cb_y * pd.inv_mass_b,
                          dang_b, n_act])
    return vals_a, vals_b


# ---------------------------------------------------------------------------
# slot-form joint solve (each body's joint slots are canonicalised so the
# own body is endpoint A; only the own-side correction is produced, and the
# partner computes its half in its own slot)
# ---------------------------------------------------------------------------


def _div(x, s: float):
    """``x / s`` for a Python float ``s`` rounded to ``x``'s dtype, as a true
    division on every device (PyTorch's CUDA kernels turn a division by a
    host scalar into a multiplication by its reciprocal, which rounds
    differently)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _wrap_pi(x):
    """Wrap to (-pi, pi] without a remainder: ``x - 2 pi floor((x + pi) /
    2 pi)`` with both constants rounded to ``x``'s dtype."""
    two_pi = 2.0 * math.pi
    return x - two_pi * torch.floor(_div(x + math.pi, two_pi))


def _joint_anchors(pose: PairPose, jd):
    """World anchors of both ends and their offsets from each body."""
    wax = pose.pax + pose.ca * jd.oax - pose.sa * jd.oay
    way = pose.pay + pose.sa * jd.oax + pose.ca * jd.oay
    wbx = pose.pbx + pose.cb * jd.pax - pose.sb * jd.pay
    wby = pose.pby + pose.sb * jd.pax + pose.cb * jd.pay
    return (wax, way, wbx, wby, wax - pose.pax, way - pose.pay,
            wbx - pose.pbx, wby - pose.pby)


def solve_joints_b(pose: PairPose, an_o, an_p, jd, h: float):
    """XPBD joint position projection, slot form. ``pose`` carries the own
    (A) and partner (B) poses, ``an_o``/``an_p`` the raw angles. ``jd``
    fields (each ``[S]``): jtype, oax, oay (own anchor), pax, pay (partner
    anchor), rest, lo, hi, compliance, im_o, im_p, ii_o, ii_p, active, all
    canonicalised so the own body is endpoint A. Returns own-side vals
    ``[4, S]`` (dpos_x, dpos_y, dang, count)."""
    jt = jd.jtype
    wax, way, wbx, wby, rax, ray, rbx, rby = _joint_anchors(pose, jd)

    dx = wbx - wax
    dy = wby - way
    d = torch.sqrt(dx * dx + dy * dy)
    inv_d = 1.0 / torch.clamp(d, min=_EPS)
    nx = dx * inv_d
    ny = dy * inv_d

    is_dist = jt == JOINT_DISTANCE
    is_point = (jt == JOINT_PIN) | (jt == JOINT_WELD)
    lo = torch.where(is_point, 0.0, jd.lo)
    hi = torch.where(is_point, 0.0, jd.hi)
    c_lin = torch.where(d > hi, d - hi, torch.where(d < lo, d - lo, 0.0))
    lin_active = ((is_dist | is_point) & (torch.abs(c_lin) > 0.0)
                  & (d > _EPS) & (jd.active > 0))

    cr_a = rax * ny - ray * nx
    cr_b = rbx * ny - rby * nx
    w_a = jd.im_o + jd.ii_o * cr_a * cr_a
    w_b = jd.im_p + jd.ii_p * cr_b * cr_b
    alpha_t = _div(jd.compliance, h * h)
    den = w_a + w_b + alpha_t
    dlam = torch.where(lin_active & (den > _EPS),
                       -c_lin / torch.clamp(den, min=_EPS), 0.0)
    p_x = dlam * nx
    p_y = dlam * ny

    # angular rows (weld locks the relative angle; angle_range limits it)
    phi = _wrap_pi(an_p - an_o - jd.rest)
    is_weld = jt == JOINT_WELD
    is_rng = jt == JOINT_ANGLE_RANGE
    c_ang = torch.where(
        is_weld, phi,
        torch.where(phi > jd.hi, phi - jd.hi,
                    torch.where(phi < jd.lo, phi - jd.lo, 0.0)))
    ang_active = ((is_weld | is_rng) & (torch.abs(c_ang) > 0.0)
                  & (jd.active > 0))
    den_a = jd.ii_o + jd.ii_p + alpha_t
    dlam_ang = torch.where(ang_active & (den_a > _EPS),
                           -c_ang / torch.clamp(den_a, min=_EPS), 0.0)

    n_active = lin_active.to(torch.float32) + ang_active.to(torch.float32)
    return torch.stack([
        -p_x * jd.im_o,
        -p_y * jd.im_o,
        -jd.ii_o * (rax * p_y - ray * p_x) - dlam_ang * jd.ii_o,
        n_active.to(p_x.dtype),
    ])


def velocity_joints_b(pose: PairPose, pvel: PairVel, jd, h: float):
    """Joint velocity rows, slot form: angular motors and joint damping.
    ``jd`` as for :func:`solve_joints_b`, plus damping, motor_speed and
    motor_max. Returns own-side vals ``[4, S]``."""
    is_motor = (jd.jtype == JOINT_ANGULAR_MOTOR) & (jd.active > 0)
    err = jd.motor_speed - (pvel.ob - pvel.oa)
    w_ang = jd.ii_o + jd.ii_p
    lam_m = torch.where(w_ang > _EPS, err / torch.clamp(w_ang, min=_EPS), 0.0)
    lam_m = torch.minimum(torch.maximum(lam_m, -jd.motor_max * h),
                          jd.motor_max * h)
    lam_m = torch.where(is_motor, lam_m, 0.0)

    damped = (jd.active > 0) & (jd.damping > 0.0)
    _, _, _, _, rax, ray, rbx, rby = _joint_anchors(pose, jd)
    relx = (pvel.vbx - pvel.ob * rby) - (pvel.vax - pvel.oa * ray)
    rely = (pvel.vby + pvel.ob * rbx) - (pvel.vay + pvel.oa * rax)
    w_lin = jd.im_o + jd.im_p
    damp_f = torch.clamp(jd.damping * h, max=1.0)
    scale = torch.where(w_lin > _EPS, damp_f / torch.clamp(w_lin, min=_EPS),
                        0.0)
    p_dx = torch.where(damped, -relx * scale, 0.0)
    p_dy = torch.where(damped, -rely * scale, 0.0)

    j_act = (is_motor | damped).to(p_dx.dtype)
    return torch.stack([
        -p_dx * jd.im_o,
        -p_dy * jd.im_o,
        -lam_m * jd.ii_o - jd.ii_o * (rax * p_dy - ray * p_dx),
        j_act,
    ])
