"""The plain reference of a frame: exhaustive pair finding, the frame's
manifolds, the XPBD substeps and, where the configuration sleeps, the sleep
update, over a flat body axis (a world batch is flattened; pairs never
cross worlds).

Semantics, as the engine states them: the manifolds are computed once a
frame, at the frame-start poses, for every directed pair of colliders of
different bodies whose shapes lie within the speculative margin ``margin +
dt * (speed_a + speed_b)`` (a speed is ``|v| + |w| * extent``), and are
frozen as body-local anchors and normal. Each substep integrates gravity,
projects every contact point (Jacobi: each body's corrections are summed
over its pairs and averaged over its active points, clipped at
``max_dpos``), reconstructs velocities from the displacement, then runs
restitution and dynamic friction over the points that pushed. With
``solve_slots`` a collider keeps its ``solve_slots`` closest active pairs
(by the least separation of their points). With sleep, a body whose speed
stays under ``sleep_velocity`` for ``sleep_frames`` frames is frozen (its
inverse masses are zero for the frame) until a dynamic partner within the
margin moves at ``sleep_velocity * wake_velocity_factor`` or faster; a
frame in which nothing dynamic is awake changes nothing. Joints
(``reference.joints``) are projected after each iteration's contacts, and
their motors and damping join the velocity pass.

Nothing here reads the program's tables, slots or tiles: the pair set is
found from scratch, so a pair the program's broadphase lost shows as a
difference in the state.
"""

from __future__ import annotations

import torch

from . import joints as ref_joints
from .contact import manifold, project, velocity, world_geometry

STATE = ("px", "py", "an", "vx", "vy", "om")
# pair tests per block of the exhaustive search (bounds its memory)
BLOCK = 1 << 24


def collider_world(geom, st):
    """World vertices ``[Mc, V]`` x2, extents and speed bounds of every
    collider at the state ``st``."""
    b = geom["cbody"]
    ca, sa = torch.cos(st["an"])[b], torch.sin(st["an"])[b]
    lx, ly = geom["lvx"], geom["lvy"]
    wx = st["px"][b][:, None] + ca[:, None] * lx - sa[:, None] * ly
    wy = st["py"][b][:, None] + sa[:, None] * lx + ca[:, None] * ly
    ext = torch.sqrt(lx * lx + ly * ly).amax(1) + geom["rad"]
    spd = (torch.sqrt(st["vx"] * st["vx"] + st["vy"] * st["vy"])[b]
           + torch.abs(st["om"])[b] * ext)
    return wx, wy, spd


def candidate_pairs(geom, wx, wy, spd, margin: float, dt: float):
    """Every directed pair ``(own, partner)`` of colliders of one world whose
    boxes, each grown by half the margin and its own frame of travel, touch:
    a superset of the pairs within the speculative margin. ``own`` is a
    collider whose body responds. Returns two ``[P]`` long tensors."""
    grow = (0.5 * margin + dt * spd.float()) * 1.001 + 1e-5
    r = geom["rad"].float()
    lo_x = wx.float().amin(1) - r - grow
    hi_x = wx.float().amax(1) + r + grow
    lo_y = wy.float().amin(1) - r - grow
    hi_y = wy.float().amax(1) + r + grow
    W, M = geom["W"], geom["M"]
    box = torch.stack([lo_x, hi_x, lo_y, hi_y]).reshape(4, W, M)
    lay, msk = geom["layer"].reshape(W, M), geom["mask"].reshape(W, M)
    body = geom["cbody"].reshape(W, M)
    own_ok = (geom["responds"][geom["cbody"]] & geom["active"]).reshape(W, M)
    act = geom["active"].reshape(W, M)
    rows = max(1, min(M, BLOCK // M))
    worlds = max(1, BLOCK // (rows * M))
    own, par = [], []
    for w0 in range(0, W, worlds):
        w1 = min(W, w0 + worlds)
        for r0 in range(0, M, rows):
            r1 = min(M, r0 + rows)
            bi = box[:, w0:w1, r0:r1, None]  # own
            bj = box[:, w0:w1, None, :]  # partner
            hit = ((bi[0] <= bj[1]) & (bj[0] <= bi[1]) & (bi[2] <= bj[3])
                   & (bj[2] <= bi[3]))
            hit &= own_ok[w0:w1, r0:r1, None] & act[w0:w1, None, :]
            hit &= body[w0:w1, r0:r1, None] != body[w0:w1, None, :]
            li, lj = lay[w0:w1, r0:r1, None], lay[w0:w1, None, :]
            mi, mj = msk[w0:w1, r0:r1, None], msk[w0:w1, None, :]
            hit &= (((mi >> lj) & 1) & ((mj >> li) & 1)) != 0
            w, i, j = torch.nonzero(hit, as_tuple=True)
            own.append((w + w0) * M + i + r0)
            par.append((w + w0) * M + j)
    return torch.cat(own), torch.cat(par)


def frame_contacts(geom, st, cfg, invm, invi, stats=None):
    """The frame's contact set: per directed pair with a point inside the
    speculative margin, its frozen body-local normal and anchors, material
    and the frame's inverse masses. Returns ``(pairs, own_body,
    partner_body, woken)``: ``woken`` the bodies with a fast partner
    within the margin (the wake signal; None without sleep). ``stats``
    (a dict) adds the frame's counts: ``cand`` candidate pairs,
    ``cand_live`` those with an awake body, ``active`` pairs within the
    margin, ``solved`` pairs solved for an awake body; and the largest
    ``max_touching`` and ``max_imminent`` partner counts of a collider."""
    wx, wy, spd = collider_world(geom, st)
    i, j = candidate_pairs(geom, wx, wy, spd, cfg["contact_margin"],
                           cfg["dt"])
    margin_eff = cfg["contact_margin"] + cfg["dt"] * (spd[i] + spd[j])
    nv, rad = geom["nv"], geom["rad"]
    nx, ny, wax, way, wbx, wby, sep, pmask = manifold(
        wx[i].T, wy[i].T, nv[i], rad[i], wx[j].T, wy[j].T, nv[j], rad[j],
        margin_eff)
    keep = pmask.amax(0) > 0
    if cfg.get("solve_slots", 0):
        # each collider keeps its closest active pairs (ties by partner)
        big = torch.full_like(sep, 1e30)
        minsep = torch.where(pmask > 0, sep, big).amin(0).float()
        minsep = torch.where(keep, minsep, torch.full_like(minsep, 3e30))
        order = torch.argsort(j, stable=True)
        order = order[torch.argsort(minsep[order], stable=True)]
        order = order[torch.argsort(i[order], stable=True)]
        start = torch.searchsorted(i[order], i[order])
        rank = torch.arange(order.numel(), device=order.device) - start
        ranked = torch.empty_like(rank)
        ranked[order] = rank
        keep_solve = keep & (ranked < cfg["solve_slots"])
    else:
        keep_solve = keep
    cb = geom["cbody"]
    ba, bb = cb[i], cb[j]
    woken = None
    if cfg.get("sleep_velocity", 0.0) > 0.0:
        sp2 = st["vx"] * st["vx"] + st["vy"] * st["vy"] + st["om"] * st["om"]
        fast = (sp2 >= (cfg["sleep_velocity"] * cfg["wake_velocity_factor"])
                ** 2) & (invm > 0)
        fast |= geom["kinematic"] & (sp2 >= cfg["sleep_velocity"] ** 2)
        woken = ba[keep & fast[bb]]
    if stats is not None:
        # the most partners any collider has touching (within a tenth of
        # the margin) and imminent (within the margin)
        ms = torch.where(pmask > 0, sep, torch.full_like(sep, 1e30)).amin(0)
        for key, thr in (("max_touching", 0.1 * cfg["contact_margin"]),
                         ("max_imminent", cfg["contact_margin"])):
            m = keep & (ms < thr)
            top = int(torch.bincount(i[m]).max()) if bool(m.any()) else 0
            stats[key] = max(stats.get(key, 0), top)
        stats["cand"] = stats.get("cand", 0) + i.numel()
        stats["cand_live"] = stats.get("cand_live", 0) + int(
            ((invm[ba] > 0) | (invm[bb] > 0)).sum())
        stats["active"] = stats.get("active", 0) + int(keep.sum())
        stats["solved"] = stats.get("solved", 0) + int(
            (keep_solve & (invm[ba] > 0)).sum())
    sel = torch.nonzero(keep_solve, as_tuple=True)[0]
    i, j, ba, bb = i[sel], j[sel], ba[sel], bb[sel]
    pmask = pmask[:, sel]
    ca, sa = torch.cos(st["an"][ba]), torch.sin(st["an"][ba])
    cbb, sbb = torch.cos(st["an"][bb]), torch.sin(st["an"][bb])
    pax, pay = st["px"][ba], st["py"][ba]
    pbx, pby = st["px"][bb], st["py"][bb]
    nx, ny = nx[sel], ny[sel]
    dxa, dya = wax[:, sel] - pax, way[:, sel] - pay
    dxb, dyb = wbx[:, sel] - pbx, wby[:, sel] - pby
    sensor = torch.maximum(geom["sensor"][i], geom["sensor"][j])
    pairs = dict(
        nax=ca * nx + sa * ny, nay=-sa * nx + ca * ny,
        aax=ca * dxa + sa * dya, aay=-sa * dxa + ca * dya,
        bax=cbb * dxb + sbb * dyb, bay=-sbb * dxb + cbb * dyb,
        solve=pmask * (1.0 - sensor),
        fric=torch.sqrt(geom["fric"][i] * geom["fric"][j]),
        rest=torch.maximum(geom["rest"][i], geom["rest"][j]),
        ima=invm[ba], imb=invm[bb], iia=invi[ba], iib=invi[bb])
    return pairs, ba, bb, woken


def _sum_to(n, idx, *vals):
    out = []
    for v in vals:
        out.append(torch.zeros(n, dtype=v.dtype, device=v.device)
                   .index_add_(0, idx, v))
    return out


def _joint_passes(jg, cfg, pose, invm, invi, h):
    """The joints' coloured position passes of one iteration: ``pose =
    (px, py, an, dxx, dxy, dth)``, the poses and the corrections applied so
    far, updated."""
    px, py, an, dxx, dxy, dth = pose
    last, lim = cfg["joint_colors"] - 1, cfg["joint_max_dpos"]
    for color in range(last + 1):
        sel = jg["color"] >= color if color == last else jg["color"] == color
        jx, jy, ja, jc = ref_joints.position_sums(jg, sel, px, py, an, invm,
                                                  invi, h)
        jc = torch.clamp(jc, min=1.0)
        ddx = torch.clamp(jx / jc, -lim, lim)
        ddy = torch.clamp(jy / jc, -lim, lim)
        dda = torch.clamp(ja / jc, -lim, lim)
        px, py, an = px + ddx, py + ddy, an + dda
        dxx, dxy, dth = dxx + ddx, dxy + ddy, dth + dda
    return px, py, an, dxx, dxy, dth


def frame(geom, st, cfg, stats=None):
    """One frame from state ``st`` (dict of ``[B]`` tensors, with ``sleep``
    counters where the configuration sleeps). Returns the new state.
    ``stats`` (a dict) adds the frame's counts (:func:`frame_contacts`,
    ``frames`` run and ``awake`` bodies; with joints
    ``reference.joints.count``'s). The joints' per-call parameters
    (``reference.joints.STATE``) are ``st``'s where it has them, else the
    scene's, and pass on to the new state."""
    sleep_on = cfg.get("sleep_velocity", 0.0) > 0.0
    invm, invi = geom["invm"], geom["invi"]
    jg = geom.get("joints")
    if jg is not None and (sleep_on or cfg["joint_solver"] != "colored"):
        raise NotImplementedError("the reference's joints take the coloured "
                                  "solver without sleep")
    if stats is not None:
        for key in ("max_touching", "max_imminent"):
            stats.setdefault(key, 0)
    dynamic = invm > 0
    if sleep_on:
        asleep = (st["sleep"] >= cfg["sleep_frames"]) & dynamic
        if not bool((geom["moves"] & ~asleep).any()):
            return dict(st)  # nothing awake: the frame is skipped
        awake = (~asleep).to(invm.dtype)
        invm, invi = invm * awake, invi * awake
    n = invm.shape[0]
    if stats is not None:
        stats["frames"] = stats.get("frames", 0) + 1
        stats["awake"] = stats.get("awake", 0) + int((invm > 0).sum())
    pairs, ba, bb, woken = frame_contacts(geom, st, cfg, invm, invi, stats)
    if jg is not None:
        motor = [st.get(k, jg[k]).to(invm.dtype) for k in ref_joints.STATE]
        if stats is not None:
            ref_joints.count(jg, invm, invi, stats)
    dyn = (invm > 0).to(invm.dtype)
    kin = geom["kinematic"].to(invm.dtype)
    g = torch.tensor(cfg["gravity"], dtype=invm.dtype, device=invm.device)
    gx, gy = g[0], g[1]
    h = cfg["dt"] / cfg["substeps"]
    px, py, an, vx, vy, om = (st[k] for k in STATE)

    def pose(px, py, an):
        c, s = torch.cos(an), torch.sin(an)
        return (px[ba], py[ba], c[ba], s[ba], px[bb], py[bb], c[bb], s[bb])

    for _ in range(cfg["substeps"]):
        geo0 = world_geometry(pairs, pose(px, py, an))
        vx = vx + gx * h * dyn
        vy = vy + gy * h * dyn
        px, py, an = px + vx * h, py + vy * h, an + om * h
        vtx, vty, vtom = vx, vy, om
        dxx = torch.zeros_like(px)
        dxy, dth = torch.zeros_like(py), torch.zeros_like(an)
        lam = None
        for _it in range(cfg["iterations"]):
            fx, fy, fa, cnt, lam_i = project(
                pairs, world_geometry(pairs, pose(px, py, an)), geo0, h,
                cfg["contact_compliance"])
            lam = lam_i if lam is None else lam + lam_i
            sx, sy, sa_, sc = _sum_to(n, ba, fx, fy, fa, cnt)
            sc = torch.clamp(sc, min=1.0)
            lim = cfg["max_dpos"]
            ddx = torch.clamp(sx * cfg["relaxation"] / sc, -lim, lim)
            ddy = torch.clamp(sy * cfg["relaxation"] / sc, -lim, lim)
            dda = torch.clamp(sa_ * cfg["relaxation"] / sc, -lim, lim)
            px, py, an = px + ddx, py + ddy, an + dda
            dxx, dxy, dth = dxx + ddx, dxy + ddy, dth + dda
            if jg is not None:
                px, py, an, dxx, dxy, dth = _joint_passes(
                    jg, cfg, (px, py, an, dxx, dxy, dth), invm, invi, h)
        nk = 1.0 - kin
        vx = kin * vx + nk * (vtx + dxx / h)
        vy = kin * vy + nk * (vty + dxy / h)
        om = kin * om + nk * (vtom + dth / h)
        vel = (vx[ba], vy[ba], om[ba], vx[bb], vy[bb], om[bb])
        vel0 = (vtx[ba], vty[ba], vtom[ba], vtx[bb], vty[bb], vtom[bb])
        gv, gw, gdw, gc = velocity(
            pairs, world_geometry(pairs, pose(px, py, an)), vel, vel0, lam,
            h, cfg["restitution_threshold"])
        sx, sy, sw, sc = _sum_to(n, ba, gv, gw, gdw, gc)
        if jg is not None:
            jx, jy, jw, jc = ref_joints.velocity_sums(
                jg, *motor, px, py, an, vx, vy, om, invm, invi, h)
            sx, sy, sw, sc = sx + jx, sy + jy, sw + jw, sc + jc
        sc = torch.clamp(sc, min=1.0)
        vx, vy, om = vx + sx / sc, vy + sy / sc, om + sw / sc
        if cfg.get("linear_damping", 0.0) > 0.0:
            d = 1.0 / (1.0 + h * cfg["linear_damping"])
            vx, vy = vx * d, vy * d
        if cfg.get("angular_damping", 0.0) > 0.0:
            om = om * (1.0 / (1.0 + h * cfg["angular_damping"]))
    out = dict(px=px, py=py, an=an, vx=vx, vy=vy, om=om)
    out.update((k, st[k]) for k in ref_joints.STATE if k in st)
    if sleep_on:
        slow = (vx * vx + vy * vy + om * om) < cfg["sleep_velocity"] ** 2
        count = torch.where(slow, st["sleep"] + 1, torch.zeros_like(
            st["sleep"]))
        wake = torch.zeros(n, dtype=torch.bool, device=px.device)
        wake[woken] = True
        count = torch.where(wake, torch.zeros_like(count), count)
        asleep = (count >= cfg["sleep_frames"]) & dynamic
        zero = torch.zeros_like(vx)
        out.update(vx=torch.where(asleep, zero, vx),
                   vy=torch.where(asleep, zero, vy),
                   om=torch.where(asleep, zero, om), sleep=count)
    return out


def rollout(geom, st, cfg, n_frames: int, stats=None):
    """``n_frames`` frames from ``st`` (``stats`` as :func:`frame`)."""
    for _ in range(n_frames):
        st = frame(geom, st, cfg, stats)
    return st
