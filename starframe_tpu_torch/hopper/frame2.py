"""Whole-frame XPBD solve for a world batch.

Replaces ``starframe_tpu/pallas/frame2.py``'s ``_frame2_kernel`` (via
``run_frame2``) with the CUDA kernel in ``csrc/frame2.cu``, for the
uniform-topology, uncompacted configuration, contact-only or with joints,
with or without CCD. :func:`run_frame2` launches it for CUDA tensors and runs
:func:`frame2_plain`, the plain PyTorch twin, for CPU tensors.
``run_frame2.launches`` counts kernel launches.

The frame: manifolds once at the frame-start pose (with a velocity-expanded
speculative margin, anchors kept body-local), then ``substeps`` x
[integrate -> ``iterations`` x (Jacobi contact projection over each row's
slots, count-normalised and clipped; joints fused into it, or one coloured
Gauss-Seidel pass per joint colour after it) -> velocity reconstruction ->
restitution/friction velocity pass with motors and joint damping]. Every
dynamic collider owns its slot row, so corrections reach bodies by summing
rows (a body's colliders come from world 0's ``cbody`` through
:func:`owner_csr`: the batch shares one topology, so a rollout builds it
once); every body owns its joint slots (``hopper.build_joint_slots``).
With CCD each substep's integrated pose of a bullet body is pulled back to
its earliest time of impact against the frame's manifolds before the
solve (``ccd=True``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..kernels import (
    TOUCH_SLOP,
    PairPose,
    PairVel,
    _pair_kinematics,
    manifold_batch,
    solve_contacts_b,
    solve_joints_b,
    velocity_contacts_b,
    velocity_joints_b,
)
from ..state import JOINT_ANGLE_RANGE
from . import _build
from .slots import _check, _route

f32 = torch.float32
i32 = torch.int32

SCRATCH_FIELDS = 28  # csrc/common.cuh F2_FIELDS
_KERNEL_V = (4, 8)  # vertex widths the kernel is compiled for
SHARED_LIMIT = 232448  # bytes of shared memory one H100 block may use
# the joint tables run_frame2 takes: parameters [W, J], then slots [W, JC, N]
JOINT_SLOT_KEYS = ("jslot", "jside", "jact")


def kernel_verts(V: int):
    """The compiled vertex width a ``V``-vertex batch is padded to (None
    past the widest)."""
    return next((v for v in _KERNEL_V if v >= V), None)


def frame2_shared_bytes(N: int, M: int, V: int, J: int) -> int:
    """Shared memory of one frame-kernel block (``csrc/frame2.cu``
    ``shared_bytes``): the world's bodies, colliders and row sums, and with
    joints their 15 parameter rows and the per-body joint sums."""
    return (4 * (19 * N + (2 * V + 9) * M) + 4 * (3 * M + N + 1)
            + (4 * (len(_build.JOINT_KEYS) * J + 4 * N) if J > 0 else 0))


def owner_csr(cbody0, n_bodies: int):
    """``(start [N + 1] i32, idx [M] i32)``: body n owns colliders
    ``idx[start[n]:start[n + 1]]``, ascending. Built on the device, with no
    host round trip."""
    cb = cbody0.long()
    order = torch.argsort(cb, stable=True).to(i32)
    counts = torch.bincount(cb, minlength=n_bodies)
    start = torch.zeros(n_bodies + 1, dtype=i32, device=cb.device)
    start[1:] = torch.cumsum(counts, 0).to(i32)
    return start, order


def _owner_table(start, order):
    """An :func:`owner_csr` padded to ``(idx [K, N] long, mask [K, N] f32)``:
    row k holds each body's k-th collider (ascending), mask 0 past its
    count."""
    counts = start[1:] - start[:-1]
    k = torch.arange(max(int(counts.max()), 1), device=order.device)[:, None]
    mask = k < counts[None]
    at = torch.clamp(start[:-1][None] + k, max=order.shape[0] - 1)
    return torch.where(mask, order.long()[at], 0), mask.to(f32)


def _joint_pack(joints, invm, invi):
    """Canonical per-slot joint parameters ``[W, JC * N]`` (slot-major): the
    own body is endpoint A, so when it is endpoint B the anchors swap, weld
    rest and motor speed negate, and an angle range's bounds swap and
    negate. Returns ``(partner body, params, colour)``."""
    W, JC, N = joints["jslot"].shape
    js = joints["jslot"].reshape(W, JC * N).long()
    own_a = joints["jside"].reshape(W, JC * N) > 0

    def jg(key):
        return torch.gather(joints[key], 1, js)

    def tile_j(x):
        return x.repeat(1, JC)

    ty = jg("jtype")
    pb = torch.where(own_a, jg("jbb"), jg("jba")).long()
    aax, aay, abx, aby = jg("jaax"), jg("jaay"), jg("jabx"), jg("jaby")
    rest_j, lo_j, hi_j, ms = jg("jrest"), jg("jlo"), jg("jhi"), jg("jms")
    keep_rng = own_a | (ty != JOINT_ANGLE_RANGE)
    jd = SimpleNamespace(
        jtype=ty,
        oax=torch.where(own_a, aax, abx), oay=torch.where(own_a, aay, aby),
        pax=torch.where(own_a, abx, aax), pay=torch.where(own_a, aby, aay),
        rest=torch.where(own_a, rest_j, -rest_j),
        lo=torch.where(keep_rng, lo_j, -hi_j),
        hi=torch.where(keep_rng, hi_j, -lo_j),
        compliance=jg("jcomp"), damping=jg("jdamp"),
        motor_speed=torch.where(own_a, ms, -ms), motor_max=jg("jmm"),
        im_o=tile_j(invm), im_p=torch.gather(invm, 1, pb),
        ii_o=tile_j(invi), ii_p=torch.gather(invi, 1, pb),
        active=joints["jact"].reshape(W, JC * N),
    )
    return pb, jd, jg("jcolor")


def frame2_plain(posx, posy, ang, velx, vely, angvel, invm, invi, dyn, kin,
                 cbody, vlx, vly, nverts, radius, fric, rest, sensor,
                 partner, slot_act, gravity, owners, *, C, substeps,
                 iterations, h, dt, margin, compliance, relaxation, max_dpos,
                 rest_threshold, lin_damp, ang_damp, joints=None,
                 joint_solver="jacobi", n_colors=1, max_dpos_joint=1e3,
                 bullet=None, ccd=False, ccd_slop=0.005):
    """Plain PyTorch twin of :func:`run_frame2`: the TPU kernel's sequence
    of array operations, with ``torch.gather`` in place of its lane gathers
    and the slots of a row packed on one axis ``[W, C * M]`` (slot-major),
    the joint slots of a body on ``[W, JC * N]``."""
    W, N = posx.shape
    M = cbody.shape[1]
    V = vlx.shape[1]
    cbl = cbody.long()

    def gat(x, idx):
        return torch.gather(x, 1, idx)

    def tile_c(x):  # [W, M] -> [W, C*M]: own-side quantity per slot
        return x.repeat(1, C)

    def sum_c(x):  # [..., C*M] -> [..., M]: row sums in slot order
        acc = x[..., 0:M]
        for c in range(1, C):
            acc = acc + x[..., c * M:(c + 1) * M]
        return acc

    def min_c(x):  # [..., C*M] -> [..., M]: row minima over the slots
        acc = x[..., 0:M]
        for c in range(1, C):
            acc = torch.minimum(acc, x[..., c * M:(c + 1) * M])
        return acc

    oidx, omask = _owner_table(*owners)

    def to_bodies(vals):  # [4, W, M] row sums -> [4, W, N] body sums
        acc = None
        for k in range(oidx.shape[0]):
            g = vals[..., oidx[k]] * omask[k]
            acc = g if acc is None else acc + g
        return acc

    gx = gravity[:, 0:1]
    gy = gravity[:, 1:2]
    px, py, an = posx, posy, ang
    vx, vy, om = velx, vely, angvel

    ca_b, sa_b = torch.cos(an), torch.sin(an)
    o_px, o_py = gat(px, cbl), gat(py, cbl)
    o_ca, o_sa = gat(ca_b, cbl), gat(sa_b, cbl)
    o_invm, o_invi = gat(invm, cbl), gat(invi, cbl)
    # conservative per-collider speed bound for the speculative margin
    ext = None
    for v in range(V):
        d = torch.sqrt(vlx[:, v] ** 2 + vly[:, v] ** 2)
        ext = d if ext is None else torch.maximum(ext, d)
    ext = ext + radius
    spd_b = torch.sqrt(vx * vx + vy * vy)
    o_spd = gat(spd_b, cbl) + torch.abs(gat(om, cbl)) * ext

    pc = partner.reshape(W, C * M).long()
    act = slot_act.reshape(W, C * M)
    pb = gat(cbody, pc).long()
    p_px, p_py = gat(px, pb), gat(py, pb)
    p_ca, p_sa = gat(ca_b, pb), gat(sa_b, pb)
    p_spd = gat(spd_b, pb) + torch.abs(gat(om, pb)) * gat(ext, pc)
    o_px_t, o_py_t = tile_c(o_px), tile_c(o_py)
    o_ca_t, o_sa_t = tile_c(o_ca), tile_c(o_sa)

    own_wx, own_wy, par_wx, par_wy = [], [], [], []
    for v in range(V):
        ovx, ovy = vlx[:, v], vly[:, v]
        own_wx.append(tile_c(o_px + o_ca * ovx - o_sa * ovy))
        own_wy.append(tile_c(o_py + o_sa * ovx + o_ca * ovy))
        pvx, pvy = gat(ovx, pc), gat(ovy, pc)
        par_wx.append(p_px + p_ca * pvx - p_sa * pvy)
        par_wy.append(p_py + p_sa * pvx + p_ca * pvy)

    margin_eff = margin + dt * (tile_c(o_spd) + p_spd)
    m = manifold_batch(
        torch.stack(own_wx), torch.stack(own_wy), tile_c(nverts),
        tile_c(radius), torch.stack(par_wx), torch.stack(par_wy),
        gat(nverts, pc), gat(radius, pc), margin_eff)
    # body-local anchors and normal (rotate by -angle at frame start)
    dxa = m.wa_x - o_px_t[None]
    dya = m.wa_y - o_py_t[None]
    dxb = m.wb_x - p_px[None]
    dyb = m.wb_y - p_py[None]
    pmask = m.pmask * act[None]
    solvable = act * (1.0 - torch.maximum(tile_c(sensor), gat(sensor, pc)))
    cb_ = SimpleNamespace(
        n_ax=o_ca_t * m.n_x + o_sa_t * m.n_y,
        n_ay=-o_sa_t * m.n_x + o_ca_t * m.n_y,
        a_ax=o_ca_t[None] * dxa + o_sa_t[None] * dya,
        a_ay=-o_sa_t[None] * dxa + o_ca_t[None] * dya,
        b_ax=p_ca[None] * dxb + p_sa[None] * dyb,
        b_ay=-p_sa[None] * dxb + p_ca[None] * dyb,
        solve_mask=pmask * solvable[None], pmask=pmask, sep=m.sep,
    )
    pd_ = SimpleNamespace(
        friction=torch.sqrt(tile_c(fric) * gat(fric, pc)),
        restitution=torch.maximum(tile_c(rest), gat(rest, pc)),
        inv_mass_a=tile_c(o_invm), inv_mass_b=gat(invm, pb),
        inv_inertia_a=tile_c(o_invi), inv_inertia_b=gat(invi, pb),
    )
    touched = ((m.sep < TOUCH_SLOP).to(f32) * pmask).amax(dim=0)

    def slot_pose(cab, sab, px, py):
        return PairPose(
            tile_c(gat(px, cbl)), tile_c(gat(py, cbl)),
            tile_c(gat(cab, cbl)), tile_c(gat(sab, cbl)),
            gat(px, pb), gat(py, pb), gat(cab, pb), gat(sab, pb))

    def slot_vel(vx, vy, om):
        return PairVel(
            tile_c(gat(vx, cbl)), tile_c(gat(vy, cbl)), tile_c(gat(om, cbl)),
            gat(vx, pb), gat(vy, pb), gat(om, pb))

    jd = None
    if joints is not None:
        JC = joints["jslot"].shape[1]
        pb_j, jd, jcolor = _joint_pack(joints, invm, invi)

        def tile_j(x):  # [W, N] -> [W, JC*N]: own-side quantity per slot
            return x.repeat(1, JC)

        def sum_j(x):  # [..., JC*N] -> [..., N]: body sums in slot order
            acc = x[..., 0:N]
            for jc in range(1, JC):
                acc = acc + x[..., jc * N:(jc + 1) * N]
            return acc

        def joint_pose(cab, sab, px, py):
            """Own pose is the body itself; the partner is gathered."""
            return PairPose(tile_j(px), tile_j(py), tile_j(cab), tile_j(sab),
                            gat(px, pb_j), gat(py, pb_j), gat(cab, pb_j),
                            gat(sab, pb_j))

        def joint_rows(jd_, cab, sab, px, py, an):
            return sum_j(solve_joints_b(joint_pose(cab, sab, px, py),
                                        tile_j(an), gat(an, pb_j), jd_, h))

    # the static-friction reference is carried from the previous substep's
    # velocity-pass kinematics, starting at the frame-start pose; with CCD
    # so is the world normal (the TOI's frame-start side)
    kin00 = _pair_kinematics(
        cb_, slot_pose(torch.cos(an), torch.sin(an), px, py))
    kin0, n0 = kin00[6:10], kin00[0:2]
    blt_t = tile_c(gat(bullet, cbl)) if ccd else None
    for _ in range(substeps):
        px0, py0, an0 = px, py, an
        vx = vx + gx * h * dyn
        vy = vy + gy * h * dyn
        px = px + vx * h
        py = py + vy * h
        an = an + om * h
        vtx, vty, vtom = vx, vy, om

        if ccd:
            # continuous collision: clamp bullets' integrated advance at
            # their earliest TOI against the frame manifolds; velocities
            # are not scaled (restitution sees the true approach speed)
            wax1, way1, wbx1, wby1 = _pair_kinematics(
                cb_, slot_pose(torch.cos(an), torch.sin(an), px, py))[6:10]
            wax0, way0, wbx0, wby0 = kin0
            nxp, nyp = n0[0][None], n0[1][None]
            c0 = (wbx0 - wax0) * nxp + (wby0 - way0) * nyp
            c1 = (wbx1 - wax1) * nxp + (wby1 - way1) * nyp
            advance = c0 - c1
            allowed = torch.clamp(c0, min=0.0) + ccd_slop
            need = (advance > allowed) & (cb_.solve_mask > 0.0)
            f_pt = torch.where(need, allowed / torch.clamp(advance, min=1e-10),
                               1.0)
            f_slot = torch.where(blt_t > 0, torch.minimum(f_pt[0], f_pt[1]),
                                 1.0)
            # collider -> body: 1 - sum(1 - f), exact for one-collider
            # bullets and conservative for compound ones
            neg = to_bodies((1.0 - min_c(f_slot))[None])[0]
            f_body = torch.clamp(1.0 - neg, 0.0, 1.0)
            hit = f_body < 1.0  # unclamped bodies keep their pose bitwise
            px = torch.where(hit, px0 + f_body * (px - px0), px)
            py = torch.where(hit, py0 + f_body * (py - py0), py)
            an = torch.where(hit, an0 + f_body * (an - an0), an)

        dxx = torch.zeros_like(px)
        dxy = torch.zeros_like(py)
        dth = torch.zeros_like(an)
        lam_n = torch.zeros_like(cb_.sep)
        for _it in range(iterations):
            cab, sab = torch.cos(an), torch.sin(an)
            pose = slot_pose(cab, sab, px, py)
            vals_a, _, lam_i = solve_contacts_b(
                pose, None, pd_, cb_, h, compliance, kin0=kin0)
            lam_n = lam_n + lam_i
            ab = to_bodies(sum_c(vals_a))
            if jd is not None and joint_solver == "jacobi":
                # joints: averaged Jacobi fused with the contact apply
                ab = ab + joint_rows(jd, cab, sab, px, py, an)
            cnt = torch.clamp(ab[3], min=1.0)
            ddx = torch.clamp(ab[0] * relaxation / cnt, -max_dpos, max_dpos)
            ddy = torch.clamp(ab[1] * relaxation / cnt, -max_dpos, max_dpos)
            dda = torch.clamp(ab[2] * relaxation / cnt, -max_dpos, max_dpos)
            px = px + ddx
            py = py + ddy
            an = an + dda
            dxx = dxx + ddx
            dxy = dxy + ddy
            dth = dth + dda
            if jd is not None and joint_solver == "colored":
                # coloured Gauss-Seidel: one pass per colour, the last one
                # sweeping every colour past the static bound; clipped by
                # the raw max_dpos (upkeep, not depenetration)
                for color in range(n_colors):
                    cmask = (jcolor >= color if color == n_colors - 1
                             else jcolor == color)
                    jd_c = SimpleNamespace(**vars(jd))
                    jd_c.active = jd.active * cmask.to(jd.active.dtype)
                    abj = joint_rows(jd_c, torch.cos(an), torch.sin(an),
                                     px, py, an)
                    cntj = torch.clamp(abj[3], min=1.0)
                    jdx = torch.clamp(abj[0] / cntj, -max_dpos_joint,
                                      max_dpos_joint)
                    jdy = torch.clamp(abj[1] / cntj, -max_dpos_joint,
                                      max_dpos_joint)
                    jda = torch.clamp(abj[2] / cntj, -max_dpos_joint,
                                      max_dpos_joint)
                    px = px + jdx
                    py = py + jdy
                    an = an + jda
                    dxx = dxx + jdx
                    dxy = dxy + jdy
                    dth = dth + jda

        # velocity reconstruction (kinematic bodies keep their velocity)
        nk = 1.0 - kin
        vx = kin * vx + nk * (vtx + dxx / h)
        vy = kin * vy + nk * (vty + dxy / h)
        om = kin * om + nk * (vtom + dth / h)

        # velocity pass: restitution + dynamic friction + motors/damping
        cab, sab = torch.cos(an), torch.sin(an)
        pose_v = slot_pose(cab, sab, px, py)
        kin_v = _pair_kinematics(cb_, pose_v)
        cv_a, _ = velocity_contacts_b(
            pose_v, slot_vel(vx, vy, om), slot_vel(vtx, vty, vtom), pd_, cb_,
            lam_n, h, rest_threshold, kin=kin_v)
        abv = to_bodies(sum_c(cv_a))
        tk = ((lam_n > 0.0).to(f32) * cb_.pmask).amax(dim=0)
        touched = torch.maximum(touched, tk)
        if jd is not None:
            pvel_j = PairVel(tile_j(vx), tile_j(vy), tile_j(om),
                             gat(vx, pb_j), gat(vy, pb_j), gat(om, pb_j))
            abv = abv + sum_j(velocity_joints_b(
                joint_pose(cab, sab, px, py), pvel_j, jd, h))
        cntv = torch.clamp(abv[3], min=1.0)
        vx = vx + abv[0] / cntv
        vy = vy + abv[1] / cntv
        om = om + abv[2] / cntv
        if lin_damp > 0.0:
            sdamp = 1.0 / (1.0 + h * lin_damp)
            vx = vx * sdamp
            vy = vy * sdamp
        if ang_damp > 0.0:
            om = om * (1.0 / (1.0 + h * ang_damp))
        kin0, n0 = kin_v[6:10], kin_v[0:2]
    return px, py, an, vx, vy, om, touched.reshape(W, C, M)


def run_frame2(posx, posy, ang, velx, vely, angvel, invm, invi, dyn, kin,
               cbody, vlx, vly, nverts, radius, fric, rest, sensor,
               partner, slot_act, gravity, *, C, substeps, iterations, h, dt,
               margin, compliance, relaxation, max_dpos, rest_threshold,
               lin_damp, ang_damp, owners=None, joints=None, JC: int = 0,
               joint_solver: str = "jacobi", n_colors: int = 1,
               max_dpos_joint: float = 1e3, bullet=None, ccd: bool = False,
               ccd_slop: float = 0.005, plain: bool = False):
    """Run one frame's XPBD substeps for a world batch.

    Body arrays are ``[W, N]`` f32, collider arrays ``[W, M]`` (``cbody``,
    ``nverts`` i32; verts ``vlx``/``vly`` ``[W, V, M]``), slot tables
    ``[W, C, M]`` and ``gravity`` ``[W, 2]``. ``owners`` is
    :func:`owner_csr` of ``cbody[0]``, built here when not given.
    ``joints`` (or None: contact-only) is a dict of the joint parameters
    ``[W, J]`` under ``_build.JOINT_KEYS`` (``jtype``, ``jba``, ``jbb``,
    ``jcolor`` i32, the rest f32, ``jmm`` with +inf as 3.4e38) and the
    joint slots ``jslot``/``jside``/``jact`` ``[W, JC, N]`` of
    ``build_joint_slots``; ``joint_solver`` is ``"colored"`` (``n_colors``
    Gauss-Seidel passes, clipped by ``max_dpos_joint``) or ``"jacobi"``.
    ``ccd=True`` (``bullet [W, N]`` f32, 1 on a bullet body) clamps each
    substep's integrated advance of a bullet at the earliest time of impact
    over its colliders' slots, landing it at ``ccd_slop`` of penetration
    (counted in ``run_frame2.ccd_launches``). Returns ``(posx, posy, ang, velx, vely, angvel, touched [W, C, M])``.
    ``plain=True`` runs the twin even on CUDA tensors (for timing the kernel
    against it)."""
    W, N = posx.shape
    M = cbody.shape[1]
    V = vlx.shape[1]
    dev = posx.device
    checks = [(nm, t, f32, (W, N)) for nm, t in (
        ("posx", posx), ("posy", posy), ("ang", ang), ("velx", velx),
        ("vely", vely), ("angvel", angvel), ("invm", invm), ("invi", invi),
        ("dyn", dyn), ("kin", kin))]
    checks += [
        ("cbody", cbody, i32, (W, M)), ("vlx", vlx, f32, (W, V, M)),
        ("vly", vly, f32, (W, V, M)), ("nverts", nverts, i32, (W, M)),
        ("radius", radius, f32, (W, M)), ("fric", fric, f32, (W, M)),
        ("rest", rest, f32, (W, M)), ("sensor", sensor, f32, (W, M)),
        ("partner", partner, i32, (W, C, M)),
        ("slot_act", slot_act, f32, (W, C, M)),
        ("gravity", gravity, f32, (W, 2))]
    if owners is None:
        owners = owner_csr(cbody[0], N)
    checks += [("owner start", owners[0], i32, (N + 1,)),
               ("owner idx", owners[1], i32, (M,))]
    J = 0
    if joints is not None:
        if joint_solver not in ("colored", "jacobi"):
            raise ValueError(f"unknown joint_solver {joint_solver!r}")
        J = joints["jtype"].shape[1]
        ints = ("jtype", "jba", "jbb", "jcolor", "jslot")
        checks += [(k, joints[k], i32 if k in ints else f32, (W, J))
                   for k in _build.JOINT_KEYS]
        checks += [(k, joints[k], i32 if k in ints else f32, (W, JC, N))
                   for k in JOINT_SLOT_KEYS]
    if ccd:
        if bullet is None:
            raise ValueError("ccd=True needs the bodies' bullet flags")
        checks.append(("bullet", bullet, f32, (W, N)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    params = dict(C=C, substeps=substeps, iterations=iterations, h=h, dt=dt,
                  margin=margin, compliance=compliance,
                  relaxation=relaxation, max_dpos=max_dpos,
                  rest_threshold=rest_threshold, lin_damp=lin_damp,
                  ang_damp=ang_damp)
    if plain or not _route(dev):
        return frame2_plain(posx, posy, ang, velx, vely, angvel, invm, invi,
                            dyn, kin, cbody, vlx, vly, nverts, radius, fric,
                            rest, sensor, partner, slot_act, gravity, owners,
                            joints=joints, joint_solver=joint_solver,
                            n_colors=n_colors, max_dpos_joint=max_dpos_joint,
                            bullet=bullet, ccd=ccd, ccd_slop=ccd_slop,
                            **params)

    lib = _build.library()
    if lib.sf_frame2_fields() != SCRATCH_FIELDS:
        raise RuntimeError("frame kernel scratch layout differs from "
                           "SCRATCH_FIELDS")
    Vk = kernel_verts(V)
    if Vk is None:
        raise ValueError(f"frame kernel supports up to {_KERNEL_V[-1]} "
                         f"vertices per collider, got {V}")
    smem = frame2_shared_bytes(N, M, Vk, J)
    if lib.sf_frame2_shared_bytes(N, M, Vk, J) != smem:
        raise RuntimeError("frame kernel shared-memory layout differs from "
                           "frame2_shared_bytes")
    if smem > SHARED_LIMIT:
        raise ValueError(f"frame kernel needs {smem} bytes of shared memory "
                         f"for N={N}, M={M}, V={Vk}, J={J}; a block has "
                         f"{SHARED_LIMIT}")
    if Vk != V:  # pad with copies of v0: every min, max and manifold holds
        vlx = torch.cat([vlx, vlx[:, :1].expand(W, Vk - V, M)], 1)
        vly = torch.cat([vly, vly[:, :1].expand(W, Vk - V, M)], 1)
    ostart, oidx = owners
    scratch = torch.empty((W, SCRATCH_FIELDS, C, M), dtype=f32, device=dev)
    outs = [torch.empty((W, N), dtype=f32, device=dev) for _ in range(6)]
    touched = torch.empty((W, C, M), dtype=f32, device=dev)
    # CCD: the world normal of each slot, carried between substeps
    ccd_scratch = (torch.empty((W, 2, C, M), dtype=f32, device=dev) if ccd
                   else None)
    p = _build.ptr
    jptrs = [p(joints[k]) if joints is not None else None
             for k in _build.JOINT_KEYS + JOINT_SLOT_KEYS]
    args = _build.Frame2Args(
        *(p(t) for t in (posx, posy, ang, velx, vely, angvel, invm, invi,
                         dyn, kin, cbody, vlx, vly, nverts, radius, fric,
                         rest, sensor, partner, slot_act, gravity, ostart,
                         oidx, scratch, *outs, touched)),
        W, N, M, Vk, C, substeps, iterations,
        h, dt, margin, compliance / (h * h), relaxation, max_dpos,
        rest_threshold, 1.0 / (1.0 + h * lin_damp),
        1.0 / (1.0 + h * ang_damp), int(lin_damp > 0.0),
        int(ang_damp > 0.0), *jptrs, J, JC if joints is not None else 0,
        int(joint_solver == "colored"), n_colors, max_dpos_joint, h * h,
        p(bullet) if ccd else None,
        p(ccd_scratch) if ccd else None, int(ccd), ccd_slop)
    _build.launch("sf_frame2", args, dev)
    if ccd:
        run_frame2.ccd_launches += 1
    else:
        run_frame2.launches += 1
    return (*outs, touched)


run_frame2.launches = 0
run_frame2.ccd_launches = 0  # the ccd instances', counted apart
