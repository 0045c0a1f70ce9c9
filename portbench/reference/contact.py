"""Contact geometry and the XPBD contact solve of one directed pair, in plain
PyTorch over a flat pair axis ``P``.

The benchmark's own statement of the engine's contact semantics (rounded
convex polygons, SAT with edge clipping, Jacobi-averaged XPBD projection
with static friction at position level, then restitution and dynamic
friction in a velocity pass), written from the method's equations. It
imports nothing of the program. A pair is directed: ``a`` is the row that
receives the correction, ``b`` its partner; every tensor is ``[P]`` or
``[2, P]`` (the manifold's two points) or ``[V, P]`` (vertices), in the
dtype of its inputs, so the same code runs in float32 and, as the
benchmark's control, in bfloat16.
"""

from __future__ import annotations

import torch

EPS = 1e-10
PARALLEL_COS = 0.98
INF = float("inf")


def _edges(vx, vy, nv):
    """Edge starts, ends, outward normals and validity of CCW polygons
    padded with their first vertex (``[V, P]``)."""
    V = vx.shape[0]
    idx = torch.arange(V, device=vx.device)[:, None]
    last = idx == (nv[None] - 1)
    ex = torch.where(last, vx[0][None], torch.roll(vx, -1, 0))
    ey = torch.where(last, vy[0][None], torch.roll(vy, -1, 0))
    dx, dy = ex - vx, ey - vy
    length = torch.sqrt(dx * dx + dy * dy)
    valid = (idx < nv[None]) & (nv[None] >= 2) & (length > 1e-9)
    inv = 1.0 / torch.clamp(length, min=EPS)
    return ex, ey, dy * inv, -dx * inv, valid


def _first(mask):
    """One-hot ``[V, P]`` of the first true row of each column."""
    seen = torch.cumsum(mask.to(torch.int32), 0)
    return (mask & (seen == 1)).to(torch.float32)


def _pick(onehot, rows):
    return (onehot.to(rows.dtype) * rows).sum(0)


def _sat(sx, sy, nx, ny, valid, ox, oy):
    """Largest separation over one polygon's edge normals against the other
    polygon's vertices, and the one-hot of that edge."""
    proj = nx[:, None] * ox[None] + ny[:, None] * oy[None]  # [V, V', P]
    sep = proj.amin(1) - (nx * sx + ny * sy)
    sep = torch.where(valid, sep, torch.full_like(sep, -INF))
    best = sep.amax(0)
    return best, _first(sep == best[None])


def _closest(p1x, p1y, q1x, q1y, p2x, p2y, q2x, q2y):
    """Closest points of two segments (Ericson, 5.1.9), degenerate-safe."""
    d1x, d1y = q1x - p1x, q1y - p1y
    d2x, d2y = q2x - p2x, q2y - p2y
    rx, ry = p1x - p2x, p1y - p2y
    a = d1x * d1x + d1y * d1y
    e = d2x * d2x + d2y * d2y
    f = d2x * rx + d2y * ry
    c = d1x * rx + d1y * ry
    b = d1x * d2x + d1y * d2y
    denom = a * e - b * b
    a0, e0 = a <= EPS, e <= EPS
    a1 = torch.where(a0, torch.ones_like(a), a)
    e1 = torch.where(e0, torch.ones_like(e), e)
    dn = denom > EPS
    s = torch.where(dn, torch.clamp(
        (b * f - c * e) / torch.where(dn, denom, torch.ones_like(denom)),
        0.0, 1.0), torch.zeros_like(a))
    t = (b * s + f) / e1
    tc = torch.clamp(t, 0.0, 1.0)
    s = torch.where((t < 0.0) | (t > 1.0),
                    torch.clamp((b * tc - c) / a1, 0.0, 1.0), s)
    zero = torch.zeros_like(a)
    s = torch.where(a0, zero, torch.where(e0, torch.clamp(-c / a1, 0.0, 1.0),
                                          s))
    t = torch.where(a0 & e0, zero, torch.where(
        a0, torch.clamp(f / e1, 0.0, 1.0), torch.where(e0, zero, tc)))
    return p1x + d1x * s, p1y + d1y * s, p2x + d2x * t, p2y + d2y * t


def manifold(ax, ay, na, ra, bx, by, nb, rb, margin):
    """The contact manifold of rounded convex polygons ``a`` and ``b``
    (world vertices ``[V, P]``, vertex counts, radii, per-pair margin).
    Returns ``(nx, ny [P], wax, way, wbx, wby, sep, pmask [2, P])``: the
    normal from ``a`` to ``b``, each point's surface points on ``a`` and
    ``b``, its separation, and 1 where the point lies within the margin."""
    eax, eay, anx, any_, av = _edges(ax, ay, na)
    ebx, eby, bnx, bny, bv = _edges(bx, by, nb)
    sep_a, oh_a = _sat(ax, ay, anx, any_, av, bx, by)
    sep_b, oh_b = _sat(bx, by, bnx, bny, bv, ax, ay)
    a_poly, b_poly = na >= 2, nb >= 2
    points = ~(a_poly | b_poly)
    flip = sep_b > sep_a + 1e-5
    core = torch.maximum(sep_a, sep_b)

    def sel(fa, fb):
        return torch.where(flip, fb, fa)

    # reference edge (the face of largest separation) and the radii
    r0x = sel(_pick(oh_a, ax), _pick(oh_b, bx))
    r0y = sel(_pick(oh_a, ay), _pick(oh_b, by))
    r1x = sel(_pick(oh_a, eax), _pick(oh_b, ebx))
    r1y = sel(_pick(oh_a, eay), _pick(oh_b, eby))
    nrx = sel(_pick(oh_a, anx), _pick(oh_b, bnx))
    nry = sel(_pick(oh_a, any_), _pick(oh_b, bny))
    rr, ri = sel(ra, rb), sel(rb, ra)

    # incident edge: the other polygon's most anti-parallel edge
    da = torch.where(av, anx * nrx + any_ * nry, torch.full_like(anx, INF))
    db = torch.where(bv, bnx * nrx + bny * nry, torch.full_like(bnx, INF))
    mina, minb = da.amin(0), db.amin(0)
    oa, ob = _first(da == mina[None]), _first(db == minb[None])
    has_inc = (flip & a_poly) | (~flip & b_poly)

    def inc(ox, fx_b, fx_a):
        b0, a0 = (bx[0], ax[0]) if ox else (by[0], ay[0])
        return sel(torch.where(b_poly, _pick(ob, fx_b), b0),
                   torch.where(a_poly, _pick(oa, fx_a), a0))

    i0x, i0y = inc(True, bx, ax), inc(False, by, ay)
    i1x, i1y = inc(True, ebx, eax), inc(False, eby, eay)
    inc_dot = sel(minb, mina)

    # clip the incident edge to the reference edge's extent
    tx, ty = r1x - r0x, r1y - r0y
    inv_t = 1.0 / torch.clamp(torch.sqrt(tx * tx + ty * ty), min=EPS)
    tx, ty = tx * inv_t, ty * inv_t
    lo, hi = tx * r0x + ty * r0y, tx * r1x + ty * r1y
    s0, s1 = tx * i0x + ty * i0y, tx * i1x + ty * i1y
    ds = s1 - s0
    ds_ok = torch.abs(ds) > 1e-6
    inv_ds = torch.where(ds_ok, 1.0 / torch.where(ds_ok, ds, torch.ones_like(
        ds)), torch.zeros_like(ds))
    lo_, hi_ = torch.minimum(lo, hi), torch.maximum(lo, hi)
    c0 = torch.minimum(torch.maximum(s0, lo_), hi_)
    c1 = torch.minimum(torch.maximum(s1, lo_), hi_)
    f0, f1 = (c0 - s0) * inv_ds, (c1 - s0) * inv_ds
    deep0 = (nrx * i0x + nry * i0y) <= (nrx * i1x + nry * i1y)
    dpx, dpy = torch.where(deep0, i0x, i1x), torch.where(deep0, i0y, i1y)
    q0x = torch.where(ds_ok, i0x + (i1x - i0x) * f0, dpx)
    q0y = torch.where(ds_ok, i0y + (i1y - i0y) * f0, dpy)
    q1x = torch.where(ds_ok, i0x + (i1x - i0x) * f1, dpx)
    q1y = torch.where(ds_ok, i0y + (i1y - i0y) * f1, dpy)

    def clip(qx, qy):
        plane = nrx * (qx - r0x) + nry * (qy - r0y)
        return (plane - rr - ri, qx - nrx * plane + nrx * rr,
                qy - nry * plane + nry * rr, qx - nrx * ri, qy - nry * ri)

    k0, k1 = clip(q0x, q0y), clip(q1x, q1y)
    distinct = torch.sqrt((q1x - q0x) ** 2 + (q1y - q0y) ** 2) > 1e-6

    # closest features, for separated or thin shapes
    p1x, p1y, p2x, p2y = _closest(r0x, r0y, r1x, r1y, i0x, i0y, i1x, i1y)
    p1x = torch.where(points, sel(ax[0], bx[0]), p1x)
    p1y = torch.where(points, sel(ay[0], by[0]), p1y)
    p2x = torch.where(points, sel(bx[0], ax[0]), p2x)
    p2y = torch.where(points, sel(by[0], ay[0]), p2y)
    dx, dy = p2x - p1x, p2y - p1y
    d = torch.sqrt(dx * dx + dy * dy)
    inv_d = 1.0 / torch.clamp(d, min=EPS)
    far = d > 1e-9
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    ncx = torch.where(far, dx * inv_d, torch.where(points, zero, nrx))
    ncy = torch.where(far, dy * inv_d, torch.where(points, one, nry))
    kc = (d - rr - ri, p1x + ncx * rr, p1y + ncy * rr, p2x - ncx * ri,
          p2y - ncy * ri)

    parallel = has_inc & (inc_dot < -PARALLEL_COS)
    thin = (na <= 2) & (nb <= 2)
    use_clip = ~points & (((core <= 0.0) & ~thin)
                          | (parallel & (torch.abs(c1 - c0) > 1e-6)))
    u = use_clip[None]
    sep, wrx, wry, wix, wiy = (
        torch.where(u, torch.stack([x0, x1]), torch.stack([xc, xc]))
        for x0, x1, xc in zip(k0, k1, kc))
    pm0 = sep[0] < margin
    pm1 = use_clip & distinct & (sep[1] < margin)
    pmask = torch.stack([pm0, pm1]).to(ax.dtype)
    sgn = torch.where(flip, -one, one)
    nx = torch.where(use_clip, nrx, ncx) * sgn
    ny = torch.where(use_clip, nry, ncy) * sgn
    fl = flip[None]
    return (nx, ny, torch.where(fl, wix, wrx), torch.where(fl, wiy, wry),
            torch.where(fl, wrx, wix), torch.where(fl, wry, wiy), sep, pmask)


def world_geometry(pair, pose):
    """World normal, anchor offsets and anchor points of the pairs' frozen
    body-local contact data at ``pose = (pax, pay, ca, sa, pbx, pby, cb,
    sb)``, each ``[P]``: positions, cos and sin of ``a`` and ``b``."""
    pax, pay, ca, sa, pbx, pby, cb, sb = pose
    nx = ca * pair["nax"] - sa * pair["nay"]
    ny = sa * pair["nax"] + ca * pair["nay"]
    rax = ca * pair["aax"] - sa * pair["aay"]
    ray = sa * pair["aax"] + ca * pair["aay"]
    rbx = cb * pair["bax"] - sb * pair["bay"]
    rby = sb * pair["bax"] + cb * pair["bay"]
    return (nx, ny, rax, ray, rbx, rby, pax + rax, pay + ray, pbx + rbx,
            pby + rby)


def project(pair, geo, geo0, h, compliance):
    """One XPBD projection of the pairs' points. ``geo``: the geometry at
    the integrated poses; ``geo0``: at the substep's start (the static
    friction reference). Returns ``(dx, dy, dang, count [P], lam [2, P])``,
    the correction ``a`` receives from this pair."""
    ima, imb, iia, iib = pair["ima"], pair["imb"], pair["iia"], pair["iib"]
    nx, ny, rax, ray, rbx, rby, wax, way, wbx, wby = geo
    c = (wbx - wax) * nx + (wby - way) * ny
    active = (c < 0.0) & (pair["solve"] > 0.0)
    cra, crb = rax * ny - ray * nx, rbx * ny - rby * nx
    den = ((ima + iia * cra * cra) + (imb + iib * crb * crb)
           + compliance / (h * h))
    lam = torch.where(active & (den > EPS), -c / torch.clamp(den, min=EPS),
                      torch.zeros_like(c))
    px, py = lam * nx, lam * ny
    _, _, _, _, _, _, wax0, way0, wbx0, wby0 = geo0
    dx = (wax - wax0) - (wbx - wbx0)
    dy = (way - way0) - (wby - wby0)
    dn = dx * nx + dy * ny
    tx, ty = dx - dn * nx, dy - dn * ny
    ct = torch.sqrt(tx * tx + ty * ty)
    inv = 1.0 / torch.clamp(ct, min=EPS)
    tx, ty = tx * inv, ty * inv
    crat, crbt = rax * ty - ray * tx, rbx * ty - rby * tx
    dent = (ima + iia * crat * crat) + (imb + iib * crbt * crbt)
    lt = torch.where(dent > EPS, -ct / torch.clamp(dent, min=EPS),
                     torch.zeros_like(ct))
    stick = active & (torch.abs(lt) < pair["fric"] * lam)
    zero = torch.zeros_like(lt)
    qx = torch.where(stick, lt * tx, zero)
    qy = torch.where(stick, lt * ty, zero)
    fx, fy = (-px + qx).sum(0), (-py + qy).sum(0)
    dang = (iia * (-(rax * py - ray * px) + (rax * qy - ray * qx))).sum(0)
    return (fx * ima, fy * ima, dang, active.sum(0).to(lam.dtype), lam)


def velocity(pair, geo, vel, vel0, lam, h, rest_threshold):
    """Restitution and dynamic friction: the velocity change ``a`` receives
    from this pair, ``(dvx, dvy, dw, count [P])``. ``vel = (vax, vay, wa,
    vbx, vby, wb)``, each ``[P]``: the reconstructed velocities; ``vel0``:
    the integrated ones."""
    ima, imb, iia, iib = pair["ima"], pair["imb"], pair["iia"], pair["iib"]
    nx, ny, rax, ray, rbx, rby = geo[:6]

    def at(vx, vy, w, rx, ry):
        return vx - w * ry, vy + w * rx

    uax, uay = at(*vel[:3], rax, ray)
    ubx, uby = at(*vel[3:], rbx, rby)
    rx, ry = ubx - uax, uby - uay
    vn = rx * nx + ry * ny
    utx, uty = rx - vn * nx, ry - vn * ny
    vt = torch.sqrt(utx * utx + uty * uty)
    u0ax, u0ay = at(*vel0[:3], rax, ray)
    u0bx, u0by = at(*vel0[3:], rbx, rby)
    vn0 = (u0bx - u0ax) * nx + (u0by - u0ay) * ny
    active = (lam > 0.0) & (pair["solve"] > 0.0)
    zero = torch.zeros_like(vn)
    cra, crb = rax * ny - ray * nx, rbx * ny - rby * nx
    wn = ima + iia * cra * cra + imb + iib * crb * crb
    e = torch.where(vn0 < -rest_threshold, pair["rest"].expand_as(vn0), zero)
    dvn = torch.where(active, -vn + torch.clamp(-e * vn0, min=0.0), zero)
    ln = torch.where(wn > EPS, dvn / torch.clamp(wn, min=EPS), zero)
    inv = 1.0 / torch.clamp(vt, min=EPS)
    tx, ty = utx * inv, uty * inv
    crat, crbt = rax * ty - ray * tx, rbx * ty - rby * tx
    wt = ima + iia * crat * crat + imb + iib * crbt * crbt
    lf = torch.minimum(torch.where(wt > EPS, vt / torch.clamp(wt, min=EPS),
                                   zero), pair["fric"] * lam / h)
    lf = torch.where(active, lf, zero)
    ix, iy = ln * nx - lf * tx, ln * ny - lf * ty
    sx, sy = ix.sum(0), iy.sum(0)
    dw = -(iia * (rax * iy - ray * ix)).sum(0)
    return -sx * ima, -sy * ima, dw, active.sum(0).to(lam.dtype)
