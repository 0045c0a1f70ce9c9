"""Slot tables for a world batch: the pair-eligibility mask, per-collider
partner slots and per-body joint slots.

Replaces ``starframe_tpu/pallas/slots.py``'s ``_elig_kernel`` (via
``build_elig_mask``), ``_slot_kernel`` (via ``build_slot_tables``) and
``_joint_slot_kernel`` (via ``build_joint_slots``) with the CUDA kernels in
``csrc/elig.cu``, ``csrc/slots.cu`` and ``csrc/joint_slots.cu``. Each wrapper
checks its inputs, launches its kernel for CUDA tensors (and raises if that
fails: there is no fallback) and runs the plain PyTorch twin beside it for
CPU tensors. ``<wrapper>.launches`` counts kernel launches.

Owner rows: a dynamic-dynamic overlap appears in BOTH colliders' rows (each
side applies its own half of the XPBD correction); a static or kinematic
collider owns no row. ``count`` is the true per-row candidate count; rows
with more than ``C`` candidates keep the first ``C`` in rank order (touching
now, then margin-close, then swept-speculative; by ascending partner index
within a tier), and callers surface ``max(count_touch) - C`` as the hard
overflow counter.
"""

from __future__ import annotations

import torch

from ..spans import recording
from . import _build

f32 = torch.float32
i32 = torch.int32


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(device) -> bool:
    """True: launch the CUDA kernel. CPU tensors take the plain twin; any
    other device is refused."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {device}")


# ---------------------------------------------------------------------------
# K1: static pair eligibility
# ---------------------------------------------------------------------------


def elig_mask_plain(cbody, layer, lmask, active, sensor, responds, moves):
    """Plain PyTorch twin of :func:`build_elig_mask`."""
    resp = torch.gather(responds, 1, cbody.long())
    mov = torch.gather(moves, 1, cbody.long())

    def as_i(x):  # own row i: last axis
        return x[:, None, :]

    def as_j(x):  # partner j: middle axis
        return x[:, :, None]

    diff_body = as_j(cbody) != as_i(cbody)
    layer_ok = (((as_i(lmask) >> as_j(layer)) & 1)
                & ((as_j(lmask) >> as_i(layer)) & 1)) != 0
    both_active = (as_i(active) > 0) & (as_j(active) > 0)
    sensorish = (as_i(sensor) > 0) | (as_j(sensor) > 0)
    row_ok = (as_i(resp) > 0) | ((as_i(sensor) > 0) & (as_i(mov) > 0))
    pair_moves = (as_i(mov) > 0) | (as_j(mov) > 0)
    elig = diff_body & layer_ok & both_active & row_ok & (pair_moves | sensorish)
    return elig.to(torch.int8)


def build_elig_mask(cbody, layer, lmask, active, sensor, responds, moves,
                    plain: bool = False):
    """Static pair-eligibility mask ``[W, M(j), M(i)] i8``: different body,
    layer/mask bits both ways, both active, own row responds or is a moving
    sensor, and the pair moves or holds a sensor. Depends on topology and
    flags only, so rollouts build it once. ``plain=True`` runs the twin even
    on CUDA tensors (for timing the kernel against it). The kernel takes at
    most 4096 colliders a world and raises past that."""
    W, M = cbody.shape
    N = responds.shape[1]
    dev = cbody.device
    for name, t, dt, shape in (
            ("cbody", cbody, i32, (W, M)), ("layer", layer, i32, (W, M)),
            ("lmask", lmask, i32, (W, M)), ("active", active, f32, (W, M)),
            ("sensor", sensor, f32, (W, M)),
            ("responds", responds, f32, (W, N)),
            ("moves", moves, f32, (W, N))):
        _check(name, t, dt, shape, dev)
    if plain or not _route(dev):
        return elig_mask_plain(cbody, layer, lmask, active, sensor,
                               responds, moves)
    elig = torch.empty((W, M, M), dtype=torch.int8, device=dev)
    p = _build.ptr
    args = _build.EligArgs(
        p(cbody), p(layer), p(lmask), p(active), p(sensor), p(responds),
        p(moves), p(elig), W, N, M)
    _build.launch("sf_elig", args, dev)
    build_elig_mask.launches += 1
    return elig


build_elig_mask.launches = 0


# ---------------------------------------------------------------------------
# K2: slot tables
# ---------------------------------------------------------------------------


def _boxes(posx, posy, ang, velx, vely, cbody, vlx, vly, radius, dt, margin):
    """Per-collider touch, close and swept AABBs (each ``(lox, hix, loy,
    hiy)``, [W, M]) and the per-axis sweeps, computed as the TPU kernel
    does."""
    cb = cbody.long()
    px = torch.gather(posx, 1, cb)
    py = torch.gather(posy, 1, cb)
    ca = torch.gather(torch.cos(ang), 1, cb)
    sa = torch.gather(torch.sin(ang), 1, cb)
    vx = torch.gather(velx, 1, cb)
    vy = torch.gather(vely, 1, cb)
    lox = hix = loy = hiy = None
    for v in range(vlx.shape[1]):  # padded verts repeat v0: min/max exact
        wx = px + ca * vlx[:, v] - sa * vly[:, v]
        wy = py + sa * vlx[:, v] + ca * vly[:, v]
        lox = wx if lox is None else torch.minimum(lox, wx)
        hix = wx if hix is None else torch.maximum(hix, wx)
        loy = wy if loy is None else torch.minimum(loy, wy)
        hiy = wy if hiy is None else torch.maximum(hiy, wy)
    sweep_x = torch.abs(vx) * dt
    sweep_y = torch.abs(vy) * dt
    # touch boxes: shape AABB + a jitter slop (touching/penetrating NOW)
    tpad = radius + 0.1 * margin
    touch = (lox - tpad, hix + tpad, loy - tpad, hiy + tpad)
    # close boxes: within the speculative contact margin, no sweep
    pad = radius + 0.5 * margin
    close = (lox - pad, hix + pad, loy - pad, hiy + pad)
    return touch, close, sweep_x, sweep_y


def _overlap(b):
    """Pairwise overlap ``[W, M(j), M(i)]`` of one box set."""
    lox, hix, loy, hiy = b
    return ((lox[:, :, None] <= hix[:, None, :])
            & (lox[:, None, :] <= hix[:, :, None])
            & (loy[:, :, None] <= hiy[:, None, :])
            & (loy[:, None, :] <= hiy[:, :, None]))


def _swept(close, sx, sy):
    clox, chix, cloy, chiy = close
    return (clox - sx, chix + sx, cloy - sy, chiy + sy)


def slot_tables_plain(posx, posy, ang, velx, vely, cbody, vlx, vly, radius,
                      elig, *, C: int, margin: float, dt: float,
                      partner_aware: bool):
    """Plain PyTorch twin of :func:`build_slot_tables`."""
    touch, close, sweep_x, sweep_y = _boxes(
        posx, posy, ang, velx, vely, cbody, vlx, vly, radius, dt, margin)
    el = elig != 0
    mask = _overlap(_swept(close, sweep_x, sweep_y)) & el
    if partner_aware:
        # phase 1's candidates can reach collider i within the window:
        # inflate i's sweep to the max over them, then redo the swept test
        ps = torch.where(mask, sweep_x[:, :, None], 0.0).amax(dim=1)
        ns = torch.maximum(sweep_x, ps)
        mask = _overlap(_swept(close, ns, ns)) & el
        budget = ns
    else:
        budget = torch.minimum(sweep_x, sweep_y)
    m_touch = _overlap(touch) & el & mask
    m_close = _overlap(close) & el & mask
    m_mid = m_close & ~m_touch
    m_far = mask & ~m_close

    def excl_rank(m):  # #{j' < j : m[j']} along the partner axis
        c = torch.cumsum(m.to(i32), dim=1, dtype=i32)
        return c - m.to(i32)

    cnt_t = m_touch.sum(dim=1, keepdim=True, dtype=i32)
    cnt_m = m_mid.sum(dim=1, keepdim=True, dtype=i32)
    crank = torch.where(m_touch, excl_rank(m_touch),
                        torch.where(m_mid, cnt_t + excl_rank(m_mid),
                                    cnt_t + cnt_m + excl_rank(m_far)))
    M = cbody.shape[1]
    j_iota = torch.arange(M, dtype=i32, device=cbody.device)[None, :, None]
    parts, acts = [], []
    for c in range(C):
        oh = (crank == c) & mask
        parts.append((oh.to(i32) * j_iota).sum(dim=1, dtype=i32))
        acts.append(oh.sum(dim=1, dtype=i32).to(f32))
    return (torch.stack(parts, 1), torch.stack(acts, 1),
            mask.sum(dim=1, dtype=i32), cnt_t[:, 0],
            m_close.sum(dim=1, dtype=i32), budget)


def build_slot_tables(posx, posy, ang, velx, vely, cbody, vlx, vly, radius,
                      elig, *, C: int, margin: float, dt: float,
                      partner_aware: bool = False, plain: bool = False):
    """Per-collider partner slot tables for a world batch.

    Returns ``(partner [W, C, M] i32, slot_active [W, C, M] f32,
    count [W, M] i32, count_touch [W, M] i32, count_close [W, M] i32,
    budget [W, M] f32)``. ``velx``/``vely`` are the per-body sweep speeds
    (the swept box grows by ``|v| * dt`` per axis); ``partner_aware=True``
    needs symmetric sweeps (pass ``vely=None``) and inflates each row's
    sweep to the max over its phase-1 candidates, reporting that inflation
    in ``budget``. ``elig`` comes from :func:`build_elig_mask`.
    """
    if partner_aware and vely is not None:
        raise ValueError(
            "build_slot_tables(partner_aware=True) needs symmetric sweeps: "
            "pass the positional-budget array as velx and vely=None")
    if vely is None:
        vely = velx
    W, N = posx.shape
    M = cbody.shape[1]
    V = vlx.shape[1]
    dev = posx.device
    for name, t, dtype, shape in (
            ("posx", posx, f32, (W, N)), ("posy", posy, f32, (W, N)),
            ("ang", ang, f32, (W, N)), ("velx", velx, f32, (W, N)),
            ("vely", vely, f32, (W, N)), ("cbody", cbody, i32, (W, M)),
            ("vlx", vlx, f32, (W, V, M)), ("vly", vly, f32, (W, V, M)),
            ("radius", radius, f32, (W, M)),
            ("elig", elig, torch.int8, (W, M, M))):
        _check(name, t, dtype, shape, dev)
    if plain or not _route(dev):
        return slot_tables_plain(
            posx, posy, ang, velx, vely, cbody, vlx, vly, radius, elig,
            C=C, margin=margin, dt=dt, partner_aware=partner_aware)
    partner = torch.empty((W, C, M), dtype=i32, device=dev)
    slot_act = torch.empty((W, C, M), dtype=f32, device=dev)
    count, count_touch, count_close = (
        torch.empty((W, M), dtype=i32, device=dev) for _ in range(3))
    budget = torch.empty((W, M), dtype=f32, device=dev)
    p = _build.ptr
    # the pads are formed in double precision and rounded once, as the
    # reference does with its Python-float margin
    args = _build.SlotArgs(
        p(posx), p(posy), p(ang), p(velx), p(vely), p(cbody), p(vlx), p(vly),
        p(radius), p(elig), p(partner), p(slot_act), p(count),
        p(count_touch), p(count_close), p(budget),
        W, N, M, V, C, int(partner_aware), dt, 0.1 * margin, 0.5 * margin)
    _build.launch("sf_slots", args, dev)
    build_slot_tables.launches += 1
    return partner, slot_act, count, count_touch, count_close, budget


build_slot_tables.launches = 0


# ---------------------------------------------------------------------------
# K3: joint slots
# ---------------------------------------------------------------------------


def joint_slots_plain(jba, jbb, jactive, n_bodies: int, *, JC: int):
    """Plain PyTorch twin of :func:`build_joint_slots`: the TPU kernel's
    exclusive-rank over the joint axis and one-hot sums per slot."""
    W, J = jba.shape
    n_iota = torch.arange(n_bodies, dtype=i32, device=jba.device)
    live = (jactive > 0)[:, :, None]
    is_a = (jba[:, :, None] == n_iota) & live  # [W, J, N]
    is_b = (jbb[:, :, None] == n_iota) & live
    mask = (is_a | is_b).to(i32)
    rank = torch.cumsum(mask, dim=1, dtype=i32) - mask
    j_iota = torch.arange(J, dtype=i32, device=jba.device)[None, :, None]
    slot, side, act = [], [], []
    for c in range(JC):
        oh = (rank == c) & (mask > 0)
        slot.append((oh.to(i32) * j_iota).sum(dim=1, dtype=i32))
        side.append((oh & is_a).sum(dim=1, dtype=i32).to(f32))
        act.append(oh.sum(dim=1, dtype=i32).to(f32))
    return (torch.stack(slot, 1), torch.stack(side, 1), torch.stack(act, 1),
            mask.sum(dim=1, dtype=i32))


def build_joint_slots(jba, jbb, jactive, n_bodies: int, *, JC: int,
                      plain: bool = False):
    """Per-body joint slot tables for a world batch: body n's first ``JC``
    active joints in joint-index order.

    ``jba``/``jbb`` ``[W, J]`` i32 are the joints' endpoint bodies and
    ``jactive`` ``[W, J]`` f32 their active flags. Returns ``(jslot [W, JC,
    N] i32`` the joint row, ``jside [W, JC, N] f32`` 1 where the body is
    endpoint A, ``jact [W, JC, N] f32``, ``count [W, N] i32)``; empty slots
    are ``0, 0, 0`` and ``count`` is the true number of the body's joints
    (past ``JC`` the joint overflows). ``plain=True`` runs the twin even on
    CUDA tensors (for timing the kernel against it).

    While a profiler records (``spans.recording``), and only then, each
    build, kernel or twin, adds its live slots (each body's joints up to
    ``JC``, from ``count``: the items of K4's joint branch that hold a
    row) to ``build_joint_slots.live_slots`` (a one-element int64 tensor
    on the device, None before the first traced build) and all its ``W x
    JC x N`` slot items to ``build_joint_slots.slot_items`` (an int); an
    untraced build launches nothing for them and reads nothing back."""
    W, J = jba.shape
    N = n_bodies
    dev = jba.device
    for name, t, dtype in (("jba", jba, i32), ("jbb", jbb, i32),
                           ("jactive", jactive, f32)):
        _check(name, t, dtype, (W, J), dev)
    if plain or not _route(dev):
        out = joint_slots_plain(jba, jbb, jactive, N, JC=JC)
    else:
        jslot = torch.empty((W, JC, N), dtype=i32, device=dev)
        jside, jact = (torch.empty((W, JC, N), dtype=f32, device=dev)
                       for _ in range(2))
        count = torch.empty((W, N), dtype=i32, device=dev)
        p = _build.ptr
        args = _build.JointSlotArgs(p(jba), p(jbb), p(jactive), p(jslot),
                                    p(jside), p(jact), p(count), W, N, J, JC)
        _build.launch("sf_joint_slots", args, dev)
        build_joint_slots.launches += 1
        out = (jslot, jside, jact, count)
    if recording():
        _count_live_slots(out[3], JC)
    return out


def _count_live_slots(count, JC: int) -> None:
    """Add a build's live and all slot items to ``build_joint_slots``'s
    counters (the live one kept on ``count``'s device)."""
    live = build_joint_slots.live_slots
    if live is None:
        live = torch.zeros(1, dtype=torch.int64, device=count.device)
    elif live.device != count.device:
        live = live.to(count.device)
    live.add_(torch.clamp(count, max=JC).sum())
    build_joint_slots.live_slots = live
    build_joint_slots.slot_items += count.numel() * JC


build_joint_slots.launches = 0
build_joint_slots.live_slots = None
build_joint_slots.slot_items = 0
