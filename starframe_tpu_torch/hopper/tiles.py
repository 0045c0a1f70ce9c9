"""Sorted-sweep tile engine for one big world: the tile tables, the frame
manifolds, the per-substep project/apply pair and the whole-frame kernel.

Replaces ``starframe_tpu/pallas/tiles.py``'s ``_tables_kernel`` (via
:func:`build_tile_tables`), ``_manifold_kernel`` (:func:`tile_manifold`),
``_ccd_kernel`` (:func:`tile_ccd`), ``_project_kernel``
(:func:`tile_project`), ``_apply_kernel`` (:func:`tile_apply`) and
``_mega_kernel`` (:func:`tile_frame`) with the CUDA kernels of
``csrc/tile_tables.cu``, ``csrc/tile_manifold.cu``, ``csrc/tile_substep.cu``
and ``csrc/tile_frame.cu``, and the compound rows' owner reductions
(``_owner_shift_reduce`` and ``_owner_min3``, XLA code there) with
``csrc/owner_reduce.cu`` (:func:`owner_sum`, :func:`owner_velocity`,
:func:`owner_min`); :func:`run_tiled_frame` composes them into one frame
(``fuse=True``: the substeps in one K10 launch, or for compound rows one
launch of the compound frame, ``csrc/tile_compound_frame.cu``;
``fuse=False``: one project and one apply launch per substep, after one
CCD launch with ``ccd``, with the owner reductions between them on
compound rows).
Each wrapper checks its inputs, launches its kernel for CUDA tensors (and
raises if that fails: there is no fallback) and runs its plain PyTorch twin
for CPU tensors; ``plain=True`` runs the twin on CUDA tensors too, for
timing. ``<wrapper>.launches`` counts kernel launches (K6 with event keys,
the compound forms of K9 and of the whole frame, and the CCD forms of K8,
K9 and the whole frame in ``keys_launches``, ``compound_launches``,
``ccd_launches`` and ``compound_ccd_launches``).

Layout (the TPU's ``[Nt, 1, T]`` Mosaic rows and k-major lane packing are
not kept): rows are colliders sorted along the sort axis and cut into
``Nt`` tiles of ``T`` rows; per-row arrays are ``[Nt, T]``, vertices
``[Nt, V, T]``, per-slot arrays ``[Nt, C, T]``. A tile's candidates are the
``3T`` rows of its clamped 3-tile window (:func:`win_start`) followed by
the ``L`` large-set statics; a slot's partner index ``pidx`` is the
candidate index, ``< 3T`` for a window row and ``>= 3T`` for a large-set
slot. The frame's solve tables ``sol`` are ``[Nt, SOL_FIELDS, Cs, T]``,
one plane per constant (``SOL_KEYS``), so that the per-row threads of the
substep kernels read consecutive addresses.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from ..kernels import (
    PairPose,
    PairVel,
    _div,
    _pair_kinematics,
    manifold_batch,
    solve_contacts_b,
    velocity_contacts_b,
)
from . import _build
from .slots import _check, _route

f32 = torch.float32
i32 = torch.int32

T = 256  # rows per tile
WIN = 3  # window tiles
L = 128  # large-set (static collider) capacity
_BIG = 1e30

# per-slot frame constants of the solve tables (csrc/common.cuh TS_*)
SOL_KEYS = ("act", "nax", "nay", "fric", "rest", "imb", "iib", "pdyn",
            "aax0", "aax1", "aay0", "aay1", "bax0", "bax1", "bay0", "bay1",
            "sm0", "sm1", "pm0", "pm1", "sep0", "sep1")
SOL = {k: n for n, k in enumerate(SOL_KEYS)}
SOL_FIELDS = len(SOL_KEYS)

STATE_KEYS = ("px", "py", "an", "vx", "vy", "om")


def win_start(n_tiles: int, device=None) -> torch.Tensor:
    """First tile of each tile's clamped 3-tile window ``[Nt]`` (long): the
    end tiles see a full window shifted inward."""
    t = torch.arange(n_tiles, device=device)
    return torch.clamp(torch.clamp(t - 1, max=n_tiles - WIN), min=0)


def _cand_index(n_tiles: int, device) -> torch.Tensor:
    """Flat row of each window candidate ``[Nt, 3T]`` (long)."""
    start = win_start(n_tiles, device)
    return start[:, None] * T + torch.arange(WIN * T, device=device)[None]


def _cand(x, xl, idx):
    """Candidate row ``[Nt, S]``: ``x`` ``[Nt, T]`` read through the
    window index, then the large-set row ``xl`` ``[L]``."""
    Nt = x.shape[0]
    return torch.cat([x.reshape(-1)[idx], xl[None].expand(Nt, -1)], dim=1)


def _cand_verts(v, vl, idx):
    """Candidate vertices ``[V, Nt, S]`` of ``[Nt, V, T]`` verts and the
    large set's ``[V, L]``."""
    Nt, V, _ = v.shape
    flat = v.permute(1, 0, 2).reshape(V, -1)
    return torch.cat([flat[:, idx], vl[:, None, :].expand(V, Nt, -1)], dim=2)


def _own(c, n_tiles: int):
    """The own tile's ``T`` lanes of a candidate row ``[..., Nt, S]``: the
    tile sits at window offset ``t - win_start(t)``."""
    dev = c.device
    own = torch.arange(n_tiles, device=dev) - win_start(n_tiles, dev)
    idx = own[:, None] * T + torch.arange(T, device=dev)[None]
    return torch.gather(c, -1, idx.expand(c.shape[:-1] + (T,)))


def _slot_gather(c, pidx):
    """``c [Nt, S]`` read at each slot's partner ``pidx [Nt, K, T]``."""
    Nt, K, Tn = pidx.shape
    return torch.gather(c, 1, pidx.reshape(Nt, K * Tn).long()).reshape(
        Nt, K, Tn)


# ---------------------------------------------------------------------------
# K5: tile tables
# ---------------------------------------------------------------------------


def tile_tables_plain(state, consts, large, edge_lo, edge_hi, gravity, *,
                      C: int, margin: float, dt: float, sort_axis: int,
                      sweep_frames: int, sweep_slack: float,
                      sweep_floor: float, sweep_cap: float):
    """Plain PyTorch twin of :func:`build_tile_tables`: the TPU kernel's
    dense ``[S, T]`` candidate mask per tile and its tiered rank."""
    Nt = state["px"].shape[0]
    dev = state["px"].device
    idx = _cand_index(Nt, dev)
    zl = torch.zeros_like(large["px"])

    def cand(k, lk=None, fill=None):
        return _cand(consts[k] if k in consts else state[k],
                     large[lk or k] if fill is None else fill, idx)

    c_px, c_py, c_an = cand("px"), cand("py"), cand("an")
    c_vx, c_vy = cand("vx", fill=zl), cand("vy", fill=zl)
    c_rad, c_act = cand("rad"), cand("act")
    # window candidates must MOVE (statics ride the large channel only)
    c_part = cand("mov", "act")
    c_lay, c_msk = cand("lay"), cand("msk")
    c_ob = cand("obody", fill=torch.full_like(large["lay"], -1))
    c_vlx = _cand_verts(consts["vlx"], large["vlx"], idx)
    c_vly = _cand_verts(consts["vly"], large["vly"], idx)
    ca, sa = torch.cos(c_an), torch.sin(c_an)
    lox = hix = loy = hiy = ext = None
    for v in range(c_vlx.shape[0]):
        wx = c_px + ca * c_vlx[v] - sa * c_vly[v]
        wy = c_py + sa * c_vlx[v] + ca * c_vly[v]
        lox = wx if lox is None else torch.minimum(lox, wx)
        hix = wx if hix is None else torch.maximum(hix, wx)
        loy = wy if loy is None else torch.minimum(loy, wy)
        hiy = wy if hiy is None else torch.maximum(hiy, wy)
        d = torch.sqrt(c_vlx[v] * c_vlx[v] + c_vly[v] * c_vly[v])
        ext = d if ext is None else torch.maximum(ext, d)
    ext = ext + c_rad
    pad = c_rad + 0.5 * margin
    if sweep_frames > 1:
        # K-frame symmetric speed sweep, capped at sweep_cap extents
        gmag = torch.sqrt(gravity[0] * gravity[0] + gravity[1] * gravity[1])
        spd = torch.sqrt(c_vx * c_vx + c_vy * c_vy)
        sw = torch.minimum(
            (spd + gmag * dt + sweep_slack) * (sweep_frames * dt)
            + sweep_floor * ext, sweep_cap * ext) * (c_part > 0)
        swx = swy = sw
    else:
        swx = torch.abs(c_vx) * dt
        swy = torch.abs(c_vy) * dt
    tpad = c_rad + 0.1 * margin
    touch = (lox - tpad, hix + tpad, loy - tpad, hiy + tpad)
    close = (lox - pad, hix + pad, loy - pad, hiy + pad)
    swept = (close[0] - swx, close[1] + swx, close[2] - swy, close[3] + swy)

    def own(x):
        return _own(x, Nt)

    c_lo, c_hi = (close[0], close[1]) if sort_axis == 0 else (close[2],
                                                              close[3])
    o_lo, o_hi = own(c_lo), own(c_hi)
    avail = torch.minimum(edge_hi[:, None] - o_hi, o_lo - edge_lo[:, None])
    sweep = torch.minimum(own(swx), torch.clamp(avail, min=0.0))

    def overlap(b):  # [Nt, S(j), T(i)]
        lo_x, hi_x, lo_y, hi_y = b
        return ((lo_x[:, :, None] <= own(hi_x)[:, None, :])
                & (own(lo_x)[:, None, :] <= hi_x[:, :, None])
                & (lo_y[:, :, None] <= own(hi_y)[:, None, :])
                & (own(lo_y)[:, None, :] <= hi_y[:, :, None]))

    S = c_px.shape[1]
    gid = torch.arange(S, device=dev)
    own_gid = own(gid[None].expand(Nt, S))
    diff = ((gid[None, :, None] != own_gid[:, None, :])
            & (c_ob[:, :, None] != own(c_ob)[:, None, :]))
    layer_ok = (((own(c_msk)[:, None, :] >> c_lay[:, :, None]) & 1)
                & ((c_msk[:, :, None] >> own(c_lay)[:, None, :]) & 1)) != 0
    row_ok = ((consts["responds"] > 0)
              | ((consts["sen"] > 0) & (own(c_part) > 0)))
    elig = (c_part[:, :, None] > 0) & (c_act[:, :, None] > 0) & row_ok[:, None]
    mask = overlap(swept) & diff & layer_ok & elig
    winover = (((o_lo < edge_lo[:, None]) | (o_hi > edge_hi[:, None])).to(i32)
               * (consts["responds"] > 0).to(i32))

    m_touch = overlap(touch) & mask
    m_close = overlap(close) & mask
    m_mid = m_close & ~m_touch
    m_far = mask & ~m_close

    def excl_rank(m):  # #{j' < j : m[j']} along the candidate axis
        c = torch.cumsum(m.to(i32), dim=1, dtype=i32)
        return c - m.to(i32)

    cnt_t = m_touch.sum(dim=1, keepdim=True, dtype=i32)
    cnt_m = m_mid.sum(dim=1, keepdim=True, dtype=i32)
    crank = torch.where(m_touch, excl_rank(m_touch),
                        torch.where(m_mid, cnt_t + excl_rank(m_mid),
                                    cnt_t + cnt_m + excl_rank(m_far)))
    j_iota = gid.to(i32)[None, :, None]
    parts, acts = [], []
    for c in range(C):
        oh = (crank == c) & mask
        parts.append((oh.to(i32) * j_iota).sum(dim=1, dtype=i32))
        acts.append(oh.sum(dim=1, dtype=i32).to(f32))
    return (torch.stack(parts, 1), torch.stack(acts, 1),
            mask.sum(dim=1, dtype=i32), cnt_t[:, 0],
            m_close.sum(dim=1, dtype=i32), winover, sweep)


def _check_tiles(state, consts, large, keys, dev, V=None):
    """Check the ``[Nt, T]`` state, the named consts and the large set."""
    Nt = state["px"].shape[0]
    ints = ("nv", "lay", "msk", "obody", "sleep")
    checks = [(k, state[k], f32, (Nt, T)) for k in STATE_KEYS]
    for k in keys:
        if k in ("vlx", "vly"):
            checks.append((k, consts[k], f32, (Nt, V, T)))
        else:
            checks.append((k, consts[k], i32 if k in ints else f32, (Nt, T)))
    for k, t in large.items():
        if k in ("vlx", "vly"):
            checks.append((f"large {k}", t, f32, (V, L)))
        elif k != "cols":
            checks.append((f"large {k}", t, i32 if k in ints else f32, (L,)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    return Nt


def build_tile_tables(state, consts, large, edge_lo, edge_hi, gravity, *,
                      C: int, margin: float, dt: float, sort_axis: int = 0,
                      sweep_frames: int = 1, sweep_slack: float = 0.0,
                      sweep_floor: float = 0.25, sweep_cap: float = 1e30,
                      plain: bool = False):
    """Slot tables for the tile layout.

    Per tile: touch, close and swept boxes of the ``S = 3T + L``
    candidates, the eligible overlaps (layers both ways, not the row itself
    or a sibling, moving window candidates or active large-set ones, rows
    that respond or are moving sensors), and each row's first ``C``
    candidates ranked touching < margin-close < swept, by candidate index
    within a tier. Returns ``(pidx [Nt, C, T] i32, act [Nt, C, T] f32,
    count, count_touch, count_close, winover [Nt, T] i32, sweep [Nt, T]
    f32)``: ``sweep`` is each row's position budget, clamped to the room its
    window's sort-axis coverage (``edge_lo``/``edge_hi`` ``[Nt]``) offers;
    ``winover`` flags rows whose margin box already escapes it. With
    ``sweep_frames = K > 1`` the sweep is the K-frame symmetric speed
    budget ``min((|v| + |g| dt + slack) K dt + floor ext, cap ext)``.
    Fewer than 3 tiles (``WIN``, the window) raise ``ValueError``."""
    dev = state["px"].device
    V = consts["vlx"].shape[1]
    Nt = _check_tiles(state, consts, large,
                      ("rad", "act", "mov", "lay", "msk", "obody", "responds",
                       "sen", "vlx", "vly"), dev, V)
    if Nt < WIN:  # the JAX package's tile layout refuses them too
        raise ValueError(f"tile tables need >= {WIN} tiles (a window of "
                         f"{WIN}), got {Nt}")
    for name, t, shape in (("edge_lo", edge_lo, (Nt,)),
                           ("edge_hi", edge_hi, (Nt,)),
                           ("gravity", gravity, (2,))):
        _check(name, t, f32, shape, dev)
    kw = dict(C=C, margin=margin, dt=dt, sort_axis=sort_axis,
              sweep_frames=sweep_frames, sweep_slack=sweep_slack,
              sweep_floor=sweep_floor, sweep_cap=sweep_cap)
    if plain or not _route(dev):
        return tile_tables_plain(state, consts, large, edge_lo, edge_hi,
                                 gravity, **kw)
    pidx = torch.empty((Nt, C, T), dtype=i32, device=dev)
    act = torch.empty((Nt, C, T), dtype=f32, device=dev)
    count, count_touch, count_close, winover = (
        torch.empty((Nt, T), dtype=i32, device=dev) for _ in range(4))
    sweep = torch.empty((Nt, T), dtype=f32, device=dev)
    p = _build.ptr
    s, c, lg = state, consts, large
    args = _build.TileTablesArgs(
        *(p(x) for x in (s["px"], s["py"], s["an"], s["vx"], s["vy"],
                         c["vlx"], c["vly"], c["rad"], c["act"], c["mov"],
                         c["lay"], c["msk"], c["obody"], c["responds"],
                         c["sen"], lg["px"], lg["py"], lg["an"], lg["vlx"],
                         lg["vly"], lg["rad"], lg["act"], lg["lay"],
                         lg["msk"], edge_lo, edge_hi, gravity, pidx, act,
                         count, count_touch, count_close, winover, sweep)),
        Nt, V, C, sort_axis, sweep_frames,
        dt, sweep_frames * dt, 0.1 * margin, 0.5 * margin, sweep_slack,
        sweep_floor, sweep_cap)
    _build.launch("sf_tile_tables", args, dev)
    build_tile_tables.launches += 1
    return pidx, act, count, count_touch, count_close, winover, sweep


build_tile_tables.launches = 0


# ---------------------------------------------------------------------------
# K6: frame manifolds + solve-slot compaction
# ---------------------------------------------------------------------------


def _speed_rows(state, consts, large, idx):
    """Candidate rows of the speed bounds: ``spd`` (linear speed plus
    ``|omega| * extent``, for the speculative margin) and ``spd2`` (squared
    speed, the wake signal). Large-set candidates do not move."""
    zl = torch.zeros_like(large["px"])
    c_vx = _cand(state["vx"], zl, idx)
    c_vy = _cand(state["vy"], zl, idx)
    c_om = _cand(state["om"], zl, idx)
    c_vlx = _cand_verts(consts["vlx"], large["vlx"], idx)
    c_vly = _cand_verts(consts["vly"], large["vly"], idx)
    ext = None
    for v in range(c_vlx.shape[0]):
        d = torch.sqrt(c_vlx[v] * c_vlx[v] + c_vly[v] * c_vly[v])
        ext = d if ext is None else torch.maximum(ext, d)
    ext = ext + _cand(consts["rad"], large["rad"], idx)
    spd = torch.sqrt(c_vx * c_vx + c_vy * c_vy) + torch.abs(c_om) * ext
    spd2 = c_vx * c_vx + c_vy * c_vy + c_om * c_om
    return spd, spd2, c_vlx, c_vly


def check_event_keys(n_colliders: int) -> None:
    """Refuse a world whose contact-event keys ``min * n_colliders + max``
    would not fit int32 (past 46,340 colliders). The JAX package's keys
    wrap silently there (ROADMAP.md C)."""
    if n_colliders * n_colliders > 2 ** 31:
        raise ValueError(
            f"contact-event keys of {n_colliders} colliders overflow int32 "
            f"(at most 46340 colliders)")


def _slot_keys(cid, lcid, pidx, idx, n_colliders: int):
    """Each table slot's pair key ``min * n_colliders + max`` of the row's
    and its partner's canonical collider ids ``[Nt, C, T]`` i32 (int32
    products, wrapping as the kernel's do)."""
    c_cid = _cand(cid, lcid, idx)
    own = _own(c_cid, pidx.shape[0])[:, None, :]
    par = _slot_gather(c_cid, pidx)
    return torch.minimum(own, par) * n_colliders + torch.maximum(own, par)


def tile_manifold_plain(state, consts, large, pidx, act, tile_live, *,
                        Cs: int, margin: float, dt: float,
                        sleep_velocity: float, kin_velocity: float = 0.0,
                        event_ids=None, n_colliders: int = 0):
    """Plain PyTorch twin of :func:`tile_manifold`."""
    Nt, C, _ = pidx.shape
    dev = pidx.device
    idx = _cand_index(Nt, dev)
    zl = torch.zeros_like(large["px"])
    c_px = _cand(state["px"], large["px"], idx)
    c_py = _cand(state["py"], large["py"], idx)
    c_an = _cand(state["an"], large["an"], idx)
    c_ca, c_sa = torch.cos(c_an), torch.sin(c_an)
    spd, spd2, c_vlx, c_vly = _speed_rows(state, consts, large, idx)
    V = c_vlx.shape[0]

    def g(c):  # candidate row -> per slot [Nt, C, T]
        return _slot_gather(c, pidx)

    def o(c):  # candidate row -> own row [Nt, 1, T]
        return _own(c, Nt)[:, None, :]

    o_px, o_py, o_ca, o_sa = o(c_px), o(c_py), o(c_ca), o(c_sa)
    p_px, p_py, p_ca, p_sa = g(c_px), g(c_py), g(c_ca), g(c_sa)
    shape = pidx.shape
    own_wx, own_wy, par_wx, par_wy = [], [], [], []
    for v in range(V):
        ovx, ovy = o(c_vlx[v]), o(c_vly[v])
        own_wx.append((o_px + o_ca * ovx - o_sa * ovy).expand(shape))
        own_wy.append((o_py + o_sa * ovx + o_ca * ovy).expand(shape))
        pvx, pvy = g(c_vlx[v]), g(c_vly[v])
        par_wx.append(p_px + p_ca * pvx - p_sa * pvy)
        par_wy.append(p_py + p_sa * pvx + p_ca * pvy)
    c_nv = _cand(consts["nv"], large["nv"], idx)
    c_rad = _cand(consts["rad"], large["rad"], idx)
    margin_eff = margin + dt * (o(spd) + g(spd))
    m = manifold_batch(torch.stack(own_wx), torch.stack(own_wy),
                       o(c_nv).expand(shape), o(c_rad).expand(shape),
                       torch.stack(par_wx), torch.stack(par_wy), g(c_nv),
                       g(c_rad), margin_eff)
    dxa, dya = m.wa_x - o_px, m.wa_y - o_py
    dxb, dyb = m.wb_x - p_px, m.wb_y - p_py
    a_ax = o_ca * dxa + o_sa * dya
    a_ay = -o_sa * dxa + o_ca * dya
    b_ax = p_ca * dxb + p_sa * dyb
    b_ay = -p_sa * dxb + p_ca * dyb
    pmask = m.pmask * act
    act_m = torch.maximum(pmask[0], pmask[1]) > 0.0
    minsep = torch.where(pmask > 0.0, m.sep, _BIG).amin(dim=0)
    hard = minsep < margin
    c_sen = _cand(consts["sen"], large["sen"], idx)
    solvable = act * (1.0 - torch.maximum(o(c_sen), g(c_sen)))
    p_invm = g(_cand(consts["invm"], zl, idx))
    c_fric = _cand(consts["fric"], large["fric"], idx)
    c_rst = _cand(consts["rst"], large["rst"], idx)
    sm = pmask * solvable
    fields = dict(
        act=act, nax=o_ca * m.n_x + o_sa * m.n_y,
        nay=-o_sa * m.n_x + o_ca * m.n_y,
        fric=torch.sqrt(o(c_fric) * g(c_fric)),
        rest=torch.maximum(o(c_rst), g(c_rst)),
        imb=p_invm, iib=g(_cand(consts["invi"], zl, idx)),
        pdyn=(p_invm > 0).to(f32),
        aax0=a_ax[0], aax1=a_ax[1], aay0=a_ay[0], aay1=a_ay[1],
        bax0=b_ax[0], bax1=b_ax[1], bay0=b_ay[0], bay1=b_ay[1],
        sm0=sm[0], sm1=sm[1], pm0=pmask[0], pm1=pmask[1],
        sep0=m.sep[0], sep1=m.sep[1])
    table = torch.stack([fields[k] for k in SOL_KEYS], dim=1)  # [Nt, F, C, T]

    pen = torch.clamp((torch.clamp(-m.sep, min=0.0) * pmask).amax(dim=(0, 2)),
                      min=0.0)
    # undirected manifold points: a window (dynamic) pair appears in both
    # rows (weight 0.5), a large-set partner in this row only
    pt_w = torch.where(pidx < WIN * T, 0.5, 1.0)
    pts = (pmask[0] + pmask[1]) * pt_w
    npts = pts[:, 0]
    for c in range(1, C):
        npts = npts + pts[:, c]
    if sleep_velocity > 0.0:
        # wake on a fast dynamic partner inside the speculative margin, or
        # on a kinematic one moving at kin_velocity or faster (the large
        # set holds statics only)
        prox = torch.maximum(pmask[0], pmask[1])
        p_spd2 = g(spd2)
        p_kin = g(_cand(consts["kin"], zl, idx))
        fast = (((p_spd2 >= sleep_velocity * sleep_velocity) & (p_invm > 0))
                | ((p_spd2 >= kin_velocity * kin_velocity)
                   & (p_kin > 0))).to(f32)
        wake = torch.clamp((prox * fast).amax(dim=1), min=0.0)
    else:
        wake = torch.zeros_like(npts)
    nact = torch.stack([act_m.sum(dim=1, dtype=i32),
                        hard.sum(dim=1, dtype=i32)], dim=1)
    keys = (None if event_ids is None
            else _slot_keys(*event_ids, pidx, idx, n_colliders))
    keyc = keys
    if Cs >= C:  # no compaction: solve slots are the table slots
        sol, pidx_c = table, pidx
        src = torch.arange(C, dtype=i32, device=dev)[None, :, None].expand(
            Nt, C, T)
    else:
        # rank the active slots by live min separation (closest first, ties
        # to the lower slot) and keep the first Cs
        key = torch.where(act_m, minsep, _BIG)
        kk = torch.arange(C, device=dev)
        before = ((key[:, :, None] < key[:, None, :])
                  | ((key[:, :, None] == key[:, None, :])
                     & (kk[:, None] < kk[None, :])[None, :, :, None]))
        rank = before.sum(dim=1)  # [Nt, C(j), T]
        cs = torch.arange(Cs, device=dev)[None, :, None, None]
        hit = (rank[:, None] == cs) & act_m[:, None]  # [Nt, Cs, C, T]
        found = hit.any(dim=2)
        src = torch.where(found, (hit.to(i32) * kk.to(i32)[:, None]).sum(
            dim=2, dtype=i32), 0)
        sol = torch.where(found[:, None], torch.gather(
            table, 2, src.long()[:, None].expand(Nt, SOL_FIELDS, Cs, T)), 0.0)
        pidx_c = torch.where(found, torch.gather(pidx, 1, src.long()), 0)
        if keys is not None:
            keyc = torch.where(found, torch.gather(keys, 1, src.long()), 0)
    live = tile_live > 0

    def gate(x):  # skipped tiles (whole window asleep): zero outputs
        return torch.where(live.view((-1,) + (1,) * (x.dim() - 1)), x,
                           torch.zeros((), dtype=x.dtype, device=dev))

    out = (gate(sol).contiguous(), gate(pidx_c).contiguous(),
           gate(src).contiguous(), gate(nact), gate(wake), gate(pen),
           gate(npts))
    return out if keys is None else out + (gate(keyc).contiguous(),)


@functools.cache
def _check_solve_fields() -> None:
    """The kernels' solve-table layout against ``SOL_KEYS``, once a
    process."""
    if _build.library().sf_tile_solve_fields() != SOL_FIELDS:
        raise RuntimeError("tile kernels' solve-table layout differs from "
                           "SOL_KEYS")


def tile_manifold(state, consts, large, pidx, act, tile_live, *, Cs: int,
                  margin: float, dt: float, sleep_velocity: float = 0.0,
                  kin_velocity: float = 0.0, event_ids=None,
                  n_colliders: int = 0, plain: bool = False):
    """The frame's manifolds for the ``C``-slot tables, compacted into
    ``Cs`` solve slots.

    Per row and table slot: the manifold at the frame-start pose with a
    margin expanded by both bodies' speed bounds, body-local anchors and
    normal, pair friction/restitution and partner mass (the ``sol``
    constants). Manifolds are frame-frozen, so a slot with no point inside
    the margin is an exact zero in every substep; the active slots are
    ranked by live min separation (ties to the lower slot) and the first
    ``Cs`` fill the solve slots (``Cs >= C``: no compaction). Returns
    ``(sol [Nt, SOL_FIELDS, Cs, T] f32, pidx_c [Nt, Cs, T] i32, src [Nt,
    Cs, T] i32 (the table slot of each solve slot), nact [Nt, 2, T] i32
    (active and imminent slots per row), wake, pen, npts [Nt, T] f32)``.
    ``sleep_velocity > 0`` computes ``wake``: a dynamic partner at
    ``sleep_velocity`` or faster inside the margin, or a kinematic one
    (``consts["kin"]``) at ``kin_velocity`` or faster (a rule the JAX
    package lacks: its kinematic movers never wake a sleeper, ROADMAP.md
    C); a tile whose ``tile_live [Nt]`` is 0 outputs zeros.

    ``event_ids = (cid [Nt, T], lcid [L])`` (i32: each row's and each
    large slot's canonical collider id) adds an eighth output, ``keyc [Nt,
    Cs, T]`` i32: each solve slot's contact-event key ``min(own, partner) *
    n_colliders + max(...)``, selected with the slot (the raw key of every
    table slot when ``Cs >= C``; 0 in a solve slot nothing fills and in a
    skipped tile)."""
    dev = pidx.device
    V = consts["vlx"].shape[1]
    Nt = _check_tiles(state, consts, large,
                      ("rad", "nv", "fric", "rst", "sen", "invm", "invi",
                       "kin", "vlx", "vly"), dev, V)
    C = pidx.shape[1]
    _check("pidx", pidx, i32, (Nt, C, T), dev)
    _check("act", act, f32, (Nt, C, T), dev)
    _check("tile_live", tile_live, f32, (Nt,), dev)
    Cs = min(Cs, C)
    if event_ids is not None:
        check_event_keys(n_colliders)
        _check("cid", event_ids[0], i32, (Nt, T), dev)
        _check("lcid", event_ids[1], i32, (L,), dev)
    kw = dict(Cs=Cs, margin=margin, dt=dt, sleep_velocity=sleep_velocity,
              kin_velocity=kin_velocity, event_ids=event_ids,
              n_colliders=n_colliders)
    if plain or not _route(dev):
        return tile_manifold_plain(state, consts, large, pidx, act,
                                   tile_live, **kw)
    if not _build.library().sf_tile_manifold_width(V):
        raise ValueError(f"tile manifold kernel supports up to 8 vertices "
                         f"per collider, got {V}")
    _check_solve_fields()
    # the kernel reads the V planes as they are and pads to its compiled
    # width in registers, with copies of v0
    vlx, vly, lvx, lvy = consts["vlx"], consts["vly"], large["vlx"], large["vly"]
    sol = torch.empty((Nt, SOL_FIELDS, Cs, T), dtype=f32, device=dev)
    pidx_c, src = (torch.empty((Nt, Cs, T), dtype=i32, device=dev)
                   for _ in range(2))
    nact = torch.empty((Nt, 2, T), dtype=i32, device=dev)
    wake, pen, npts = (torch.empty((Nt, T), dtype=f32, device=dev)
                       for _ in range(3))
    p = _build.ptr
    s, c, lg = state, consts, large
    if event_ids is None:
        keyc, ev = None, (None, None, None)
    else:
        keyc = torch.empty((Nt, Cs, T), dtype=i32, device=dev)
        ev = (p(event_ids[0]), p(event_ids[1]), p(keyc))
    args = _build.TileManifoldArgs(
        *(p(x) for x in (s["px"], s["py"], s["an"], s["vx"], s["vy"],
                         s["om"], vlx, vly, c["rad"], c["nv"], c["fric"],
                         c["rst"], c["sen"], c["invm"], c["invi"], lg["px"],
                         lg["py"], lg["an"], lvx, lvy, lg["rad"], lg["nv"],
                         lg["fric"], lg["rst"], lg["sen"], pidx, act,
                         tile_live, sol, pidx_c, src, nact, wake, pen,
                         npts)), *ev, p(c["kin"]),
        Nt, V, C, Cs, margin, dt, sleep_velocity * sleep_velocity,
        int(sleep_velocity > 0.0), n_colliders, kin_velocity * kin_velocity)
    _build.launch("sf_tile_manifold", args, dev)
    out = (sol, pidx_c, src, nact, wake, pen, npts)
    if keyc is None:
        tile_manifold.launches += 1
        return out
    tile_manifold.keys_launches += 1
    return out + (keyc,)


tile_manifold.launches = 0
tile_manifold.keys_launches = 0  # launches with event keys, counted apart


# ---------------------------------------------------------------------------
# K7: the per-substep TOI factors of bullet rows (CCD)
# ---------------------------------------------------------------------------


def tile_ccd_plain(state, consts, large, pidx_c, sol, gravity, tile_live, *,
                   h: float, ccd_slop: float):
    """Plain PyTorch twin of :func:`tile_ccd`."""
    Nt, Cs, _ = pidx_c.shape
    idx = _cand_index(Nt, pidx_c.device)
    zl = torch.zeros_like(large["px"])
    gx, gy = gravity[0], gravity[1]

    def g(x, xl):
        return _slot_gather(_cand(x, xl, idx), pidx_c)

    dyn = consts["dynb"]
    o_px, o_py, o_an = state["px"], state["py"], state["an"]
    # the unclamped integrated own and partner poses
    opx_t = o_px + (state["vx"] + gx * h * dyn) * h
    opy_t = o_py + (state["vy"] + gy * h * dyn) * h
    oa_t = o_an + state["om"] * h
    _, cb, p_dyn = _solve_slots(sol, consts["invm"][:, None],
                                consts["invi"][:, None])
    p_px0, p_py0 = g(state["px"], large["px"]), g(state["py"], large["py"])
    p_an0 = g(state["an"], large["an"])
    p_px_t = p_px0 + (g(state["vx"], zl) + gx * h * p_dyn) * h
    p_py_t = p_py0 + (g(state["vy"], zl) + gy * h * p_dyn) * h
    p_an_t = p_an0 + g(state["om"], zl) * h
    shape = pidx_c.shape

    def own(x):
        return x[:, None].expand(shape)

    pose0 = PairPose(own(o_px), own(o_py), own(torch.cos(o_an)),
                     own(torch.sin(o_an)), p_px0, p_py0, torch.cos(p_an0),
                     torch.sin(p_an0))
    pose1 = PairPose(own(opx_t), own(opy_t), own(torch.cos(oa_t)),
                     own(torch.sin(oa_t)), p_px_t, p_py_t, torch.cos(p_an_t),
                     torch.sin(p_an_t))
    nx0, ny0, *_, wax0, way0, wbx0, wby0 = _pair_kinematics(cb, pose0)
    *_, wax1, way1, wbx1, wby1 = _pair_kinematics(cb, pose1)
    c0 = (wbx0 - wax0) * nx0[None] + (wby0 - way0) * ny0[None]  # [2, ...]
    c1 = (wbx1 - wax1) * nx0[None] + (wby1 - way1) * ny0[None]
    advance = c0 - c1
    allowed = torch.clamp(c0, min=0.0) + ccd_slop
    need = (advance > allowed) & (cb.solve_mask > 0.0)
    f_pt = torch.where(need, allowed / torch.clamp(advance, min=1e-10), 1.0)
    f = f_pt.amin(dim=(0, 2))
    return torch.where((tile_live > 0)[:, None] & (consts["blt"] > 0), f,
                       1.0).contiguous()


def tile_ccd(state, consts, large, pidx_c, sol, gravity, tile_live, *,
             h: float, ccd_slop: float, plain: bool = False):
    """Each row's TOI factor ``f [Nt, T]`` in ``[0, 1]`` for one substep
    (CCD, ``cfg.ccd``): the own and partner poses are integrated one
    substep without clamping (large-set partners do not move); for each
    solved point of a row's solve slots, the pair's closing along the
    frame-start normal is ``c0 - c1``, the anchors' separation at the
    substep's start and end poses; where it is more than ``max(c0, 0) +
    ccd_slop``, the point allows the fraction ``(max(c0, 0) + ccd_slop) /
    closing``. ``f`` is the least over the row's points, 1 on a row whose
    body is not a bullet (``consts["blt"]``) and in a skipped tile. The
    project and apply phases take it as their ``f``."""
    dev = pidx_c.device
    Nt = _check_tiles(state, consts, {}, ("invm", "invi", "dynb", "blt"),
                      dev)
    Cs = pidx_c.shape[1]
    for name, t, dtype, shape in (
            ("large px", large["px"], f32, (L,)),
            ("large py", large["py"], f32, (L,)),
            ("large an", large["an"], f32, (L,)),
            ("pidx_c", pidx_c, i32, (Nt, Cs, T)),
            ("sol", sol, f32, (Nt, SOL_FIELDS, Cs, T)),
            ("gravity", gravity, f32, (2,)),
            ("tile_live", tile_live, f32, (Nt,))):
        _check(name, t, dtype, shape, dev)
    if plain or not _route(dev):
        return tile_ccd_plain(state, consts, large, pidx_c, sol, gravity,
                              tile_live, h=h, ccd_slop=ccd_slop)
    f = torch.empty((Nt, T), dtype=f32, device=dev)
    args = _ccd_args(state, consts, large, pidx_c, sol, gravity, tile_live,
                     f, h, ccd_slop)
    _build.launch("sf_tile_ccd", args, dev)
    tile_ccd.launches += 1
    return f


tile_ccd.launches = 0


def _ccd_args(state, consts, large, pidx_c, sol, gravity, tile_live, f, h,
              ccd_slop):
    p = _build.ptr
    return _build.TileCcdArgs(
        *(p(state[k]) for k in STATE_KEYS), p(consts["dynb"]),
        p(consts["blt"]), *(p(large[k]) for k in ("px", "py", "an")),
        p(pidx_c), p(sol), p(gravity), p(tile_live), p(f),
        pidx_c.shape[0], pidx_c.shape[1], h, ccd_slop)


# ---------------------------------------------------------------------------
# K8 / K9: the per-substep project/apply pair
# ---------------------------------------------------------------------------


def _solve_slots(sol, o_invm, o_invi):
    """The contact math's pair constants (``pd``) and body-local geometry
    (``cb``) of the solve tables."""
    f = {k: sol[:, n] for n, k in enumerate(SOL_KEYS)}
    shape = f["nax"].shape
    pd = SimpleNamespace(friction=f["fric"], restitution=f["rest"],
                         inv_mass_a=o_invm.expand(shape),
                         inv_mass_b=f["imb"],
                         inv_inertia_a=o_invi.expand(shape),
                         inv_inertia_b=f["iib"])
    cb = SimpleNamespace(
        n_ax=f["nax"], n_ay=f["nay"],
        a_ax=torch.stack([f["aax0"], f["aax1"]]),
        a_ay=torch.stack([f["aay0"], f["aay1"]]),
        b_ax=torch.stack([f["bax0"], f["bax1"]]),
        b_ay=torch.stack([f["bay0"], f["bay1"]]),
        solve_mask=torch.stack([f["sm0"], f["sm1"]]),
        pmask=torch.stack([f["pm0"], f["pm1"]]),
        sep=torch.stack([f["sep0"], f["sep1"]]))
    return pd, cb, f["pdyn"]


def _slot_sum(x):
    """``[..., K, T]`` -> ``[..., T]``, adding the slots in order."""
    acc = x[..., 0, :]
    for c in range(1, x.shape[-2]):
        acc = acc + x[..., c, :]
    return acc


def _live_rows(tile_live, x):
    return (tile_live > 0).view((-1,) + (1,) * (x.dim() - 1))


def tile_project_plain(state, consts, large, pidx_c, sol, gravity, touched,
                       tile_live, *, h: float, compliance: float, f=None):
    """Plain PyTorch twin of :func:`tile_project`."""
    Nt, Cs, _ = pidx_c.shape
    idx = _cand_index(Nt, pidx_c.device)
    zl = torch.zeros_like(large["px"])
    gx, gy = gravity[0], gravity[1]

    def g(x, xl):
        return _slot_gather(_cand(x, xl, idx), pidx_c)

    o = {k: state[k][:, None] for k in STATE_KEYS}
    dyn = consts["dynb"][:, None]
    # integrated own state (v_tilde + pose), derived algebraically
    ovx_t = o["vx"] + gx * h * dyn
    ovy_t = o["vy"] + gy * h * dyn
    # CCD clamps the pose advance by f, not the velocities; without it the
    # factor is an exact 1
    o_f = 1.0 if f is None else f[:, None]
    opx_t = o["px"] + ovx_t * h * o_f
    opy_t = o["py"] + ovy_t * h * o_f
    oa_t = o["an"] + o["om"] * h * o_f
    pd, cb, p_dyn = _solve_slots(sol, consts["invm"][:, None],
                                 consts["invi"][:, None])
    p_px0, p_py0 = g(state["px"], large["px"]), g(state["py"], large["py"])
    p_an0 = g(state["an"], large["an"])
    p_vx0, p_vy0 = g(state["vx"], zl), g(state["vy"], zl)
    p_om0 = g(state["om"], zl)
    shape = pidx_c.shape

    def own(x):
        return x.expand(shape)

    pose0 = PairPose(own(o["px"]), own(o["py"]), own(torch.cos(o["an"])),
                     own(torch.sin(o["an"])), p_px0, p_py0, torch.cos(p_an0),
                     torch.sin(p_an0))
    pvx_t = p_vx0 + gx * h * p_dyn
    pvy_t = p_vy0 + gy * h * p_dyn
    # a large-set partner's factor is 1
    p_f = 1.0 if f is None else g(f, torch.ones_like(large["px"]))
    p_an_t = p_an0 + p_om0 * h * p_f
    pose = PairPose(own(opx_t), own(opy_t), own(torch.cos(oa_t)),
                    own(torch.sin(oa_t)), p_px0 + pvx_t * h * p_f,
                    p_py0 + pvy_t * h * p_f, torch.cos(p_an_t),
                    torch.sin(p_an_t))
    vals_a, _, lam = solve_contacts_b(pose, pose0, pd, cb, h, compliance)
    acc = _slot_sum(vals_a)  # [4, Nt, T]
    touch_new = ((lam > 0.0).to(f32) * cb.pmask).amax(dim=0)
    live = _live_rows(tile_live, touched)
    dxx, dxy, dth, cnt = (torch.where(live[:, :, 0], acc[q], 0.0)
                          for q in range(4))
    lam = torch.where(live[:, None], lam.permute(1, 0, 2, 3), 0.0)
    touched = torch.where(live, torch.maximum(touched, touch_new), touched)
    return dxx, dxy, dth, cnt, lam.contiguous(), touched


def tile_project(state, consts, large, pidx_c, sol, gravity, touched,
                 tile_live, *, h: float, compliance: float, f=None,
                 plain: bool = False):
    """One substep's project phase: integrate (derived: the state is not
    written), then XPBD contact projection over each row's solve slots
    against its partners' integrated poses, the static-friction reference
    at the substep-start pose. Returns the own-row Jacobi sums ``(dxx, dxy,
    dth, cnt [Nt, T], lam [Nt, 2, Cs, T], touched [Nt, Cs, T])``, the slots
    added in order and ``touched`` max-accumulated. ``f [Nt, T]`` (CCD,
    :func:`tile_ccd`) scales the own and each window partner's pose advance
    (the ``ccd`` branch, counted in ``ccd_launches``)."""
    dev = pidx_c.device
    Nt = _check_tiles(state, consts, {}, ("invm", "invi", "dynb"), dev)
    Cs = pidx_c.shape[1]
    for name, t, dtype, shape in (
            ("large px", large["px"], f32, (L,)),
            ("large py", large["py"], f32, (L,)),
            ("large an", large["an"], f32, (L,)),
            ("pidx_c", pidx_c, i32, (Nt, Cs, T)),
            ("sol", sol, f32, (Nt, SOL_FIELDS, Cs, T)),
            ("gravity", gravity, f32, (2,)),
            ("touched", touched, f32, (Nt, Cs, T)),
            ("tile_live", tile_live, f32, (Nt,))):
        _check(name, t, dtype, shape, dev)
    if f is not None:
        _check("f", f, f32, (Nt, T), dev)
    if plain or not _route(dev):
        return tile_project_plain(state, consts, large, pidx_c, sol, gravity,
                                  touched, tile_live, h=h,
                                  compliance=compliance, f=f)
    dxx, dxy, dth, cnt = (torch.empty((Nt, T), dtype=f32, device=dev)
                          for _ in range(4))
    lam = torch.empty((Nt, 2, Cs, T), dtype=f32, device=dev)
    touched_o = torch.empty((Nt, Cs, T), dtype=f32, device=dev)
    p = _build.ptr
    s, c = state, consts
    args = _build.TileProjectArgs(
        *(p(x) for x in (s["px"], s["py"], s["an"], s["vx"], s["vy"],
                         s["om"], c["invm"], c["invi"], c["dynb"],
                         large["px"], large["py"], large["an"], pidx_c, sol,
                         gravity, touched, tile_live, dxx, dxy, dth, cnt,
                         lam, touched_o)), None if f is None else p(f),
        Nt, Cs, h, compliance / (h * h))
    _build.launch("sf_tile_project", args, dev)
    if f is None:
        tile_project.launches += 1
    else:
        tile_project.ccd_launches += 1
    return dxx, dxy, dth, cnt, lam, touched_o


tile_project.launches = 0
tile_project.ccd_launches = 0  # the ccd instance's, counted apart


def tile_apply_plain(state, corr, consts, large, pidx_c, sol, lam, gravity,
                     tile_live, *, h: float, relaxation: float,
                     max_dpos: float, rest_threshold: float,
                     lin_damp: float, ang_damp: float,
                     compound: bool = False, f=None):
    """Plain PyTorch twin of :func:`tile_apply`."""
    Nt, Cs, _ = pidx_c.shape
    idx = _cand_index(Nt, pidx_c.device)
    zl = torch.zeros_like(large["px"])
    gx, gy = gravity[0], gravity[1]
    dxx, dxy, dth, cnt = corr
    # applied (count-normalised, clipped) corrections of every row, derived
    # the way the row's own tile applies them: the partners' post-apply
    # state without communication between tiles
    scale = (torch.full((), relaxation, dtype=f32, device=cnt.device)
             / torch.clamp(cnt, min=1.0))
    ddx = torch.clamp(dxx * scale, -max_dpos, max_dpos)
    ddy = torch.clamp(dxy * scale, -max_dpos, max_dpos)
    dda = torch.clamp(dth * scale, -max_dpos, max_dpos)

    def g(x, xl):
        return _slot_gather(_cand(x, xl, idx), pidx_c)

    dyn, kin = consts["dynb"], consts["kin"]
    ovx_t = state["vx"] + gx * h * dyn
    ovy_t = state["vy"] + gy * h * dyn
    o_om = state["om"]
    # CCD clamps the pose advance by f, not the velocities; without it the
    # factor is an exact 1
    o_f = 1.0 if f is None else f
    npx = state["px"] + ovx_t * h * o_f + ddx
    npy = state["py"] + ovy_t * h * o_f + ddy
    nan_ = state["an"] + o_om * h * o_f + dda
    nk = 1.0 - kin
    nvx = kin * ovx_t + nk * (ovx_t + _div(ddx, h))
    nvy = kin * ovy_t + nk * (ovy_t + _div(ddy, h))
    nom = kin * o_om + nk * (o_om + _div(dda, h))

    pd, cb, p_dyn = _solve_slots(sol, consts["invm"][:, None],
                                 consts["invi"][:, None])
    pvx_t = g(state["vx"], zl) + gx * h * p_dyn
    pvy_t = g(state["vy"], zl) + gy * h * p_dyn
    p_om0 = g(state["om"], zl)
    p_ddx, p_ddy, p_dda = g(ddx, zl), g(ddy, zl), g(dda, zl)
    p_f = 1.0 if f is None else g(f, torch.ones_like(large["px"]))
    p_px_n = g(state["px"], large["px"]) + pvx_t * h * p_f + p_ddx
    p_py_n = g(state["py"], large["py"]) + pvy_t * h * p_f + p_ddy
    p_an_n = g(state["an"], large["an"]) + p_om0 * h * p_f + p_dda
    shape = pidx_c.shape

    def own(x):
        return x[:, None].expand(shape)

    pose_v = PairPose(own(npx), own(npy), own(torch.cos(nan_)),
                      own(torch.sin(nan_)), p_px_n, p_py_n,
                      torch.cos(p_an_n), torch.sin(p_an_n))
    # partner velocity reconstruction mirrors the partner's own apply
    pvel = PairVel(own(nvx), own(nvy), own(nom), pvx_t + _div(p_ddx, h),
                   pvy_t + _div(p_ddy, h), p_om0 + _div(p_dda, h))
    pvel0 = PairVel(own(ovx_t), own(ovy_t), own(o_om), pvx_t, pvy_t, p_om0)
    # h as a device scalar, so that the friction bound's division by it is
    # a true division on the card too (see kernels._div)
    h_t = torch.full((), h, dtype=npx.dtype, device=npx.device)
    cv_a, _ = velocity_contacts_b(pose_v, pvel, pvel0, pd, cb,
                                  lam.permute(1, 0, 2, 3), h_t, rest_threshold)
    accv = _slot_sum(cv_a)  # [4, Nt, T]
    live = _live_rows(tile_live, npx)
    if compound:
        # the raw sums: a compound body normalises by its rows' summed count
        accv = torch.where(live[None], accv, 0.0).contiguous()
    else:
        nvx, nvy, nom = _velocity_update(nvx, nvy, nom, accv, h=h,
                                         lin_damp=lin_damp,
                                         ang_damp=ang_damp)
    # skipped tiles pass their state through (their bodies are frozen)
    out = {k: torch.where(live, v, state[k]) for k, v in zip(
        STATE_KEYS, (npx, npy, nan_, nvx, nvy, nom))}
    return (out, accv) if compound else out


def _velocity_update(nvx, nvy, nom, accv, *, h: float, lin_damp: float,
                     ang_damp: float):
    """The velocity pass's sums ``accv [4, ...]`` normalised by their count
    and added, then damping."""
    cntv = torch.clamp(accv[3], min=1.0)
    nvx = nvx + accv[0] / cntv
    nvy = nvy + accv[1] / cntv
    nom = nom + accv[2] / cntv
    if lin_damp > 0.0:
        sd = 1.0 / (1.0 + h * lin_damp)
        nvx = nvx * sd
        nvy = nvy * sd
    if ang_damp > 0.0:
        nom = nom * (1.0 / (1.0 + h * ang_damp))
    return nvx, nvy, nom


def tile_apply(state, corr, consts, large, pidx_c, sol, lam, gravity,
               tile_live, *, h: float, relaxation: float, max_dpos: float,
               rest_threshold: float, lin_damp: float, ang_damp: float,
               compound: bool = False, f=None, plain: bool = False):
    """One substep's apply phase: the count-normalised, clipped corrections
    ``corr = (dxx, dxy, dth, cnt)`` of :func:`tile_project` on the
    integrated pose, velocity reconstruction (kinematic rows keep their
    velocity), then the restitution/friction velocity pass against each
    partner's post-apply state derived from the correction windows, and
    damping. Returns the new state dict (``[Nt, T]`` each).

    ``compound=True`` (``_apply_kernel(compound=True)``, for rows of
    multi-collider bodies whose ``corr`` are already owner sums) returns
    ``(state, accv [4, Nt, T])``: the state before the velocity pass is
    added, and the pass's raw sums (x, y, angular, count; 0 in a skipped
    tile), which :func:`owner_velocity` owner-sums, normalises and damps.
    ``f [Nt, T]`` (CCD) scales the own and the partners' pose advance as in
    :func:`tile_project` (counted in ``ccd_launches``, or
    ``compound_ccd_launches`` with ``compound``)."""
    dev = pidx_c.device
    Nt = _check_tiles(state, consts, {}, ("invm", "invi", "dynb", "kin"),
                      dev)
    Cs = pidx_c.shape[1]
    checks = [(f"corr {n}", t, f32, (Nt, T)) for n, t in zip(
        ("dxx", "dxy", "dth", "cnt"), corr)]
    checks += [("large px", large["px"], f32, (L,)),
               ("large py", large["py"], f32, (L,)),
               ("large an", large["an"], f32, (L,)),
               ("pidx_c", pidx_c, i32, (Nt, Cs, T)),
               ("sol", sol, f32, (Nt, SOL_FIELDS, Cs, T)),
               ("lam", lam, f32, (Nt, 2, Cs, T)),
               ("gravity", gravity, f32, (2,)),
               ("tile_live", tile_live, f32, (Nt,))]
    if f is not None:
        checks.append(("f", f, f32, (Nt, T)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    kw = dict(h=h, relaxation=relaxation, max_dpos=max_dpos,
              rest_threshold=rest_threshold, lin_damp=lin_damp,
              ang_damp=ang_damp, compound=compound, f=f)
    if plain or not _route(dev):
        return tile_apply_plain(state, corr, consts, large, pidx_c, sol, lam,
                                gravity, tile_live, **kw)
    out = {k: torch.empty((Nt, T), dtype=f32, device=dev) for k in STATE_KEYS}
    accv = (torch.empty((4, Nt, T), dtype=f32, device=dev) if compound
            else None)
    p = _build.ptr
    s, c = state, consts
    args = _build.TileApplyArgs(
        *(p(x) for x in (s["px"], s["py"], s["an"], s["vx"], s["vy"],
                         s["om"], *corr, c["invm"], c["invi"], c["dynb"],
                         c["kin"], large["px"], large["py"], large["an"],
                         pidx_c, sol, lam, gravity, tile_live,
                         *(out[k] for k in STATE_KEYS))),
        None if accv is None else p(accv), None if f is None else p(f),
        Nt, Cs, h, relaxation, max_dpos, rest_threshold,
        1.0 / (1.0 + h * lin_damp), 1.0 / (1.0 + h * ang_damp),
        int(lin_damp > 0.0), int(ang_damp > 0.0))
    _build.launch("sf_tile_apply", args, dev)
    counter = (("compound_" if compound else "")
               + ("ccd_launches" if f is not None else "launches"))
    setattr(tile_apply, counter, getattr(tile_apply, counter) + 1)
    return (out, accv) if compound else out


# each instance's launches, counted apart
tile_apply.launches = 0
tile_apply.compound_launches = 0
tile_apply.ccd_launches = 0
tile_apply.compound_ccd_launches = 0


# ---------------------------------------------------------------------------
# owner reductions of compound rows (XLA code in the JAX package)
# ---------------------------------------------------------------------------


def owner_reduce(vals, ob, kc: int, op, neutral):
    """``vals [Mp, ...]`` reduced over each row's owner block (the rows
    sharing ``ob [Mp]``, contiguous, at most ``kc``) and broadcast back to
    every row of the block: ``_owner_shift_reduce`` (``pallas/tiles.py``),
    ``2 (kc - 1)`` masked rolls in its order (row ``i - o`` before ``i +
    o``, wrapping around the ends). ``op`` is elementwise and associative
    (``torch.add``, ``torch.maximum``, ``torch.logical_or``), ``neutral``
    its identity."""
    out = vals
    for o in range(1, kc):
        for sgn in (1, -1):
            sh = torch.roll(vals, sgn * o, dims=0)
            m = torch.roll(ob, sgn * o, dims=0) == ob
            if vals.dim() > 1:
                m = m.reshape(m.shape + (1,) * (vals.dim() - 1))
            out = op(out, torch.where(m, sh, neutral))
    return out


def _owner_rows(xs, ob, dev):
    """Check ``k`` (1-4) per-row f32 fields of ``ob.numel()`` rows each."""
    n = ob.shape[0]
    _check("ob", ob, i32, (n,), dev)
    if not 1 <= len(xs) <= 4:
        raise ValueError(f"owner_sum takes 1 to 4 fields, got {len(xs)}")
    for q, x in enumerate(xs):
        if x.numel() != n:
            raise ValueError(f"owner field {q}: {x.numel()} rows, expected "
                             f"{n}")
        _check(f"owner field {q}", x, f32, tuple(x.shape), dev)
    return n


def owner_sum_plain(xs, ob, kc: int):
    """Plain PyTorch twin of :func:`owner_sum`."""
    return [owner_reduce(x.reshape(-1), ob, kc, torch.add, 0.0).reshape(
        x.shape) for x in xs]


def owner_sum(xs, ob, kc: int, plain: bool = False):
    """Per-body sums of ``k`` per-row fields ``xs`` (1-4 f32 tensors of
    ``Mp`` rows each, any shape; K8's ``dxx, dxy, dth, cnt``) broadcast to
    every row of the body, in one launch: each row adds itself, then the
    rows ``1, 2, .. kc - 1`` before and after it that share its owner
    ``ob [Mp]`` i32, in :func:`owner_reduce`'s order (bitwise equal to it).
    Returns a list of ``k`` tensors shaped like ``xs``."""
    dev = ob.device
    n = _owner_rows(xs, ob, dev)
    if plain or not _route(dev):
        return owner_sum_plain(xs, ob, kc)
    ys = [torch.empty_like(x) for x in xs]
    four = ctypes.c_void_p * 4
    pad = [None] * (4 - len(xs))
    args = _build.OwnerSumArgs(
        four(*(x.data_ptr() for x in xs), *pad),
        four(*(y.data_ptr() for y in ys), *pad), ob.data_ptr(), len(xs), n,
        kc)
    _build.launch("sf_owner_sum", args, dev)
    owner_sum.launches += 1
    return ys


owner_sum.launches = 0


def owner_velocity_plain(state, accv, ob, kc: int, *, h: float,
                         lin_damp: float, ang_damp: float):
    """Plain PyTorch twin of :func:`owner_velocity`."""
    shape = state["vx"].shape
    av = torch.stack(owner_sum_plain(list(accv.reshape(4, -1)), ob, kc))
    nvx, nvy, nom = _velocity_update(
        state["vx"].reshape(-1), state["vy"].reshape(-1),
        state["om"].reshape(-1), av, h=h, lin_damp=lin_damp,
        ang_damp=ang_damp)
    return dict(state, vx=nvx.reshape(shape), vy=nvy.reshape(shape),
                om=nom.reshape(shape))


def owner_velocity(state, accv, ob, kc: int, *, h: float, lin_damp: float,
                   ang_damp: float, plain: bool = False):
    """The velocity pass of compound rows (``pallas/tiles.py:2072-2086``),
    in one launch: :func:`tile_apply`'s raw sums ``accv [4, Nt, T]`` summed
    over each body's rows (as :func:`owner_sum`), normalised by the body's
    count, added to the rows' velocities, then damping. Returns the state
    dict with new ``vx, vy, om``."""
    dev = ob.device
    Nt = _check_tiles(state, {}, {}, (), dev)
    n = _owner_rows([state["vx"]], ob, dev)
    _check("accv", accv, f32, (4, Nt, T), dev)
    kw = dict(h=h, lin_damp=lin_damp, ang_damp=ang_damp)
    if plain or not _route(dev):
        return owner_velocity_plain(state, accv, ob, kc, **kw)
    out = {k: torch.empty((Nt, T), dtype=f32, device=dev)
           for k in ("vx", "vy", "om")}
    p = _build.ptr
    args = _build.OwnerVelocityArgs(
        *(p(x) for x in (state["vx"], state["vy"], state["om"], accv, ob,
                         out["vx"], out["vy"], out["om"])),
        n, kc, 1.0 / (1.0 + h * lin_damp), 1.0 / (1.0 + h * ang_damp),
        int(lin_damp > 0.0), int(ang_damp > 0.0))
    _build.launch("sf_owner_velocity", args, dev)
    owner_velocity.launches += 1
    return dict(state, **out)


owner_velocity.launches = 0


def owner_min_plain(xs, ob, kc: int):
    """Plain PyTorch twin of :func:`owner_min`."""
    return [owner_reduce(x.reshape(-1), ob, kc, torch.minimum,
                         float("inf")).reshape(x.shape) for x in xs]


def owner_min(xs, ob, kc: int, plain: bool = False):
    """Per-body minima of ``k`` per-row fields ``xs`` (1-4 f32 tensors of
    ``Mp`` rows each; the TOI factors of :func:`tile_ccd`) broadcast to
    every row of the body, in one launch, as :func:`owner_sum` sums
    (``_owner_min3``; a minimum is exact, so bitwise equal to the twin).
    Returns a list of ``k`` tensors shaped like ``xs``."""
    dev = ob.device
    n = _owner_rows(xs, ob, dev)
    if plain or not _route(dev):
        return owner_min_plain(xs, ob, kc)
    ys = [torch.empty_like(x) for x in xs]
    four = ctypes.c_void_p * 4
    pad = [None] * (4 - len(xs))
    args = _build.OwnerSumArgs(
        four(*(x.data_ptr() for x in xs), *pad),
        four(*(y.data_ptr() for y in ys), *pad), ob.data_ptr(), len(xs), n,
        kc)
    _build.launch("sf_owner_min", args, dev)
    owner_min.launches += 1
    return ys


owner_min.launches = 0


# ---------------------------------------------------------------------------
# K10: the whole frame's substeps
# ---------------------------------------------------------------------------


def substep_loop(project, apply, state, consts, large, pidx_c, sol,
                 gravity, tile_live, *, substeps: int, h: float,
                 compliance: float, owner=None, ccd=None, **apply_kw):
    """``substeps`` x (``project``, then ``apply``) over all tiles, as
    :func:`tile_project` and :func:`tile_apply` (or their twins) take
    their arguments. ``owner = (owner_sum, owner_velocity, ob, kc)`` runs
    compound rows as ``pallas/tiles.py:2046-2086`` does: the project sums
    owner-summed before the apply, the apply's compound form, then the
    owner velocity pass. ``ccd = (tile_ccd, owner_min, ccd_slop)`` first
    takes each substep's TOI factors (``pallas/tiles.py:2010-2030``; with
    ``owner``, each body's least over its rows) and passes them to both
    phases. Returns ``(new_state, touched)``."""
    touched = torch.zeros(pidx_c.shape, dtype=f32, device=pidx_c.device)
    for _ in range(substeps):
        f = None
        if ccd is not None:
            toi, omin, ccd_slop = ccd
            f = toi(state, consts, large, pidx_c, sol, gravity, tile_live,
                    h=h, ccd_slop=ccd_slop)
            if owner is not None:  # a compound advances by its earliest row
                f = omin([f], owner[2], owner[3])[0]
        *corr, lam, touched = project(state, consts, large, pidx_c, sol,
                                      gravity, touched, tile_live, h=h,
                                      compliance=compliance, f=f)
        if owner is None:
            state = apply(state, corr, consts, large, pidx_c, sol, lam,
                          gravity, tile_live, h=h, f=f, **apply_kw)
            continue
        osum, ovel, ob, kc = owner
        corr = osum(corr, ob, kc)
        state, accv = apply(state, corr, consts, large, pidx_c, sol, lam,
                            gravity, tile_live, h=h, compound=True, f=f,
                            **apply_kw)
        state = ovel(state, accv, ob, kc, h=h, lin_damp=apply_kw["lin_damp"],
                     ang_damp=apply_kw["ang_damp"])
    return state, touched


def tile_frame_plain(state, consts, large, pidx_c, sol, gravity, tile_live,
                     *, ccd: bool = False, ccd_slop: float = 0.005,
                     owner=None, **kw):
    """Plain PyTorch twin of :func:`tile_frame`: the K7, K8 and K9 twins
    (with ``owner``, K9's compound form and the owner reductions' twins),
    looped over the substeps."""
    if owner is not None:
        owner = (owner_sum_plain, owner_velocity_plain, *owner)
    return substep_loop(
        tile_project_plain, tile_apply_plain, state, consts, large, pidx_c,
        sol, gravity, tile_live,
        ccd=(tile_ccd_plain, owner_min_plain, ccd_slop) if ccd else None,
        owner=owner, **kw)


def tile_frame(state, consts, large, pidx_c, sol, gravity, tile_live, *,
               substeps: int, h: float, compliance: float, relaxation: float,
               max_dpos: float, rest_threshold: float, lin_damp: float,
               ang_damp: float, ccd: bool = False, ccd_slop: float = 0.005,
               owner=None, plain: bool = False):
    """Every substep of a frame in one launch: ``substeps`` x
    (:func:`tile_project` over all tiles, then :func:`tile_apply` over all
    tiles), bitwise equal to that pair launched once a substep. Returns
    ``(new_state, touched [Nt, Cs, T])``, ``touched`` max-accumulated over
    the substeps. The corrections, ``lam`` and the two state buffers the
    substeps ping-pong between are allocated here, once a frame. ``ccd``
    (``consts["blt"]`` flags the bullet rows) runs three phases a substep,
    :func:`tile_ccd` into a TOI scratch first, bitwise equal to K7, K8 and
    K9 launched once a substep (counted in ``ccd_launches``).

    ``owner = (ob [Nt * T] i32, kc)`` runs compound rows (the compound
    frame, ``csrc/tile_compound_frame.cu``): each substep is K8, then
    :func:`owner_sum` of its four sums, K9's compound form and
    :func:`owner_velocity` (with ``ccd``, K7 and :func:`owner_min` first),
    each a phase between grid barriers, bitwise equal to
    :func:`substep_loop` with ``owner`` over those launches (counted in
    ``compound_launches``, or ``compound_ccd_launches`` with ``ccd``)."""
    if substeps < 1:
        raise ValueError(f"a frame needs at least one substep, got "
                         f"{substeps}")
    dev = pidx_c.device
    Nt = _check_tiles(state, consts, {}, ("invm", "invi", "dynb", "kin")
                      + (("blt",) if ccd else ()), dev)
    Cs = pidx_c.shape[1]
    for name, t, dtype, shape in (
            ("large px", large["px"], f32, (L,)),
            ("large py", large["py"], f32, (L,)),
            ("large an", large["an"], f32, (L,)),
            ("pidx_c", pidx_c, i32, (Nt, Cs, T)),
            ("sol", sol, f32, (Nt, SOL_FIELDS, Cs, T)),
            ("gravity", gravity, f32, (2,)),
            ("tile_live", tile_live, f32, (Nt,))):
        _check(name, t, dtype, shape, dev)
    if owner is not None:
        ob, kc = owner
        _check("ob", ob, i32, (Nt * T,), dev)
        if kc < 1:
            raise ValueError(f"owner span kc must be at least 1, got {kc}")
    kw = dict(substeps=substeps, h=h, compliance=compliance,
              relaxation=relaxation, max_dpos=max_dpos,
              rest_threshold=rest_threshold, lin_damp=lin_damp,
              ang_damp=ang_damp)
    if plain or not _route(dev):
        return tile_frame_plain(state, consts, large, pidx_c, sol, gravity,
                                tile_live, ccd=ccd, ccd_slop=ccd_slop,
                                owner=owner, **kw)
    # one allocation for the frame's float scratch, which the returned
    # state keeps alive: the project sums, their owner sums and the
    # velocity pass's sums (compound), the two state buffers, the TOI
    # factors (raw and owner-min'ed), then lam
    planes = (4 + 2 * len(STATE_KEYS) + (8 if owner is not None else 0)
              + ((2 if owner is not None else 1) if ccd else 0))
    flat = torch.empty(planes * Nt * T + Nt * 2 * Cs * T, dtype=f32,
                       device=dev)
    scratch = flat[:planes * Nt * T].view(planes, Nt, T)
    lam = flat[planes * Nt * T:].view(Nt, 2, Cs, T)
    corr, bufs = scratch[:4], scratch[4:16].view(2, len(STATE_KEYS), Nt, T)
    rest = scratch[16:]
    touched = torch.zeros((Nt, Cs, T), dtype=f32, device=dev)
    p = _build.ptr
    s, c = state, consts
    st_in = [p(s[k]) for k in STATE_KEYS]
    large_pose = [p(large[k]) for k in ("px", "py", "an")]
    osum = accv = f_own = None
    if owner is not None:
        osum, accv, rest = rest[:4], rest[4:8], rest[8:]
    if ccd:  # the TOI scratch, written by each substep's first phase
        f = rest[0]
        ccd_args = _ccd_args(state, consts, large, pidx_c, sol, gravity,
                             tile_live, f, h, ccd_slop)
        if owner is not None:  # the phases read each body's least factor
            f_own = rest[1]
        fp = p(f if f_own is None else f_own)
    else:
        ccd_args, fp = _build.TileCcdArgs(), None
    project = _build.TileProjectArgs(
        *st_in, p(c["invm"]), p(c["invi"]), p(c["dynb"]), *large_pose,
        p(pidx_c), p(sol), p(gravity), p(touched), p(tile_live),
        *(p(x) for x in corr), p(lam), p(touched), fp,
        Nt, Cs, h, compliance / (h * h))
    apply = _build.TileApplyArgs(
        *st_in, *(p(x) for x in (corr if osum is None else osum)),
        p(c["invm"]), p(c["invi"]), p(c["dynb"]), p(c["kin"]), *large_pose,
        p(pidx_c), p(sol), p(lam), p(gravity), p(tile_live),
        *(p(x) for x in bufs[1]), None if accv is None else p(accv), fp,
        Nt, Cs, h, relaxation, max_dpos, rest_threshold,
        1.0 / (1.0 + h * lin_damp), 1.0 / (1.0 + h * ang_damp),
        int(lin_damp > 0.0), int(ang_damp > 0.0))
    six = ctypes.c_void_p * len(STATE_KEYS)
    args = _build.TileFrameArgs(
        project, apply, six(*(p(x) for x in bufs[0])),
        six(*(p(x) for x in bufs[1])), substeps, ccd_args)
    if owner is None:
        _build.launch("sf_tile_frame", args, dev)
        counter = "ccd_launches" if ccd else "launches"
    else:
        _build.launch("sf_tile_compound_frame", _build.TileCompoundFrameArgs(
            args, p(osum), None if f_own is None else p(f_own), p(ob), kc),
            dev)
        counter = "compound_ccd_launches" if ccd else "compound_launches"
    setattr(tile_frame, counter, getattr(tile_frame, counter) + 1)
    # substep s writes the second buffer when s is even, the first when odd
    out = bufs[1] if substeps % 2 else bufs[0]
    return dict(zip(STATE_KEYS, out)), touched


# each instance's launches, counted apart
tile_frame.launches = 0
tile_frame.ccd_launches = 0
tile_frame.compound_launches = 0
tile_frame.compound_ccd_launches = 0


# ---------------------------------------------------------------------------
# one frame
# ---------------------------------------------------------------------------


def run_tiled_frame(state, consts, large, gravity, tables=None, *, C: int,
                    Cs: int, substeps: int, h: float, dt: float,
                    margin: float, compliance: float, relaxation: float,
                    max_dpos: float, rest_threshold: float, lin_damp: float,
                    ang_damp: float, sleep_velocity: float = 0.0,
                    sort_axis: int = 0, fuse: bool = True,
                    event_ids=None, n_colliders: int = 0,
                    compound: bool = False, owner_kc: int = 1,
                    kin_velocity: float = 0.0, ccd: bool = False,
                    ccd_slop: float = 0.005, plain: bool = False):
    """One frame on the sorted-tile layout: slot tables (built here with
    one-frame sweeps unless ``tables = (pidx, act)`` reuses a K-frame
    build), the manifold kernel, then the substeps: with ``fuse`` (the
    default) all of them in one :func:`tile_frame` launch, else ``substeps``
    x (project, apply) launches, the fused kernels' bitwise reference.

    ``compound``: rows of multi-collider bodies (``consts["obody"]`` their
    owner, sibling blocks of at most ``owner_kc`` rows). Each substep runs
    as the JAX package runs it (``pallas/tiles.py:2031-2086``): the project
    phase, :func:`owner_sum` of its four sums, the apply's compound form
    and :func:`owner_velocity`; fused, in one launch of the compound frame
    (:func:`tile_frame` with ``owner``), else as those four launches a
    substep. ``event_ids = (cid, lcid)`` (see :func:`tile_manifold`) adds
    the solve slots' event keys; ``kin_velocity`` is K6's wake speed of a
    kinematic partner. ``ccd`` (``consts["blt"]`` the bullet rows) clamps
    each substep's pose advance at the TOI factors of :func:`tile_ccd`:
    the fused kernels' CCD forms, else one K7 launch before each project
    launch (on compound rows, through :func:`owner_min`).

    ``consts`` carries the per-row constants, ``edge_lo``/``edge_hi``
    ``[Nt]`` and ``tile_live`` ``[Nt]``. Returns ``(new_state, touched
    [Nt, Cs, T], (count, count_touch, count_close) [Nt, T], winover [Nt,
    T], wake, pen [Nt, T], pidx [Nt, C, T], pidx_c [Nt, Cs, T], act [Nt, C,
    T], npts [Nt, T], src [Nt, Cs, T], nact [Nt, 2, T], keyc [Nt, Cs, T]
    or None)``; the counts and ``winover`` are None when ``tables`` is
    given (the caller keeps them from its build)."""
    if tables is None:
        (pidx, act, count, count_touch, count_close, winover,
         _sweep) = build_tile_tables(
            state, consts, large, consts["edge_lo"], consts["edge_hi"],
            gravity, C=C, margin=margin, dt=dt, sort_axis=sort_axis,
            plain=plain)
    else:
        pidx, act = tables
        count = count_touch = count_close = winover = None
    tile_live = consts["tile_live"]
    sol, pidx_c, src, nact, wake, pen, npts, *keyc = tile_manifold(
        state, consts, large, pidx, act, tile_live, Cs=Cs, margin=margin,
        dt=dt, sleep_velocity=sleep_velocity, kin_velocity=kin_velocity,
        event_ids=event_ids, n_colliders=n_colliders, plain=plain)
    kw = dict(substeps=substeps, h=h, compliance=compliance,
              relaxation=relaxation, max_dpos=max_dpos,
              rest_threshold=rest_threshold, lin_damp=lin_damp,
              ang_damp=ang_damp)
    args = (state, consts, large, pidx_c, sol, gravity, tile_live)
    ob = (consts["obody"].reshape(-1), owner_kc) if compound else None
    if fuse:
        state, touched = tile_frame(*args, **kw, ccd=ccd, ccd_slop=ccd_slop,
                                    owner=ob, plain=plain)
    else:
        toi = owner = None
        if ccd:
            toi = (functools.partial(tile_ccd, plain=plain),
                   functools.partial(owner_min, plain=plain), ccd_slop)
        if compound:
            owner = (functools.partial(owner_sum, plain=plain),
                     functools.partial(owner_velocity, plain=plain), *ob)
        state, touched = substep_loop(
            functools.partial(tile_project, plain=plain),
            functools.partial(tile_apply, plain=plain), *args, **kw,
            owner=owner, ccd=toi)
    return (state, touched, (count, count_touch, count_close), winover, wake,
            pen, pidx, pidx_c, act, npts, src, nact,
            keyc[0] if keyc else None)
