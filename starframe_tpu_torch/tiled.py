"""The sorted-sweep tile engine's glue for one big world: the sort into tile
layout, the large set, the per-frame kernels, sleep and the sort back.

The PyTorch counterpart of ``starframe_tpu/tiled.py`` for one world
without joints (the 10k-body pile, BASELINE.json:2, asleep or awake, and
its compound variant), on one device. Rows are colliders sorted along
``cfg.tile_sort_axis`` and cut into tiles of ``T`` rows; every contact
partner is either in the row's 3-tile sort window or in the large set of
static colliders (``hopper/tiles.py``).

Compound worlds (more colliders than bodies) keep each body's collider
rows contiguous: the sort groups rows by owner first, the owner's position
is every sibling's key bit for bit, and the later sorts are stable. Each
substep then sums the rows' corrections over their body with masked rolls
of the row axis (``hopper.owner_sum``, ``hopper.owner_velocity``); the
wake signal and the keep set are owner-reduced the same way, so sibling
rows keep identical state and sleep counters. A fused frame of compound
rows runs its substeps, owner reductions included, in one launch of the
compound frame (``hopper.tile_frame`` with ``owner``).

CCD (``cfg.ccd``, bodies flagged ``bullet=True``): once a substep each
bullet row's pose advance is clamped at its time of impact against the
frame's manifolds (``hopper.tile_ccd``, K7; in K10 its first phase), so a
bullet stops on the surface it would cross; velocities keep full speed.
The consts carry the rows' bullet flags (``blt``); a compound body
advances by its earliest row's clamp (``hopper.owner_min``).

- :func:`tiled_step`: one frame, sorted in and out (the World-API shape).
- :func:`tiled_rollout`: N frames kept in tile layout, re-sorted every
  ``cfg.frames_per_broadphase`` frames while rows drift, or earlier when
  the window-completeness guard (from actual per-tile extents, so a stale
  sort is safe) fires; the slot tables are rebuilt early when a row leaves
  its sweep budget. The guard's verdicts, and with sleep on whether
  anything is awake and whether the layout is partitioned, are read in
  one host sync per frame, counted in :data:`host_syncs`. Under a
  ``torch.profiler`` it records its ``starframe.*`` spans (``spans.py``).

Sleep (``cfg.sleep_velocity > 0``) is the JAX package's: a body whose
speed stays under ``sleep_velocity`` for ``sleep_frames`` frames is frozen
(its inverse masses are zeroed for the frame, so awake partners solve
against it as static) and wakes when a fast dynamic partner comes inside
its margin. One rule is the port's own: a kinematic partner moving at
``sleep_velocity`` or faster inside a sleeper's margin wakes it too (the
JAX package never lets a kinematic mover wake a sleeper, so a moving
platform slides out from under a frozen body; ROADMAP.md C). A tile
whose 3-tile window holds no awake body skips its kernel work
(``tile_live``); a frame with nothing awake launches nothing.
With ``cfg.tile_awake_compaction`` the rollout's re-sorts partition the
layout: awake bodies and every row they can reach first, in sort order,
then the sleepers nothing awake can reach, which fill trailing tiles whose
windows sleep. The kernels always run over the full grid of tiles and let
``tile_live`` skip the sleeping tail: the JAX package's precompiled
awake-prefix grid sizes (``_bucket_sizes``) are a TPU compile answer and
are not kept (ROADMAP.md C).

:func:`tiled_rollout` with ``with_events`` also returns each frame's
contact-event keys (``events.py`` reads them), computed in K6.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP.md item (:func:`use_tiled`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SolverConfig
from .hopper.tiles import (
    L,
    T,
    WIN,
    build_tile_tables,
    check_event_keys,
    owner_reduce,
    run_tiled_frame,
    win_start,
)
from .spans import NULL, span
from .state import BODY_BULLET, BODY_KINEMATIC, COL_ACTIVE, COL_SENSOR, World

f32 = torch.float32
i32 = torch.int32

_BIG = 1e30

# host round trips of the rollouts (one per frame with K > 1 or sleep on:
# the guard's verdicts and whether anything is awake decide on the host
# whether to re-sort, rebuild or run the frame)
host_syncs = 0


def _require_slice(world: World, cfg: SolverConfig, shard_axis=None) -> None:
    """Raise on what the port's tile engine does not run yet."""
    todo = [
        (world.joints.j > 0, "joints on the tile engine (_tile_joint_pass)",
         "A4.5"),
        (shard_axis is not None, "the sharded tile axis",
         "A4, with the multi-device work of A5"),
    ]
    for hit, what, item in todo:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


def _compound(world: World) -> bool:
    return world.colliders.m != world.bodies.n


def _compound_fits(world: World, cfg: SolverConfig) -> bool:
    """The JAX package's value checks of a compound world (host numpy):
    no joints, every moving body with an active collider, no inactive
    collider on a moving body, and at most ``cfg.max_colliders_per_body``
    colliders a body (the owner reductions' span)."""
    if world.joints.j > 0:
        return False
    b, c = world.bodies, world.colliders
    cb = c.body_idx.cpu().numpy()
    act = (c.flags.cpu().numpy() & COL_ACTIVE) != 0
    moves = ((b.inv_mass.cpu().numpy() > 0) | (b.inv_inertia.cpu().numpy() > 0)
             | ((b.flags.cpu().numpy() & BODY_KINEMATIC) != 0))
    has_row = np.zeros(b.n, bool)
    has_row[cb[act]] = True
    if (moves & ~has_row).any() or ((~act) & moves[cb]).any():
        return False
    return np.bincount(cb, minlength=b.n).max() <= cfg.max_colliders_per_body


def use_tiled(world: World, cfg: SolverConfig, shard_axis=None) -> bool:
    """Shape/config gate of the tiled single-world path: False where the
    JAX package keeps a world on its other tiers (``use_pallas`` off,
    ``iterations != 1``, per-substep manifolds (which CCD also rules
    out: its clamp trusts the frame-start normals), fewer than four tiles of
    colliders, a compound world its owner reductions cannot run: see
    :func:`_compound_fits`). A world that passes and needs a branch the
    port has not ported raises ``NotImplementedError`` naming its
    ROADMAP.md item."""
    if cfg.use_pallas is False or cfg.iterations != 1:
        return False
    if cfg.manifold_refresh != "frame":
        return False
    if world.colliders.m < 4 * T:
        return False
    if _compound(world) and not _compound_fits(world, cfg):
        return False
    _require_slice(world, cfg, shard_axis)
    return True


def _owner_width_overflow(world: World, cfg: SolverConfig):
    """The HARD ``owner_overflow`` counter of a compound world (i32 device
    scalar): colliders past ``cfg.max_colliders_per_body`` on any body
    (their rows' corrections miss their siblings), moving bodies with no
    active collider (no row, never integrated) and inactive colliders on
    moving bodies (their rows sit in the frozen tail). :func:`use_tiled`
    keeps such worlds off the tile engine; this counts them on a direct
    call."""
    b, c = world.bodies, world.colliders
    cb = c.body_idx.long()
    act = ((c.flags & COL_ACTIVE) != 0).to(i32)
    moves = ((b.inv_mass > 0) | (b.inv_inertia > 0)
             | ((b.flags & BODY_KINEMATIC) != 0))
    cnt = torch.bincount(cb, minlength=b.n)
    width = torch.clamp(cnt - cfg.max_colliders_per_body, min=0).sum()
    act_rows = torch.zeros(b.n, dtype=i32, device=cb.device).scatter_reduce(
        0, cb, act, reduce="amax")
    no_row = (moves & (act_rows == 0)).sum()
    inact = ((act == 0) & moves[cb]).sum()
    return (width + no_row + inact).to(i32)


def _solve_cap(cfg: SolverConfig) -> int:
    """Per-frame solve-slot width (``cfg.tile_solve_capacity``): rounded up
    to a multiple of 8 and clamped to the table width; <= 0 disables
    compaction."""
    Cs = -(-cfg.slot_capacity // 8) * 8
    if cfg.tile_solve_capacity <= 0:
        return Cs
    return min(-(-cfg.tile_solve_capacity // 8) * 8, Cs)


def _table_cap(cfg: SolverConfig) -> int:
    """Slot-table width: ``cfg.slot_capacity`` rounded up to 8."""
    return -(-cfg.slot_capacity // 8) * 8


# ---------------------------------------------------------------------------
# tile-layout entry/exit + re-sort
# ---------------------------------------------------------------------------


def _sort_key(act, mov, x):
    """Moving active rows by position, then statics, then inactive rows
    and padding (ties keep index order: the sorts are stable)."""
    return torch.where((act > 0) & (mov > 0), x,
                       torch.where(act > 0, torch.full_like(x, _BIG),
                                   torch.full_like(x, 2 * _BIG)))


def _enter_tiles(world: World, cfg: SolverConfig):
    """Canonical world -> ``(state, consts, large, body_id,
    large_overflow)``: ``state``/``consts`` ``[Nt, T]`` (verts ``[Nt, V,
    T]``) in sorted order, ``body_id [Mp]`` the canonical collider of each
    tile row (padding rows get ids >= M, so an argsort of ``body_id``
    restores canonical order), ``large`` the static active colliders
    (``[L]``, verts ``[V, L]``), which never change."""
    b, c = world.bodies, world.colliders
    M = c.m
    dev = b.pos.device
    n_tiles = -(-M // T)
    if n_tiles < 3:
        raise ValueError("tiled path needs >= 3 tiles")
    Mp = n_tiles * T
    cb = c.body_idx.long()

    responds = ((b.inv_mass[cb] > 0) | (b.inv_inertia[cb] > 0)).to(f32)
    kin = ((b.flags[cb] & BODY_KINEMATIC) != 0).to(f32)
    moves = torch.maximum(responds, kin)
    col_active = ((c.flags & COL_ACTIVE) != 0).to(f32)
    sensor = ((c.flags & COL_SENSOR) != 0).to(f32)

    # moving rows by their owner's position (the same for every sibling),
    # statics, inactive rows and padding to the tail; a compound world
    # first groups rows by owner, and the stable sort keeps each body's
    # rows together
    axis = 0 if cfg.tile_sort_axis == "x" else 1
    key = _sort_key(col_active, moves, b.pos[cb, axis])
    if b.n != M:
        grp = torch.argsort(cb, stable=True)
        perm = grp[torch.argsort(key[grp], stable=True)]
    else:
        perm = torch.argsort(key, stable=True)
    perm = torch.cat([perm, torch.arange(M, Mp, device=dev)])
    body_id = perm.to(i32)

    def srt(x):
        pad = torch.zeros((Mp - M,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        return torch.cat([x, pad])[perm]

    def tile2(x):
        return x.reshape(n_tiles, T).contiguous()

    def tiled(x):
        return tile2(srt(x))

    state = dict(px=tiled(b.pos[cb, 0]), py=tiled(b.pos[cb, 1]),
                 an=tiled(b.angle[cb]), vx=tiled(b.vel[cb, 0]),
                 vy=tiled(b.vel[cb, 1]), om=tiled(b.ang_vel[cb]))
    V = c.verts.shape[1]

    def verts(k):
        return srt(c.verts[..., k]).reshape(n_tiles, T, V).transpose(
            1, 2).contiguous()

    # conservative per-collider extent for the staleness guard: max vertex
    # norm + dilation radius + the narrowphase margin pad
    vx_, vy_ = c.verts[..., 0], c.verts[..., 1]
    ext = (torch.sqrt(vx_ * vx_ + vy_ * vy_).amax(1)
           + c.radius + 0.5 * cfg.contact_margin)
    obody = torch.cat([cb.to(i32), torch.arange(M, Mp, dtype=i32, device=dev)
                       + b.n])[perm]
    consts = dict(
        rad=tiled(c.radius), nv=tiled(c.nverts), fric=tiled(c.friction),
        rst=tiled(c.restitution), sen=tiled(sensor), act=tiled(col_active),
        mov=tiled(moves), invm=tiled(b.inv_mass[cb]),
        invi=tiled(b.inv_inertia[cb]), lay=tiled(c.layer),
        msk=tiled(c.mask), responds=tiled(responds),
        dynb=tiled((b.inv_mass[cb] > 0).to(f32)), kin=tiled(kin),
        ext=tiled(ext), sleep=tiled(b.sleep_count[cb]),
        blt=tiled(((b.flags[cb] & BODY_BULLET) != 0).to(f32)),
        obody=tile2(obody),
        kept=torch.ones((n_tiles, T), dtype=f32, device=dev),
        vlx=verts(0), vly=verts(1))

    # large set: the static active colliders, broadcast to every tile
    lkey = torch.where((col_active > 0) & (moves == 0),
                       torch.arange(M, dtype=i32, device=dev),
                       torch.full((M,), 2 ** 30, dtype=i32, device=dev))
    lsort = torch.sort(lkey).values[:L]
    n_large = (lkey < 2 ** 30).sum(dtype=i32)
    l_valid = torch.arange(L, device=dev) < torch.clamp(n_large, max=L)
    lidx = torch.where(l_valid, lsort, 0).long()
    lb = cb[lidx]
    large = dict(
        px=b.pos[lb, 0].contiguous(), py=b.pos[lb, 1].contiguous(),
        an=b.angle[lb].contiguous(),
        vlx=c.verts[lidx, :, 0].T.contiguous(),
        vly=c.verts[lidx, :, 1].T.contiguous(),
        rad=c.radius[lidx], nv=c.nverts[lidx], fric=c.friction[lidx],
        rst=c.restitution[lidx], sen=sensor[lidx],
        act=torch.where(l_valid, col_active[lidx], 0.0),
        lay=c.layer[lidx], msk=c.mask[lidx], cols=lidx.to(i32))
    large_overflow = torch.clamp(n_large - L, min=0)
    return state, consts, large, body_id, large_overflow


_RESORT_KEYS = ("rad", "nv", "fric", "rst", "sen", "act", "mov", "invm",
                "invi", "lay", "msk", "responds", "dynb", "kin", "ext",
                "sleep", "blt", "kept", "obody")


def _resort(state: dict, consts: dict, body_id, axis_key: str = "px"):
    """Re-sort the tile layout by the current sort-axis position (statics
    and padding keep the tail)."""
    key = _sort_key(consts["act"].reshape(-1), consts["mov"].reshape(-1),
                    state[axis_key].reshape(-1))
    perm = torch.argsort(key, stable=True)
    return _apply_perm(state, consts, body_id, perm)


def _apply_perm(state, consts, body_id, perm):
    """Apply a row permutation ``perm [Mp]`` to the whole tile layout."""
    Nt = state["px"].shape[0]

    def rows(x):
        return x.reshape(-1)[perm].reshape(Nt, T)

    state = {k: rows(v) for k, v in state.items()}
    new_consts = {k: rows(consts[k]) for k in _RESORT_KEYS}
    V = consts["vlx"].shape[1]
    for k in ("vlx", "vly"):
        v = consts[k].transpose(1, 2).reshape(Nt * T, V)[perm]
        new_consts[k] = v.reshape(Nt, T, V).transpose(1, 2).contiguous()
    return state, new_consts, body_id[perm]


def _asleep(consts: dict, cfg: SolverConfig):
    """Rows asleep: the counter has run out on a dynamic body."""
    return (consts["sleep"] >= cfg.sleep_frames) & (consts["invm"] > 0)


def _keep_boxes(state: dict, consts: dict, cfg: SolverConfig, gravity):
    """Per-row swept boxes and flags for the keep set, ``[Mp]`` each, in any
    row order (no window reads). Returns ``((lox, hix, loy, hiy), mova,
    awake)``: ``mova`` the moving active rows, ``awake`` those not asleep.

    The boxes inflate like :func:`build_tile_tables`'s (the margin pad plus
    the K-frame speed sweep with the same slack, floor and cap) without its
    layer and sensor filters: a superset, so every pair a later table build
    or the positional guard's horizon can admit is covered by an overlap of
    these boxes."""
    Mp = state["px"].numel()
    px, py, an, vx, vy = (state[k].reshape(Mp)
                          for k in ("px", "py", "an", "vx", "vy"))
    V = consts["vlx"].shape[1]
    vlx = consts["vlx"].transpose(1, 2).reshape(Mp, V)
    vly = consts["vly"].transpose(1, 2).reshape(Mp, V)
    rad = consts["rad"].reshape(Mp)
    mova = (consts["mov"].reshape(Mp) > 0) & (consts["act"].reshape(Mp) > 0)
    ca = torch.cos(an)[:, None]
    sa = torch.sin(an)[:, None]
    wx = px[:, None] + ca * vlx - sa * vly
    wy = py[:, None] + sa * vlx + ca * vly
    ext = torch.sqrt(vlx * vlx + vly * vly).amax(1) + rad
    pad = rad + 0.5 * cfg.contact_margin
    K = max(cfg.frames_per_broadphase, 1)
    if K > 1:
        gmag = torch.sqrt(torch.sum(gravity * gravity))
        spd = torch.sqrt(vx * vx + vy * vy)
        sw = torch.minimum(
            (spd + gmag * cfg.dt + cfg.broadphase_speed_slack) * (K * cfg.dt)
            + cfg.tile_sweep_floor * ext, cfg.tile_sweep_cap * ext) * mova
    else:
        sw = torch.maximum(torch.abs(vx), torch.abs(vy)) * cfg.dt * mova
    grow = pad + sw
    boxes = (wx.amin(1) - grow, wx.amax(1) + grow, wy.amin(1) - grow,
             wy.amax(1) + grow)
    return boxes, mova, mova & ~_asleep(consts, cfg).reshape(Mp)


def _keep_hop(boxes, flag, n_tiles: int):
    """One neighbourhood hop on a layout sorted along the sort axis: the
    rows whose box overlaps a flagged box in their 3-tile window (a dense
    ``[Nt, 3T, T]`` test, exhaustive on a sorted layout)."""
    lox, hix, loy, hiy = (b.reshape(n_tiles, T) for b in boxes)
    start = win_start(n_tiles, lox.device)

    def win(a):  # [Nt, T] -> [Nt, 3T]
        return torch.cat([a[start], a[start + 1], a[start + 2]], dim=1)

    fl = win(flag.reshape(n_tiles, T))[:, :, None]
    ov = ((win(lox)[:, :, None] <= hix[:, None, :])
          & (lox[:, None, :] <= win(hix)[:, :, None])
          & (win(loy)[:, :, None] <= hiy[:, None, :])
          & (loy[:, None, :] <= win(hiy)[:, :, None]))
    return (ov & fl).any(dim=1).reshape(n_tiles * T)


def _partition_perm(key_x, boxes_x, mova_x, awake_x, n_tiles: int,
                    ob_x=None, kc: int = 1):
    """The keep set and the partition permutation, computed in sorted row
    order (``*_x``). ``kept`` holds the awake rows, every moving row whose
    box an awake row's box overlaps (the contacts and wake signals awake
    bodies can cause within the guard's horizon) and two more hops (a woken
    sleeper at the edge finds its own partners already in the prefix).
    Returns ``(perm_p [Mp] into sorted order, kept_x [Mp] bool)``: moving
    kept rows, moving rows not kept, statics, then inactive rows and
    padding, each class in sorted order (the sort is stable).

    ``ob_x`` (compound rows: the owner of each sorted row, sibling blocks
    of at most ``kc``) makes keeping a body property: one kept row keeps its
    block, so the partition never splits a body. The JAX package also
    widens the set along joints; jointed worlds raise at
    :func:`_require_slice` (ROADMAP.md A4.5)."""
    kept = awake_x
    for _ in range(3):
        kept = kept | (mova_x & _keep_hop(boxes_x, kept, n_tiles))
    kept = torch.where(mova_x, kept, True)
    if ob_x is not None:
        kept = owner_reduce(kept, ob_x, kc, torch.logical_or, False)
    pclass = torch.where(mova_x, torch.where(kept, 0.0, 1.0),
                         torch.where(key_x >= 2 * _BIG, 3.0, 2.0))
    return torch.argsort(pclass, stable=True), kept


def _compact_resort(state: dict, consts: dict, body_id, cfg: SolverConfig,
                    gravity, axis_key: str, compound: bool = False):
    """The compacting re-sort: one composed permutation (the sort along the
    sort axis, then the stable keep partition) and the new ``kept`` flags.
    The keep set is computed on the sorted layout, where the 3-tile window
    test is exhaustive; ``compound`` keeps it whole per body."""
    Nt = state["px"].shape[0]
    key = _sort_key(consts["act"].reshape(-1), consts["mov"].reshape(-1),
                    state[axis_key].reshape(-1))
    perm_x = torch.argsort(key, stable=True)
    boxes, mova, awake = _keep_boxes(state, consts, cfg, gravity)
    perm_p, kept_x = _partition_perm(
        key[perm_x], tuple(b[perm_x] for b in boxes), mova[perm_x],
        awake[perm_x], Nt,
        ob_x=consts["obody"].reshape(-1)[perm_x] if compound else None,
        kc=cfg.max_colliders_per_body)
    state, consts, body_id = _apply_perm(state, consts, body_id,
                                         perm_x[perm_p])
    consts["kept"] = kept_x[perm_p].to(f32).reshape(Nt, T)
    return state, consts, body_id


def _edge_rows(state: dict, consts: dict, cfg: SolverConfig):
    """Window-completeness bounds from ACTUAL per-tile extents, valid for
    any (possibly stale) order. Returns ``(edge_lo, edge_hi)`` ``[Nt]`` for
    the table kernel and the staleness flag (a device bool): some live
    row's reach escapes its 3-tile window's coverage."""
    Nt = state["px"].shape[0]
    ak = "x" if cfg.tile_sort_axis == "x" else "y"
    px, vx = state["p" + ak], state["v" + ak]
    live = ((consts["act"] > 0) & (consts["mov"] > 0)
            & (consts["kept"] > 0))
    reach = consts["ext"] + torch.abs(vx) * cfg.dt
    tile_hi = torch.where(live, px + reach, -_BIG).amax(dim=1)
    tile_lo = torch.where(live, px - reach, _BIG).amin(dim=1)
    premax = torch.cummax(tile_hi, 0).values  # prefix max of tile highs
    sufmin = torch.flip(torch.cummin(torch.flip(tile_lo, [0]), 0).values,
                        [0])  # suffix min of tile lows
    start = win_start(Nt, px.device)
    right = start + WIN  # first tile past the window
    left = start - 1  # last tile before the window
    edge_hi = torch.where(right <= Nt - 1,
                          sufmin[torch.clamp(right, max=Nt - 1)], _BIG)
    edge_lo = torch.where(left >= 0, premax[torch.clamp(left, min=0)], -_BIG)
    stale = torch.any((tile_hi > edge_hi) | (tile_lo < edge_lo))
    return edge_lo.contiguous(), edge_hi.contiguous(), stale


def _frame_consts(state, consts, cfg: SolverConfig, edges) -> dict:
    """The consts a frame's kernels read: ``consts`` with the window
    edges and ``tile_live``, and with sleep on, the sleepers frozen for the
    frame (inverse masses zeroed, so awake partners solve against them as
    static) and ``tile_live`` 0 for a tile whose clamped 3-tile window holds
    no awake moving row (it skips its kernel work)."""
    Nt = state["px"].shape[0]
    dev = state["px"].device
    kc = dict(consts, edge_lo=edges[0], edge_hi=edges[1])
    if cfg.sleep_velocity > 0.0:
        asleep = _asleep(consts, cfg)
        awake_f = 1.0 - asleep.to(f32)
        kc.update(invm=consts["invm"] * awake_f,
                  invi=consts["invi"] * awake_f,
                  dynb=consts["dynb"] * awake_f)
        awake_t = ((consts["mov"] > 0) & (consts["act"] > 0)
                   & ~asleep).any(dim=1)
        start = win_start(Nt, dev)
        kc["tile_live"] = (awake_t[start] | awake_t[start + 1]
                           | awake_t[start + 2]).to(f32)
    else:
        kc["tile_live"] = torch.ones((Nt,), dtype=f32, device=dev)
    return kc


def _run_frame(state, consts, large, cfg: SolverConfig, gravity,
               tables=None, edges=None, fuse: bool = True,
               plain: bool = False, event_ids=None, n_colliders: int = 0,
               compound: bool = False):
    """One frame on tile-layout state. Returns ``(state', consts', frame)``,
    with ``frame`` the rest of :func:`run_tiled_frame`'s outputs; ``tables =
    (pidx, act)`` reuses a K-frame build, None builds one-frame tables;
    ``event_ids``, ``n_colliders`` and ``compound`` go to
    :func:`run_tiled_frame`.

    The kernels read :func:`_frame_consts`. With sleep on, after the frame
    each row's sleep counter counts up while it is slow (at the raw
    ``sleep_velocity``; the kernels take the wake threshold,
    ``sleep_velocity * wake_velocity_factor``) and resets when it is fast
    or K6 saw a fast dynamic partner or a kinematic one at ``sleep_velocity``
    or faster (``wake``, on compound rows the largest over the body's rows,
    so that siblings keep one counter); rows asleep after that have their
    velocities zeroed (``consts'`` carries the new counters). ``cfg.ccd``
    runs the substeps' TOI clamp."""
    if edges is None:
        edges = _edge_rows(state, consts, cfg)[:2]
    new_state, *frame = run_tiled_frame(
        state, _frame_consts(state, consts, cfg, edges), large, gravity,
        tables, C=_table_cap(cfg), Cs=_solve_cap(cfg), substeps=cfg.substeps,
        h=cfg.dt / cfg.substeps, dt=cfg.dt, margin=cfg.contact_margin,
        compliance=cfg.contact_compliance, relaxation=cfg.relaxation,
        max_dpos=cfg.max_dpos_eff, rest_threshold=cfg.restitution_threshold,
        lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
        sleep_velocity=cfg.sleep_velocity * cfg.wake_velocity_factor,
        sort_axis=0 if cfg.tile_sort_axis == "x" else 1, fuse=fuse,
        event_ids=event_ids, n_colliders=n_colliders, compound=compound,
        owner_kc=cfg.max_colliders_per_body, kin_velocity=cfg.sleep_velocity,
        ccd=cfg.ccd, ccd_slop=cfg.ccd_slop, plain=plain)
    if cfg.sleep_velocity > 0.0:
        vx, vy, om = new_state["vx"], new_state["vy"], new_state["om"]
        slow = (vx * vx + vy * vy + om * om) < cfg.sleep_velocity ** 2
        sleep = torch.where(slow, consts["sleep"] + 1, 0)
        wake = frame[3]
        if compound:
            wake = owner_reduce(
                wake.reshape(-1), consts["obody"].reshape(-1),
                cfg.max_colliders_per_body, torch.maximum,
                float("-inf")).reshape(wake.shape)
        sleep = torch.where(wake > 0, 0, sleep)
        consts = dict(consts, sleep=sleep)
        asleep = _asleep(consts, cfg)
        new_state = dict(new_state, **{
            k: torch.where(asleep, 0.0, new_state[k])
            for k in ("vx", "vy", "om")})
    return new_state, consts, frame


def _solve_counts(nact, Csol: int):
    """``(solve_overflow, solve_dropped)`` of a frame's active-slot counts
    ``nact [Nt, 2, T]``: compaction keeps the closest ``Csol`` active
    manifolds; dropping an imminent one (sep < margin) is the hard
    overflow, dropping a merely margin-active one the soft drop."""
    hard = torch.clamp(nact[:, 1] - Csol, min=0)
    soft = torch.clamp(nact[:, 0] - Csol, min=0) - hard
    return hard.sum(dtype=i32), soft.sum(dtype=i32)


def _exit_tiles(world: World, state: dict, consts: dict, prev: dict,
                body_id, n_frames: int) -> World:
    """Tile-layout state -> canonical World (the inverse of the sort). A
    compound body reads back through its first collider's row (its
    siblings hold the same state); a body with no collider keeps its
    canonical values."""
    b = world.bodies
    M = world.colliders.m
    take = torch.argsort(body_id)  # canonical collider -> tile row
    if b.n != M:
        first = torch.full((b.n,), M, dtype=torch.long,
                           device=take.device).scatter_reduce(
            0, world.colliders.body_idx.long(),
            torch.arange(M, device=take.device), reduce="amin")
        has_row = first < M
        take = take[torch.where(has_row, first, 0)]

        def unsort(x, orig):
            return torch.where(has_row, x.reshape(-1)[take], orig)
    else:

        def unsort(x, orig):
            return x.reshape(-1)[take][:M]

    pos = torch.stack([unsort(state["px"], b.pos[:, 0]),
                       unsort(state["py"], b.pos[:, 1])], dim=-1)
    vel = torch.stack([unsort(state["vx"], b.vel[:, 0]),
                       unsort(state["vy"], b.vel[:, 1])], dim=-1)
    new_bodies = dataclasses.replace(
        b, pos=pos, angle=unsort(state["an"], b.angle), vel=vel,
        ang_vel=unsort(state["om"], b.ang_vel),
        prev_pos=torch.stack([unsort(prev["px"], b.prev_pos[:, 0]),
                              unsort(prev["py"], b.prev_pos[:, 1])], dim=-1),
        prev_angle=unsort(prev["an"], b.prev_angle),
        sleep_count=unsort(consts["sleep"], b.sleep_count))
    return dataclasses.replace(world, bodies=new_bodies,
                               step_count=world.step_count + n_frames)


def touch_keys(touched, pidx, body_id, large_cols, n_colliders: int):
    """Canonical contact-pair keys ``min * M + max`` of the touching slots
    ``[Nt, K, T]`` (``-1`` where not touching), from the slot tables and
    the sort permutation: a dynamic pair appears in both rows with the
    same key."""
    Nt = pidx.shape[0]
    dev = pidx.device
    Mp = body_id.shape[0]
    start = win_start(Nt, dev)
    pl = pidx.long()
    row = start[:, None, None] * T + torch.clamp(pl, max=WIN * T - 1)
    win_col = body_id[torch.clamp(row, 0, Mp - 1)]
    lrg_col = large_cols[torch.clamp(pl - WIN * T, 0, large_cols.shape[0] - 1)]
    partner = torch.where(pl < WIN * T, win_col, lrg_col)
    own_row = (torch.arange(Nt, device=dev)[:, None, None] * T
               + torch.arange(T, device=dev)[None, None, :])
    own = body_id[own_row.expand(pidx.shape)]
    keys = torch.minimum(own, partner) * n_colliders + torch.maximum(
        own, partner)
    return torch.where(touched > 0, keys, -1)


def tiled_step(world: World, cfg: SolverConfig, fuse: bool = True,
               plain: bool = False):
    """One frame via the tile engine. Returns ``(new_world, diag)``. Sorts
    in and out every call: rollouts should use :func:`tiled_rollout`. With
    sleep on, the frame freezes sleepers and updates the sleep counters, on
    the unpartitioned layout (no awake-prefix compaction, as in the JAX
    package). ``fuse=False`` runs the substeps as per-substep project/apply
    launches instead of the whole-frame kernel (on a compound world the
    compound frame's). A compound world's diag adds the HARD
    ``owner_overflow``
    (:func:`_owner_width_overflow`)."""
    _require_slice(world, cfg)
    compound = _compound(world)
    g = world.gravity.to(f32).contiguous()
    state, consts, large, body_id, large_ovf = _enter_tiles(world, cfg)
    prev = {k: state[k] for k in ("px", "py", "an")}
    new_state, consts, frame = _run_frame(state, consts, large, cfg, g,
                                          fuse=fuse, plain=plain,
                                          compound=compound)
    (touched, (count, count_touch, count_close), winover, _wake, pen, pidx,
     pidx_c, act, npts, src, nact, _keyc) = frame
    C = _table_cap(cfg)
    solve_overflow, solve_dropped = _solve_counts(nact, _solve_cap(cfg))
    # undirected counts comparable with the XLA tier's diagnostics: window
    # (dynamic) entries appear in both rows (weight 0.5), large-set ones once
    und_w = torch.where(pidx < WIN * T, 0.5, 1.0)
    und_ws = torch.where(pidx_c < WIN * T, 0.5, 1.0)
    diag = dict(
        slot_count=count,
        slot_overflow=torch.clamp(count_touch - C, min=0).sum(dtype=i32),
        solve_overflow=solve_overflow, solve_dropped=solve_dropped,
        margin_dropped=torch.clamp(count_close - C, min=0).sum(dtype=i32),
        spec_dropped=torch.clamp(count - C, min=0).sum(dtype=i32),
        window_overflow=winover.sum(dtype=i32),
        max_penetration=pen.max(),
        touched=touched, slot_src=src,
        pair_und=(act * und_w).sum(),
        touching_und=((touched > 0) * und_ws).sum(),
        contact_und=npts.sum(),
        large_overflow=large_ovf,
        touch_keys=touch_keys(touched, pidx_c, body_id, large["cols"],
                              world.colliders.m))
    if compound:
        diag["owner_overflow"] = _owner_width_overflow(world, cfg)
    return _exit_tiles(world, new_state, consts, prev, body_id, 1), diag


def _rollout_core(state, consts, large, body_id, gravity, *,
                  cfg: SolverConfig, n_frames: int, fuse: bool, plain: bool,
                  with_events: bool = False, n_colliders: int = 0,
                  compound: bool = False):
    """The tile-layout rollout: the initial table build, then per frame
    the staleness guard, a re-sort + build, a table rebuild or neither,
    and the frame, which a world with nothing awake skips. Returns
    ``(state, consts, body_id, prev_last, counters, keys)``: ``keys
    [n_frames, Nt, Csol, T]`` i32 with ``with_events`` (each frame's
    touching solve slots' event keys, -1 elsewhere and in a skipped
    frame), else None."""
    global host_syncs
    g = gravity
    K = max(cfg.frames_per_broadphase, 1)
    Cs = _table_cap(cfg)
    Csol = _solve_cap(cfg)
    gmag = torch.sqrt(torch.sum(g * g))
    ak = "px" if cfg.tile_sort_axis == "x" else "py"
    sleep_on = cfg.sleep_velocity > 0.0
    # awake-prefix compaction: the re-sorts partition the layout
    compact_on = sleep_on and cfg.tile_awake_compaction

    def build(state, consts, edges):
        """K-frame slot tables + the positional-guard budget."""
        with span("starframe.tables"):
            edge_lo, edge_hi = edges
            (pidx, act, count, count_touch, count_close, winover,
             sweep) = build_tile_tables(
                state, consts, large, edge_lo, edge_hi, g, C=Cs,
                margin=cfg.contact_margin, dt=cfg.dt,
                sort_axis=0 if cfg.tile_sort_axis == "x" else 1,
                sweep_frames=K, sweep_slack=cfg.broadphase_speed_slack,
                sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap,
                plain=plain)
            pos0 = {"px": state["px"], "py": state["py"]}
            if sleep_on:
                # sleepers are frozen, so they need no settle-jitter floor; a
                # woken body on this tight budget escapes its guard within a
                # frame or two, forcing the re-sort that brings it into the
                # awake prefix before it can push deep into untabled neighbours
                sweep = torch.where(_asleep(consts, cfg), 0.1 * consts["ext"],
                                    sweep)
            counts = torch.stack([
                torch.clamp(count_touch - Cs, min=0).sum(dtype=i32),
                torch.clamp(count_close - Cs, min=0).sum(dtype=i32),
                torch.clamp(count - Cs, min=0).sum(dtype=i32),
                # the completeness counter covers the live partition only
                (winover * (consts["kept"] > 0)).sum(dtype=i32)])
            return (pidx, act), pos0, sweep, counts

    with span("starframe.setup"):
        el, eh, _ = _edge_rows(state, consts, cfg)
    tables, pos0, sweep, build_max = build(state, consts, (el, eh))
    # solve_overflow, solve_dropped; the frames reuse the build's tables,
    # so the builds alone count window_overflow
    frame_max = torch.zeros(2, dtype=i32, device=g.device)
    age = 1 % K
    resorts = rebuilds = 0
    prev = None
    keys = None
    if with_events:  # one table a frame, written in place by each frame
        keys = torch.full((n_frames, state["px"].shape[0], Csol, T), -1,
                          dtype=i32, device=g.device)
        no_key = torch.full((), -1, dtype=i32, device=g.device)
    # the verdicts are read on the host with K > 1 or sleep on; at K = 1
    # without sleep nothing is read and the edges are the frame's alone
    reads = K > 1 or sleep_on
    for f in range(n_frames):
        with span("starframe.guard") if reads else NULL:
            el, eh, stale = _edge_rows(state, consts, cfg)
            # the frame's verdicts, read in one host sync: the guard's (with
            # K > 1), and with sleep on whether any moving row is awake and
            # (compaction) whether the layout is partitioned or wants to be
            verdicts = [stale]
            if K > 1:
                # positional staleness guard: a live row whose displacement
                # since the build plus its coming frame motion escapes its
                # sweep budget forces a table rebuild; the scheduled re-sort
                # waits until some live row has used half its budget (drift)
                disp = torch.maximum(torch.abs(state["px"] - pos0["px"]),
                                     torch.abs(state["py"] - pos0["py"]))
                motion = (torch.sqrt(state["vx"] * state["vx"]
                                     + state["vy"] * state["vy"])
                          + gmag * cfg.dt) * cfg.dt
                livb = (consts["mov"] > 0) & (consts["act"] > 0)
                used = disp + motion
                verdicts += [torch.any((used > sweep + 1e-5) & livb),
                             torch.any((used > 0.5 * sweep) & livb)]
            if sleep_on:
                mova = (consts["mov"] > 0) & (consts["act"] > 0)
                asleep = _asleep(consts, cfg)
                verdicts.append(torch.any(mova & ~asleep))
                if compact_on:
                    partitioned_t = torch.any(mova & (consts["kept"] == 0))
                    # an unpartitioned layout with a sleeping mass compacts
                    # at the next scheduled slot even without drift
                    verdicts += [partitioned_t,
                                 torch.any(asleep & mova) & ~partitioned_t]
            if reads:
                read = torch.stack(verdicts).tolist()
                host_syncs += 1
            else:
                read = [True]  # K = 1 re-sorts every frame: nothing to read
        stale = read.pop(0)
        esc, drift = (read.pop(0), read.pop(0)) if K > 1 else (False, True)
        awake = read.pop(0) if sleep_on else True
        partitioned, want_part = read if compact_on else (False, False)
        # a world with nothing awake keeps a valid sort: no scheduled
        # re-sort (the guard still forces one); while partitioned, a budget
        # escape forces a full re-sort, since the partitioned windows hide
        # tail sleepers the escapee may now reach
        do_sort = ((age == 0 and awake and (drift or want_part)) or stale
                   or (esc and partitioned))
        if do_sort:
            with span("starframe.sort"):
                if compact_on:
                    state, consts, body_id = _compact_resort(
                        state, consts, body_id, cfg, g, ak,
                        compound=compound)
                else:
                    state, consts, body_id = _resort(state, consts, body_id,
                                                     ak)
                    consts["kept"] = torch.ones_like(consts["kept"])
                el, eh, _ = _edge_rows(state, consts, cfg)
        if do_sort or esc:
            tables, pos0, sweep, counts = build(state, consts, (el, eh))
            build_max = torch.maximum(build_max, counts)
        prev = {k: state[k] for k in ("px", "py", "an")}
        if awake:  # a world with nothing awake launches nothing
            with span("starframe.frame"):
                # each row's and large slot's canonical collider id, through
                # the current sort, for K6's event keys
                ev = ((body_id.reshape(-1, T), large["cols"]) if with_events
                      else None)
                state, consts, frame = _run_frame(
                    state, consts, large, cfg, g, tables=tables,
                    edges=(el, eh), fuse=fuse, plain=plain, event_ids=ev,
                    n_colliders=n_colliders, compound=compound)
                frame_max = torch.maximum(frame_max, torch.stack(
                    _solve_counts(frame[10], Csol)))
                if with_events:
                    torch.where(frame[0] > 0, frame[11], no_key, out=keys[f])
        resorts += int(do_sort and age != 0)
        rebuilds += int(esc and not do_sort)
        age = (1 if do_sort else age + 1) % K
    if prev is None:
        prev = {k: state[k] for k in ("px", "py", "an")}
    zero = torch.zeros((), dtype=i32, device=g.device)
    counters = dict(
        slot_overflow=build_max[0], solve_overflow=frame_max[0],
        solve_dropped=frame_max[1], margin_dropped=build_max[1],
        spec_dropped=build_max[2], window_overflow=build_max[3],
        joint_shard_overflow=zero,
        forced_resorts=torch.tensor(resorts, dtype=i32, device=g.device),
        forced_rebuilds=torch.tensor(rebuilds, dtype=i32, device=g.device),
        # moving rows in the sleeping tail of the final layout (0: the
        # layout is not partitioned)
        compacted_rows=((consts["mov"] > 0) & (consts["act"] > 0)
                        & (consts["kept"] == 0)).sum(dtype=i32))
    return state, consts, body_id, prev, counters, keys


def tiled_rollout(world: World, cfg: SolverConfig, n_frames: int,
                  fuse: bool = True, plain: bool = False,
                  with_events: bool = False):
    """N frames with the state kept in tile layout (one sort in, one sort
    out). Returns ``(final_world, diag)`` with the JAX package's scalar
    counters: ``slot_overflow`` (HARD: touching candidates truncated at a
    table build), ``solve_overflow`` (HARD: an imminent manifold compacted
    out of the solve slots), ``solve_dropped``, ``margin_dropped``,
    ``spec_dropped`` (soft: candidates deferred to a later build or frame),
    ``window_overflow`` (rows of the live partition whose margin box escaped
    the window's coverage), ``forced_resorts``, ``forced_rebuilds``,
    ``compacted_rows`` (moving rows in the final layout's sleeping tail),
    ``large_overflow``; ``joint_shard_overflow`` is 0 on this slice. A
    compound world adds the HARD ``owner_overflow``
    (:func:`_owner_width_overflow`).

    ``fuse=False`` runs the substeps as per-substep project/apply launches
    instead of the whole-frame kernel (on a compound world the compound
    frame, which runs the owner reductions between its phases);
    ``plain=True`` runs
    the kernels' twins. ``with_events=True`` returns ``(final_world, diag,
    keys)``, ``keys [n_frames, Nt, Csol, T]`` i32 on the world's device:
    each frame's touching solve slots' contact-event keys ``min(a, b) *
    M + max(a, b)`` of their collider ids (-1 elsewhere and in a frame
    skipped because nothing is awake; a dynamic pair appears in both rows,
    and a compound pair once per touching collider pair); see
    ``events.py``. With sleep on (``cfg.sleep_velocity > 0``) the keys
    cover the awake set only: a touching pair whose rows both sleep gives
    -1 (both bodies are frozen for the frame, so the pair's contact
    solves nothing, and a tile whose window sleeps runs nothing), as in the
    JAX package's tile engine; its XLA tier also reports sleeping pairs.
    ``cfg.ccd`` clamps bullet bodies' advance at their time of impact (see
    the module's docstring)."""
    with span("starframe.rollout"):
        _require_slice(world, cfg)
        compound = _compound(world)
        if with_events:
            check_event_keys(world.colliders.m)
        g = world.gravity.to(f32).contiguous()
        with span("starframe.setup"):
            state, consts, large, body_id, large_ovf = _enter_tiles(world,
                                                                    cfg)
        state, consts, body_id, prev, counters, keys = _rollout_core(
            state, consts, large, body_id, g, cfg=cfg, n_frames=n_frames,
            fuse=fuse, plain=plain, with_events=with_events,
            n_colliders=world.colliders.m, compound=compound)
        with span("starframe.exit"):
            final = _exit_tiles(world, state, consts, prev, body_id,
                                n_frames)
        diag = dict(counters, large_overflow=large_ovf)
        if compound:
            diag["owner_overflow"] = _owner_width_overflow(world, cfg)
        return (final, diag, keys) if with_events else (final, diag)
