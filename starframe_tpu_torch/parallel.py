"""Batched worlds: a leading world axis through the slot-table kernels.

The PyTorch counterpart of the batched half of ``starframe_tpu/parallel.py``
(``frame2_*``, ``collider_owner_tables``, ``batched_step``,
``batched_step_events``, ``batched_rollout``). Thousands of independent
worlds (BASELINE.json:11 — 4096 x 256-body worlds on one chip) step
together: the slot-table broadphase (``hopper/slots.py``) builds each
dynamic collider's partner slots and each body's joint slots, and the frame
kernel (``hopper/frame2.py``) runs the whole frame, joints included. Every
function takes ``plain=False``; ``plain=True`` runs the kernels' plain
PyTorch twins even on a card (for timing against the kernels), as the JAX
package's ``interpret=True`` runs Pallas in interpret mode. What a call's
frames share is built once a call (:func:`frame2_inputs`, passed as
``inputs=``); a frame derives its body planes alone.

The frame kernel runs every configuration of the reference's: CCD
(``cfg.ccd``, bodies flagged ``bullet=True``: each substep clamps a
bullet's advance at its time of impact against the frame's manifolds),
per-frame solve-slot compaction (``cfg.batch_solve_capacity``), per-world
collider-owner tables (``cfg.batch_uniform_topology=False``) and sleep
(``cfg.sleep_velocity > 0``: sleepers frozen for the frame, the counters
and the wake updated after it). A batch past the kernels' bounds raises
``NotImplementedError``: the single-world ``vmap(step)`` tier the JAX
package falls back to is ROADMAP.md A3.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from .config import SolverConfig
from .events import touching_keys_from_slots
from .hopper.frame2 import (
    Frame2Inputs,
    frame2_table_rows,
    kernel_verts,
    owner_csr,
    owner_csr_tables,
    run_frame2,
)
from .hopper.slots import build_elig_mask, build_joint_slots, build_slot_tables
from .spans import span
from .state import (
    BODY_BULLET,
    BODY_KINEMATIC,
    COL_ACTIVE,
    COL_SENSOR,
    JOINT_OFF,
    World,
    map_world,
)
from .step import joint_slow_closure, joint_wake_closure

# joints per world the kernels take (the JAX package's bound as well)
MAX_JOINTS = 1024


def replicate_world(world: World, n: int) -> World:
    """Broadcast one world into an ``n``-way batch (contiguous copies)."""
    return map_world(
        lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(), world)


def stack_worlds(worlds) -> World:
    """Stack single worlds of one capacity into a batch (``[W, ...]``),
    each world keeping its own arrays (its own topology too)."""
    def each(objs):
        return dataclasses.replace(objs[0], **{
            f.name: torch.stack([getattr(o, f.name) for o in objs])
            for f in dataclasses.fields(objs[0])})

    return World(
        bodies=each([w.bodies for w in worlds]),
        colliders=each([w.colliders for w in worlds]),
        joints=each([w.joints for w in worlds]),
        gravity=torch.stack([w.gravity for w in worlds]),
        step_count=torch.stack([w.step_count for w in worlds]))


def frame2_shapes_ok(worlds: World, cfg: SolverConfig) -> bool:
    """Shape/config half of the slot-kernel decision. The CUDA kernels run
    one block of 256 threads per world with the world's bodies, colliders
    and joint parameters in shared memory, so the capacities are bounded
    (N, M, J <= 1024, and the frame kernel's world state within an H100's
    shared memory: :func:`hopper.frame2_table_rows` places the slot table
    beside it, in global memory for the rows that do not fit); the TPU's
    128-lane and sublane-block rules do not apply."""
    if cfg.use_pallas is False:
        return False
    if cfg.ccd and cfg.manifold_refresh != "frame":
        return False
    n, m, j = worlds.bodies.n, worlds.colliders.m, worlds.joints.j
    v = worlds.colliders.max_verts
    csol = _batch_solve_cap(cfg) or cfg.slot_capacity
    rows = frame2_table_rows(n, m, kernel_verts(v) or v, j, csol)
    return (n <= 1024 and m <= 1024 and j <= MAX_JOINTS
            and rows is not None)


def _require_slice(worlds: World, cfg: SolverConfig) -> None:
    """Raise on what the port does not run yet (never fall through)."""
    if not frame2_shapes_ok(worlds, cfg):
        raise NotImplementedError(
            "this batch or config is not eligible for the slot kernels "
            f"(N = {worlds.bodies.n}, M = {worlds.colliders.m}, "
            f"J = {worlds.joints.j}) and the single-world vmap(step) tier "
            "is not ported yet (ROADMAP.md A3)")


def _asleep(bodies, cfg: SolverConfig):
    """Bodies asleep under ``cfg``: the counter run out, dynamic."""
    return (bodies.sleep_count >= cfg.sleep_frames) & (bodies.inv_mass > 0)


def _elig_args(worlds: World, kin: torch.Tensor) -> tuple:
    """K1's arguments (``hopper.build_elig_mask``): the colliders' body,
    layer, mask, ``active`` and ``sensor`` flags, the bodies' ``responds``
    (a finite mass or inertia) and ``moves`` (that or kinematic: ``kin``
    ``[W, N]``); flags f32 0 or 1."""
    b, c = worlds.bodies, worlds.colliders
    responds = ((b.inv_mass > 0) | (b.inv_inertia > 0)).to(torch.float32)
    return (c.body_idx, c.layer, c.mask, _flag(c, COL_ACTIVE),
            _flag(c, COL_SENSOR), responds, torch.maximum(responds, kin))


def _slot_rows(elig: tuple) -> torch.Tensor:
    """K1's row rule on its arguments ``elig`` (:func:`_elig_args`): ``[W,
    M]`` f32, 1 where collider i's row may hold a slot (active, and its body
    responds or it is a sensor on a moving body). K2's tables hold no slot
    elsewhere."""
    cbody, _, _, active, sensor, responds, moves = elig
    cb = cbody.long()
    return active * torch.maximum(torch.gather(responds, 1, cb),
                                  sensor * torch.gather(moves, 1, cb))


def _flag(objs, bit: int) -> torch.Tensor:
    """Where ``objs.flags`` has ``bit``, f32 0 or 1."""
    return ((objs.flags & bit) != 0).to(torch.float32)


def _vert_planes(worlds: World) -> tuple:
    """The collider vertices as planes ``(vlx, vly)``, each ``[W, V, M]``."""
    v = worlds.colliders.verts
    return (v[..., 0].transpose(-1, -2).contiguous(),
            v[..., 1].transpose(-1, -2).contiguous())


@dataclasses.dataclass(frozen=True, eq=False)
class BatchInputs:
    """What the frames of one call share (:func:`frame2_inputs`): the frame
    kernel's inputs ``k4``, K1's arguments ``elig``, the HARD counters
    topology fixes (int32 device scalars) and a device ``zero`` for the
    counters of forms that do not run."""

    k4: Frame2Inputs
    elig: tuple
    owner_overflow: torch.Tensor
    joint_overflow: torch.Tensor
    zero: torch.Tensor


def frame2_inputs(worlds: World, cfg: SolverConfig,
                  plain: bool = False) -> BatchInputs:
    """What the frames of one call on ``worlds`` share: flags, topology and
    shapes, which nothing in a call changes (motors a caller rewrites
    between calls come with the next call). Raises on a batch past the
    kernels' bounds."""
    _require_slice(worlds, cfg)
    b, c = worlds.bodies, worlds.colliders
    kin = _flag(b, BODY_KINEMATIC)
    elig = _elig_args(worlds, kin)  # its sensor flags (elig[4]) are K4's
    sleep = cfg.sleep_velocity > 0.0  # the masses are each frame's
    owners, owner_overflow = frame2_owners(worlds, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=b.pos.device)
    joints, joint_overflow = None, zero
    if worlds.joints.j > 0:
        with span("starframe.joints"):
            joints, joint_overflow = _joint_inputs(worlds, cfg, plain)
    vlx, vly = _vert_planes(worlds)
    k4 = Frame2Inputs(
        cbody=c.body_idx, vlx=vlx, vly=vly, nverts=c.nverts, radius=c.radius,
        fric=c.friction, rest=c.restitution, sensor=elig[4],
        slot_rows=_slot_rows(elig), kin=kin,
        invm=None if sleep else b.inv_mass,
        invi=None if sleep else b.inv_inertia,
        dyn=None if sleep else (b.inv_mass > 0).to(torch.float32),
        gravity=worlds.gravity.expand(b.pos.shape[0], 2).contiguous(),
        owners=owners,
        C=cfg.slot_capacity, substeps=cfg.substeps,
        iterations=cfg.iterations, h=cfg.dt / cfg.substeps, dt=cfg.dt,
        margin=cfg.contact_margin, compliance=cfg.contact_compliance,
        relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
        rest_threshold=cfg.restitution_threshold,
        lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
        joints=joints, JC=cfg.joint_slot_capacity,
        joint_solver=cfg.joint_solver, n_colors=cfg.max_joint_colors,
        # joints are constraint upkeep: the raw clip, not max_dpos_eff
        max_dpos_joint=cfg.max_dpos,
        bullet=_flag(b, BODY_BULLET) if cfg.ccd else None,
        ccd=cfg.ccd, ccd_slop=cfg.ccd_slop, Cs=_batch_solve_cap(cfg))
    return BatchInputs(k4, elig, owner_overflow, joint_overflow, zero)


def frame2_planes(worlds: World, cfg: SolverConfig):
    """What a frame changes: ``(planes, masses)``, the body planes ``(posx,
    posy, ang, velx, vely, angvel)`` and under sleep the frame's ``(invm,
    invi, dyn)``, the sleepers' zeroed (awake partners solve against them
    as static; K1 keeps their slots and rows, to wake), else None."""
    b = worlds.bodies
    posx, posy = b.pos.movedim(-1, 0).contiguous()
    velx, vely = b.vel.movedim(-1, 0).contiguous()
    planes = (posx, posy, b.angle, velx, vely, b.ang_vel)
    if cfg.sleep_velocity <= 0.0:
        return planes, None
    awake = 1.0 - _asleep(b, cfg).to(torch.float32)
    invm, invi = b.inv_mass * awake, b.inv_inertia * awake
    return planes, (invm, invi, (invm > 0).to(torch.float32))


def _gmag(worlds: World) -> torch.Tensor:
    """Per-world gravity magnitude ``[W, 1]``."""
    g = worlds.gravity.expand(worlds.bodies.pos.shape[0], 2)
    return torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))


def _sweep_bounds(worlds: World, cfg: SolverConfig, K: int) -> torch.Tensor:
    """Per-body speed bound ``|v| + |g| * K * dt`` the K-frame slot tables
    are valid for ``[W, N]`` (magnitude-based: contact impulses rotate
    velocity between components), with the budget headroom on dynamic
    bodies."""
    b = worlds.bodies
    dyn = (b.inv_mass > 0).to(torch.float32)
    speed = torch.sqrt(torch.sum(b.vel ** 2, dim=-1))
    bound = speed + (_gmag(worlds) * (K * cfg.dt)
                     + cfg.broadphase_speed_slack) * dyn
    return bound * (1.0 + (cfg.broadphase_budget_headroom - 1.0) * dyn)


def frame2_elig(worlds: World, cfg: SolverConfig, plain: bool = False,
                inputs: BatchInputs | None = None):
    """Static pair-eligibility mask ``[W, M, M] i8`` for table builds —
    constant across a rollout, so rollouts build it once (from ``inputs``,
    as :func:`frame2_step`'s)."""
    args = (inputs.elig if inputs is not None
            else _elig_args(worlds, _flag(worlds.bodies, BODY_KINEMATIC)))
    return build_elig_mask(*args, plain=plain)


def frame2_tables(worlds: World, cfg: SolverConfig, frames: int = 1,
                  return_budget: bool = False, elig=None,
                  plain: bool = False, inputs: BatchInputs | None = None):
    """Slot-table broadphase for a world batch. With ``frames > 1`` the
    swept boxes stay a valid candidate superset for that many frames (a
    symmetric positional budget from :func:`_sweep_bounds`, inflated per
    collider to the max over its phase-1 partners). Returns ``(partner,
    slot_act, count, count_touch, count_close)``; with
    ``return_budget=True``, ``(tables, budget [W, M])``; ``inputs`` as
    :func:`frame2_step`'s."""
    if elig is None:
        elig = frame2_elig(worlds, cfg, plain=plain, inputs=inputs)
    vlx, vly = ((inputs.k4.vlx, inputs.k4.vly) if inputs is not None
                else _vert_planes(worlds))
    b, c = worlds.bodies, worlds.colliders
    posx, posy = b.pos.movedim(-1, 0).contiguous()
    if frames > 1:
        vx, vy = _sweep_bounds(worlds, cfg, frames), None
    else:
        vx, vy = b.vel.movedim(-1, 0).contiguous()
    *tables, budget = build_slot_tables(
        posx, posy, b.angle, vx, vy, c.body_idx, vlx, vly, c.radius, elig,
        C=cfg.slot_capacity, margin=cfg.contact_margin,
        dt=cfg.dt * frames, partner_aware=frames > 1, plain=plain)
    tables = tuple(tables)
    return (tables, budget) if return_budget else tables


def frame2_joint_slots(worlds: World, cfg: SolverConfig,
                       plain: bool = False):
    """Per-body joint slots ``(jslot, jside, jact [W, JC, N], count [W,
    N])`` with ``JC = cfg.joint_slot_capacity`` -- constant while the joint
    topology is, so rollouts build them once."""
    j = worlds.joints
    return build_joint_slots(
        j.body_a, j.body_b, (j.jtype != JOINT_OFF).to(torch.float32),
        worlds.bodies.n, JC=cfg.joint_slot_capacity, plain=plain)


def _joint_inputs(worlds: World, cfg: SolverConfig, plain: bool):
    """K4's joint dict (``hopper.Frame2Inputs.joints``; K3 builds its slots)
    and the HARD ``joint_overflow``: joints dropped past the bodies' slots."""
    j = worlds.joints
    jslot, jside, jact, jcount = frame2_joint_slots(worlds, cfg, plain=plain)
    overflow = torch.clamp(jcount - cfg.joint_slot_capacity, min=0).sum(
        dtype=torch.int32)
    joints = dict(
        jtype=j.jtype, jba=j.body_a, jbb=j.body_b,
        jaax=j.anchor_a[..., 0].contiguous(),
        jaay=j.anchor_a[..., 1].contiguous(),
        jabx=j.anchor_b[..., 0].contiguous(),
        jaby=j.anchor_b[..., 1].contiguous(),
        jrest=j.rest, jlo=j.lo, jhi=j.hi, jcomp=j.compliance,
        jdamp=j.damping, jms=j.motor_speed,
        jmm=torch.nan_to_num(j.motor_max, posinf=3.4e38), jcolor=j.color,
        jslot=jslot, jside=jside, jact=jact)
    return joints, overflow


def collider_owner_tables(worlds: World, cfg: SolverConfig):
    """Per-world collider-owner tables (``parallel.py:176-212``): each
    body's active colliders, ascending (a stable sort), at most ``Kc =
    cfg.max_colliders_per_body`` of them. Returns ``(bcol [W, Kc, N] i32,
    bmask [W, Kc, N] f32, owner_overflow)``: ``bcol[w, k, n]`` is body n's
    k-th collider where ``bmask`` is 1. ``owner_overflow`` (HARD) counts
    the colliders past Kc, whose corrections would be dropped. Topology is
    constant across a rollout, so rollouts build them once."""
    kc = cfg.max_colliders_per_body
    cb = worlds.colliders.body_idx
    active = (worlds.colliders.flags & COL_ACTIVE) != 0
    W, M = cb.shape
    N = worlds.bodies.n
    dev = cb.device
    # inactive colliders sort past every body id and never enter a table
    key = torch.where(active, cb, N).to(torch.int32)
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, 1, order).contiguous()
    ids = torch.arange(N, dtype=torch.int32, device=dev).expand(W, N)
    start = torch.searchsorted(skey, ids.contiguous())
    cnt = torch.searchsorted(skey, ids.contiguous(), right=True) - start
    pos = start[:, None, :] + torch.arange(kc, device=dev)[None, :, None]
    bcol = torch.gather(order, 1, torch.clamp(pos, 0, M - 1).reshape(W, -1))
    bcol = bcol.reshape(W, kc, N).to(torch.int32)
    bmask = (torch.arange(kc, device=dev)[None, :, None]
             < cnt[:, None, :]).to(torch.float32)
    owner_overflow = torch.clamp(cnt - kc, min=0).sum(dtype=torch.int32)
    return bcol, bmask, owner_overflow


def frame2_owners(worlds: World, cfg: SolverConfig):
    """The frame kernel's collider -> body lists and the HARD
    ``owner_overflow``: world 0's for the whole batch under
    ``cfg.batch_uniform_topology`` (0 overflow; a collider is listed when
    it is active in any world), else each world's active colliders, from
    :func:`collider_owner_tables`."""
    cb = worlds.colliders.body_idx
    if cfg.batch_uniform_topology:
        zero = torch.zeros((), dtype=torch.int32, device=cb.device)
        return (owner_csr(cb[0], worlds.bodies.n,
                          worlds.colliders.active.any(0)), zero)
    bcol, bmask, overflow = collider_owner_tables(worlds, cfg)
    return owner_csr_tables(bcol, bmask, worlds.colliders.m), overflow


def _batch_solve_cap(cfg: SolverConfig) -> int:
    """Solve-slot width of the frame kernel: 0 (compaction off) unless
    ``0 < cfg.batch_solve_capacity < cfg.slot_capacity``."""
    if not 0 < cfg.batch_solve_capacity < cfg.slot_capacity:
        return 0
    return cfg.batch_solve_capacity


def _sleep_update(worlds: World, cfg: SolverConfig, vel, angvel, touched,
                  partner):
    """The batched sleep glue after a frame (``parallel.py:362-405``, with
    its counter repaired): ``slow`` closed over joints, the counter
    ``where(slow, c + 1, 0)``, the wake from ``touched`` and the partner's
    speed closed over joints, the reset, and asleep velocities zeroed. A
    touching dynamic partner at ``sleep_velocity * wake_velocity_factor``
    or faster wakes a row's body, and so does a touching kinematic one at
    ``sleep_velocity`` or faster (the tile engine's rule). Returns
    ``(sleep_count, vel, angvel)``."""
    b, j = worlds.bodies, worlds.joints
    spd2 = torch.sum(vel * vel, dim=-1) + angvel * angvel
    slow = spd2 < cfg.sleep_velocity ** 2
    if j.j > 0:
        slow = joint_slow_closure(slow, j.body_a, j.body_b, j.active)
    count = torch.where(slow, b.sleep_count + 1, 0)
    kin = (b.flags & BODY_KINEMATIC) != 0
    fast = (((b.inv_mass > 0)
             & (spd2 >= (cfg.sleep_velocity * cfg.wake_velocity_factor) ** 2))
            | (kin & (spd2 >= cfg.sleep_velocity ** 2)))
    W, Cp, M = touched.shape
    cb = worlds.colliders.body_idx.long()
    pb = torch.gather(cb, 1, partner.reshape(W, -1).long())
    fast_p = torch.gather(fast, 1, pb).reshape(W, Cp, M)
    wake_rows = ((touched > 0) & fast_p).any(dim=1).to(torch.int32)
    wake = torch.zeros_like(count, dtype=torch.int32).scatter_reduce(
        1, cb, wake_rows, reduce="amax", include_self=True) > 0
    if j.j > 0:
        wake = joint_wake_closure(wake, j.body_a, j.body_b, j.active)
    count = torch.where(wake, 0, count).to(b.sleep_count.dtype)
    asleep = (count >= cfg.sleep_frames) & (b.inv_mass > 0)
    vel = torch.where(asleep[..., None], 0.0, vel)
    angvel = torch.where(asleep, 0.0, angvel)
    return count, vel, angvel


def frame2_step(worlds: World, cfg: SolverConfig, tables=None,
                inputs: BatchInputs | None = None, plain: bool = False):
    """One batched frame through the slot kernels. Returns ``(new_worlds,
    touched [W, Cp, M], partner [W, Cp, M], (count, count_touch,
    count_close), aux)``: ``Cp`` is the solve width (``cfg.
    batch_solve_capacity`` when it compacts, else C) and ``partner`` the
    table ``touched`` indexes. ``aux`` holds the scalar counters:
    ``joint_overflow`` (HARD: joints past a body's
    ``cfg.joint_slot_capacity`` slots), ``owner_overflow`` (HARD: colliders
    past ``cfg.max_colliders_per_body`` with per-world owner tables),
    ``solve_overflow`` (HARD: imminent slots, ``sep < contact_margin``,
    dropped by compaction) and ``solve_dropped`` (soft: speculative ones
    dropped). Pass ``tables`` (from :func:`frame2_tables`) to reuse a
    broadphase and ``inputs`` (from :func:`frame2_inputs` on this batch's
    flags and topology) to reuse what the frames of a call share."""
    with span("starframe.frame"):
        if inputs is None:
            inputs = frame2_inputs(worlds, cfg, plain=plain)
        if tables is None:
            tables = frame2_tables(worlds, cfg, plain=plain, inputs=inputs)
        partner, slot_act, count, count_touch, count_close = tables
        planes, masses = frame2_planes(worlds, cfg)
        k4 = inputs.k4
        outs = run_frame2(*planes, partner, slot_act, k4, masses=masses,
                          plain=plain)
        posx, posy, ang, velx, vely, angvel, touched = outs[:7]
        solve_overflow = solve_dropped = inputs.zero
        if k4.compact:
            # `partner` downstream (wake rows, event keys) is the table
            # `touched` indexes; the counts give the solve counters
            partner, nact = outs[7], outs[8]
            solve_overflow = torch.clamp(nact[:, 0] - k4.Cs, min=0).sum().to(
                torch.int32)
            solve_dropped = torch.clamp(nact[:, 1] - k4.Cs, min=0).sum().to(
                torch.int32) - solve_overflow
        b = worlds.bodies
        vel = torch.stack([velx, vely], dim=-1)
        sleep_count = b.sleep_count
        if cfg.sleep_velocity > 0.0:
            sleep_count, vel, angvel = _sleep_update(
                worlds, cfg, vel, angvel, touched, partner)
        new_bodies = dataclasses.replace(
            b, pos=torch.stack([posx, posy], dim=-1), angle=ang, vel=vel,
            ang_vel=angvel, prev_pos=b.pos, prev_angle=b.angle,
            sleep_count=sleep_count)
        new_worlds = dataclasses.replace(
            worlds, bodies=new_bodies, step_count=worlds.step_count + 1)
        aux = dict(joint_overflow=inputs.joint_overflow,
                   owner_overflow=inputs.owner_overflow,
                   solve_overflow=solve_overflow, solve_dropped=solve_dropped)
        counts = (count, count_touch, count_close)
        return new_worlds, touched, partner, counts, aux


def _frame_diag(C, counts):
    """Per-frame ``(hard, margin, spec)`` row-overflow amounts (device
    scalars; <= 0 means nothing was dropped)."""
    count, count_touch, count_close = counts
    return (count_touch.max() - C, count_close.max() - C, count.max() - C)


def _step_diag(C, counts, aux):
    """A frame's diag: the table counters floored at 0, and ``aux``."""
    hard, marg, spec = _frame_diag(C, counts)
    zero = torch.zeros((), dtype=torch.int32, device=hard.device)
    return dict(slot_overflow=hard.clamp(min=0),
                margin_dropped=marg.clamp(min=0),
                spec_dropped=spec.clamp(min=0), forced_rebuilds=zero, **aux)


def batched_step(worlds: World, cfg: SolverConfig, max_pairs: int,
                 with_diag: bool = False, plain: bool = False):
    """Frame step over the leading world axis through the slot kernels.
    With ``with_diag=True`` returns ``(worlds, diag)`` with the rollout's
    counter keys (see :func:`batched_rollout`)."""
    w2, _, _, counts, aux = frame2_step(worlds, cfg, plain=plain)
    if not with_diag:
        return w2
    return w2, _step_diag(cfg.slot_capacity, counts, aux)


def batched_step_events(worlds: World, cfg: SolverConfig, tables=None,
                        plain: bool = False):
    """A batched step that also returns the frame's canonical contact-pair
    keys (``parallel.py:419-442``): ``(new_worlds, keys [W, Cp, M] i32,
    diag)``, a key ``min * M + max`` of the two colliders where a slot
    touched this frame and -1 elsewhere (diff two frames' keys with
    ``events.key_event_masks``); ``diag`` as :func:`batched_step`'s."""
    w2, touched, partner, counts, aux = frame2_step(worlds, cfg,
                                                    tables=tables, plain=plain)
    keys = touching_keys_from_slots(touched, partner, worlds.colliders.m)
    return w2, keys, _step_diag(cfg.slot_capacity, counts, aux)


def _stack_records(records):
    """Stack per-frame records (a tensor, a tuple of tensors, or None)."""
    first = records[0]
    if first is None or first == ():
        return first
    if isinstance(first, torch.Tensor):
        return torch.stack(records)
    return type(first)(_stack_records([r[k] for r in records])
                       for k in range(len(first)))


def batched_rollout(worlds: World, cfg: SolverConfig, max_pairs: int,
                    n_frames: int, record=None, plain: bool = False,
                    with_keys: bool = False):
    """N-frame rollout of a world batch. ``record(worlds)`` picks what to
    keep per frame (default: poses), stacked on a leading frame axis; with
    ``with_keys=True`` each frame's entry is ``(record(w), keys [W, Cp, M]
    i32)``, the frame's contact-pair keys (:func:`batched_step_events`).

    Returns ``(final, traj, diag)``; ``diag`` carries the rollout's
    counters as device scalars, one key set on every path:

    - ``slot_overflow``: max over frames of ``max(count_touch) - C``,
      floored at 0 (> 0: a TOUCHING contact went unsolved — the hard case);
    - ``margin_dropped`` / ``spec_dropped``: the same for margin-close and
      swept-speculative candidates (bounded staleness: a dropped
      not-yet-touching pair re-enters at the next rebuild);
    - ``joint_overflow``: max over frames of the joints dropped past the
      bodies' ``cfg.joint_slot_capacity`` slots (hard: a joint went
      unsolved);
    - ``solve_overflow`` / ``solve_dropped``: max over frames of the
      imminent (hard) and speculative (soft) slots that solve-slot
      compaction dropped (0 without it);
    - ``owner_overflow``: colliders past ``cfg.max_colliders_per_body``
      with per-world owner tables (hard; 0 with a uniform topology);
    - ``forced_rebuilds``: table rebuilds forced by the staleness guard.

    With ``cfg.frames_per_broadphase = K > 1`` the tables are rebuilt every
    K-th frame with K-frame-inflated, partner-aware sweeps, and a per-frame
    POSITIONAL guard forces an early rebuild when a dynamic body's
    displacement since the build plus the coming frame's motion exceeds
    its sweep budget. The guard's verdict is read on the host: one host
    round trip per frame that is not already a scheduled rebuild (its
    ``starframe.guard`` span). K = 1 builds fresh tables every frame with
    no guard and no round trip. Under a ``torch.profiler`` the call
    records its ``starframe.*`` spans (:mod:`.spans`).
    """
    with span("starframe.rollout"):
        if record is None:
            record = lambda w: (w.bodies.pos, w.bodies.angle)  # noqa: E731
        C = cfg.slot_capacity
        K = max(cfg.frames_per_broadphase, 1)
        M = worlds.colliders.m
        dev = worlds.bodies.pos.device
        # INVARIANT: flags, topology and shapes, so the eligibility mask,
        # the collider -> body owner lists, the joint slots and the frame
        # kernel's other inputs, are what nothing inside a rollout changes:
        # built once
        with span("starframe.setup"):
            inputs = frame2_inputs(worlds, cfg, plain=plain)
            elig = frame2_elig(worlds, cfg, plain=plain, inputs=inputs)
        neg = torch.tensor(-(2 ** 31), dtype=torch.int32, device=dev)
        ovf = marg = spec = neg
        rebuilds = 0
        jovf = sovf = sdrp = inputs.zero

        def build(w):
            # per-body position budget: the min over the body's active
            # colliders of the inflation each collider's tables were built
            # with
            with span("starframe.tables"):
                tables, budget_col = frame2_tables(
                    w, cfg, frames=K, return_budget=True, elig=elig,
                    plain=plain, inputs=inputs)
                act = (w.colliders.flags & COL_ACTIVE) != 0
                bc = torch.where(act, budget_col, 3.0e38)
                budget = torch.full(w.bodies.inv_mass.shape, 3.0e38,
                                    dtype=torch.float32, device=dev)
                budget = budget.scatter_reduce(
                    1, w.colliders.body_idx.long(), bc, reduce="amin",
                    include_self=True)
            return tables, w.bodies.pos, budget

        w = worlds
        traj = []
        if K > 1:
            tables, pos0, sweep = build(w)
            age = 1 % K
        for _ in range(n_frames):
            if K == 1:
                with span("starframe.tables"):
                    tables = frame2_tables(w, cfg, frames=1, elig=elig,
                                           plain=plain, inputs=inputs)
            else:
                viol = False
                if age != 0:
                    with span("starframe.guard"):
                        b = w.bodies
                        # positional staleness guard: each dynamic body must
                        # stay inside its build-time swept box through the
                        # COMING frame
                        disp = torch.abs(b.pos - pos0).amax(dim=-1)
                        motion = (torch.sqrt(torch.sum(b.vel ** 2, dim=-1))
                                  + _gmag(w) * cfg.dt) * cfg.dt
                        esc = disp + motion > sweep + 1e-5
                        viol = bool(torch.any(esc & (b.inv_mass > 0)))
                if age == 0 or viol:
                    tables, pos0, sweep = build(w)
                rebuilds += int(viol)
                age = (1 if (age == 0 or viol) else age + 1) % K
            w, touched, partner, counts, aux = frame2_step(
                w, cfg, tables=tables, inputs=inputs, plain=plain)
            jovf = torch.maximum(jovf, aux["joint_overflow"])
            sovf = torch.maximum(sovf, aux["solve_overflow"])
            sdrp = torch.maximum(sdrp, aux["solve_dropped"])
            hard, m_, s_ = _frame_diag(C, counts)
            ovf = torch.maximum(ovf, hard)
            marg = torch.maximum(marg, m_)
            spec = torch.maximum(spec, s_)
            rec = record(w)
            if with_keys:
                rec = (rec, touching_keys_from_slots(touched, partner, M))
            traj.append(rec)
        diag = dict(slot_overflow=ovf.clamp(min=0),
                    margin_dropped=marg.clamp(min=0),
                    spec_dropped=spec.clamp(min=0), joint_overflow=jovf,
                    forced_rebuilds=torch.tensor(rebuilds, dtype=torch.int32,
                                                 device=dev),
                    solve_overflow=sovf, solve_dropped=sdrp,
                    owner_overflow=inputs.owner_overflow)
        return w, (_stack_records(traj) if traj else None), diag


def make_batched_rollout(cfg: SolverConfig, max_pairs: int, n_frames: int,
                         record=None):
    """``worlds -> (final, traj, diag)`` for a fixed config and length."""
    return partial(batched_rollout, cfg=cfg, max_pairs=max_pairs,
                   n_frames=n_frames, record=record)
