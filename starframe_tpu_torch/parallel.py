"""Batched worlds: a leading world axis through the slot-table kernels.

The PyTorch counterpart of the batched half of ``starframe_tpu/parallel.py``
(``frame2_*``, ``batched_step``, ``batched_rollout``). Thousands of
independent worlds (BASELINE.json:11 — 4096 x 256-body worlds on one chip)
step together: the slot-table broadphase (``hopper/slots.py``) builds each
dynamic collider's partner slots and each body's joint slots, and the frame
kernel (``hopper/frame2.py``) runs the whole frame, joints included. Every
function takes ``plain=False``; ``plain=True`` runs the kernels' plain
PyTorch twins even on a card (for timing against the kernels), as the JAX
package's ``interpret=True`` runs Pallas in interpret mode.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP.md item: solve-slot compaction, per-world owner tables and
sleeping (A1), and the single-world ``vmap(step)`` tier the JAX package
falls back to (A3), which is also where batches past the kernels' bounds
would go. CCD (``cfg.ccd``, bodies flagged ``bullet=True``) runs in the
frame kernel: each substep clamps a bullet's advance at its time of
impact against the frame's manifolds.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from .config import SolverConfig
from .hopper.frame2 import (
    SHARED_LIMIT,
    frame2_shared_bytes,
    kernel_verts,
    owner_csr,
    run_frame2,
)
from .hopper.slots import build_elig_mask, build_joint_slots, build_slot_tables
from .state import (
    BODY_BULLET,
    BODY_KINEMATIC,
    COL_ACTIVE,
    COL_SENSOR,
    JOINT_OFF,
    World,
    map_world,
)

# Host round trips the rollouts made (one per guarded frame: the K-frame
# staleness guard decides on the host whether to rebuild the tables).
host_syncs = 0
# joints per world the kernels take (the JAX package's bound as well)
MAX_JOINTS = 1024


def replicate_world(world: World, n: int) -> World:
    """Broadcast one world into an ``n``-way batch (contiguous copies)."""
    return map_world(
        lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(), world)


def frame2_shapes_ok(worlds: World, cfg: SolverConfig) -> bool:
    """Shape/config half of the slot-kernel decision. The CUDA kernels run
    one block of 256 threads per world with the world's bodies, colliders
    and joint parameters in shared memory, so the capacities are bounded
    (N, M, J <= 1024, and the frame kernel's block within an H100's shared
    memory); the TPU's 128-lane and sublane-block rules do not apply."""
    if cfg.use_pallas is False:
        return False
    if cfg.ccd and cfg.manifold_refresh != "frame":
        return False
    n, m, j = worlds.bodies.n, worlds.colliders.m, worlds.joints.j
    v = worlds.colliders.max_verts
    smem = frame2_shared_bytes(n, m, kernel_verts(v) or v, j)
    return (n <= 1024 and m <= 1024 and j <= MAX_JOINTS
            and smem <= SHARED_LIMIT)


def _require_slice(worlds: World, cfg: SolverConfig) -> None:
    """Raise on what the port does not run yet (never fall through)."""
    if not frame2_shapes_ok(worlds, cfg):
        raise NotImplementedError(
            "this batch or config is not eligible for the slot kernels "
            f"(N = {worlds.bodies.n}, M = {worlds.colliders.m}, "
            f"J = {worlds.joints.j}) and the single-world vmap(step) tier "
            "is not ported yet (ROADMAP.md A3)")
    todo = [
        (0 < cfg.batch_solve_capacity < cfg.slot_capacity,
         "solve-slot compaction (batch_solve_capacity)"),
        (not cfg.batch_uniform_topology,
         "per-world owner tables (batch_uniform_topology=False)"),
        (cfg.sleep_velocity > 0.0, "sleeping in frame2_step"),
    ]
    for hit, what in todo:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md A1)")


def _frame2_arrays(worlds: World, cfg: SolverConfig):
    """Flat contiguous f32/i32 ``[W, ...]`` views for the kernels."""
    b, c = worlds.bodies, worlds.colliders
    f = torch.float32
    responds = ((b.inv_mass > 0) | (b.inv_inertia > 0)).to(f)
    kin = ((b.flags & BODY_KINEMATIC) != 0).to(f)
    moves = torch.maximum(responds, kin)
    body = dict(
        posx=b.pos[..., 0].contiguous(), posy=b.pos[..., 1].contiguous(),
        ang=b.angle, velx=b.vel[..., 0].contiguous(),
        vely=b.vel[..., 1].contiguous(), angvel=b.ang_vel,
        invm=b.inv_mass, invi=b.inv_inertia,
        dyn=(b.inv_mass > 0).to(f), kin=kin,
        responds=responds, moves=moves,
        bullet=((b.flags & BODY_BULLET) != 0).to(f),
    )
    col = dict(
        cbody=c.body_idx,
        vlx=c.verts[..., 0].transpose(-1, -2).contiguous(),  # [W, V, M]
        vly=c.verts[..., 1].transpose(-1, -2).contiguous(),
        nverts=c.nverts, radius=c.radius,
        fric=c.friction, rest=c.restitution,
        layer=c.layer, lmask=c.mask,
        active=((c.flags & COL_ACTIVE) != 0).to(f),
        sensor=((c.flags & COL_SENSOR) != 0).to(f),
    )
    return body, col


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


def frame2_elig(worlds: World, cfg: SolverConfig, plain: bool = False):
    """Static pair-eligibility mask ``[W, M, M] i8`` for table builds —
    constant across a rollout, so rollouts build it once."""
    body, col = _frame2_arrays(worlds, cfg)
    return build_elig_mask(
        col["cbody"], col["layer"], col["lmask"], col["active"],
        col["sensor"], body["responds"], body["moves"], plain=plain)


def frame2_tables(worlds: World, cfg: SolverConfig, frames: int = 1,
                  return_budget: bool = False, elig=None,
                  plain: bool = False):
    """Slot-table broadphase for a world batch. With ``frames > 1`` the
    swept boxes stay a valid candidate superset for that many frames (a
    symmetric positional budget from :func:`_sweep_bounds`, inflated per
    collider to the max over its phase-1 partners). Returns ``(partner,
    slot_act, count, count_touch, count_close)``; with
    ``return_budget=True``, ``(tables, budget [W, M])``."""
    body, col = _frame2_arrays(worlds, cfg)
    if elig is None:
        elig = frame2_elig(worlds, cfg, plain=plain)
    vx, vy = body["velx"], body["vely"]
    if frames > 1:
        vx, vy = _sweep_bounds(worlds, cfg, frames), None
    *tables, budget = build_slot_tables(
        body["posx"], body["posy"], body["ang"], vx, vy,
        col["cbody"], col["vlx"], col["vly"], col["radius"], elig,
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


def _frame2_joints(worlds: World, cfg: SolverConfig, joint_slots):
    """The frame kernel's joint dict (``hopper.run_frame2``) and the hard
    ``joint_overflow`` counter: joints dropped past the bodies' slots."""
    j = worlds.joints
    jslot, jside, jact, jcount = joint_slots
    JC = cfg.joint_slot_capacity
    overflow = torch.clamp(jcount - JC, min=0).sum(dtype=torch.int32)
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


def frame2_step(worlds: World, cfg: SolverConfig, tables=None, owners=None,
                joint_slots=None, plain: bool = False):
    """One batched frame through the slot kernels. Returns ``(new_worlds,
    touched [W, C, M], partner [W, C, M], (count, count_touch,
    count_close), aux)`` with ``aux`` the hard scalar counters
    ``joint_overflow`` (joints past a body's ``cfg.joint_slot_capacity``
    slots) and the zero-valued ones of the branches this slice does not
    run (``owner_overflow``, ``solve_overflow``, ``solve_dropped``). Pass
    ``tables`` (from :func:`frame2_tables`) to reuse a broadphase, ``owners``
    (``hopper.owner_csr`` of world 0's ``body_idx``) to reuse the collider
    -> body reduction order, and ``joint_slots`` (from
    :func:`frame2_joint_slots`) to reuse the joint slots."""
    _require_slice(worlds, cfg)
    body, col = _frame2_arrays(worlds, cfg)
    if tables is None:
        tables = frame2_tables(worlds, cfg, plain=plain)
    partner, slot_act, count, count_touch, count_close = tables
    W = body["posx"].shape[0]
    gravity = worlds.gravity.expand(W, 2).contiguous()
    zero = torch.zeros((), dtype=torch.int32, device=gravity.device)
    joints, joint_overflow = None, zero
    if worlds.joints.j > 0:
        if joint_slots is None:
            joint_slots = frame2_joint_slots(worlds, cfg, plain=plain)
        joints, joint_overflow = _frame2_joints(worlds, cfg, joint_slots)
    posx, posy, ang, velx, vely, angvel, touched = run_frame2(
        body["posx"], body["posy"], body["ang"],
        body["velx"], body["vely"], body["angvel"],
        body["invm"], body["invi"], body["dyn"], body["kin"],
        col["cbody"], col["vlx"], col["vly"], col["nverts"], col["radius"],
        col["fric"], col["rest"], col["sensor"], partner, slot_act, gravity,
        C=cfg.slot_capacity, substeps=cfg.substeps,
        iterations=cfg.iterations, h=cfg.dt / cfg.substeps, dt=cfg.dt,
        margin=cfg.contact_margin, compliance=cfg.contact_compliance,
        relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
        rest_threshold=cfg.restitution_threshold,
        lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
        owners=owners, joints=joints, JC=cfg.joint_slot_capacity,
        joint_solver=cfg.joint_solver, n_colors=cfg.max_joint_colors,
        # joints are constraint upkeep: the raw clip, not max_dpos_eff
        max_dpos_joint=cfg.max_dpos, bullet=body["bullet"], ccd=cfg.ccd,
        ccd_slop=cfg.ccd_slop, plain=plain)
    b = worlds.bodies
    new_bodies = dataclasses.replace(
        b, pos=torch.stack([posx, posy], dim=-1), angle=ang,
        vel=torch.stack([velx, vely], dim=-1), ang_vel=angvel,
        prev_pos=b.pos, prev_angle=b.angle)
    new_worlds = dataclasses.replace(
        worlds, bodies=new_bodies, step_count=worlds.step_count + 1)
    aux = dict(joint_overflow=joint_overflow, owner_overflow=zero,
               solve_overflow=zero, solve_dropped=zero)
    return new_worlds, touched, partner, (count, count_touch, count_close), aux


def _frame_diag(C, counts):
    """Per-frame ``(hard, margin, spec)`` row-overflow amounts (device
    scalars; <= 0 means nothing was dropped)."""
    count, count_touch, count_close = counts
    return (count_touch.max() - C, count_close.max() - C, count.max() - C)


def batched_step(worlds: World, cfg: SolverConfig, max_pairs: int,
                 with_diag: bool = False, plain: bool = False):
    """Frame step over the leading world axis through the slot kernels.
    With ``with_diag=True`` returns ``(worlds, diag)`` with the rollout's
    counter keys (see :func:`batched_rollout`)."""
    w2, _, _, counts, aux = frame2_step(worlds, cfg, plain=plain)
    if not with_diag:
        return w2
    hard, marg, spec = _frame_diag(cfg.slot_capacity, counts)
    zero = torch.zeros((), dtype=torch.int32, device=hard.device)
    diag = dict(slot_overflow=hard.clamp(min=0), margin_dropped=marg.clamp(min=0),
                spec_dropped=spec.clamp(min=0), forced_rebuilds=zero, **aux)
    return w2, diag


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
                    n_frames: int, record=None, plain: bool = False):
    """N-frame rollout of a world batch. ``record(worlds)`` picks what to
    keep per frame (default: poses), stacked on a leading frame axis.

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
    - ``owner_overflow``, ``solve_overflow``, ``solve_dropped``: 0 on this
      slice (uniform topology, no compaction);
    - ``forced_rebuilds``: table rebuilds forced by the staleness guard.

    With ``cfg.frames_per_broadphase = K > 1`` the tables are rebuilt every
    K-th frame with K-frame-inflated, partner-aware sweeps, and a per-frame
    POSITIONAL guard forces an early rebuild when a dynamic body's
    displacement since the build plus the coming frame's motion exceeds
    its sweep budget. The guard's verdict is read on the host: one host
    round trip per frame that is not already a scheduled rebuild (counted
    in the module's ``host_syncs``). K = 1 builds fresh tables every frame
    with no guard and no round trip.
    """
    global host_syncs
    _require_slice(worlds, cfg)
    if record is None:
        record = lambda w: (w.bodies.pos, w.bodies.angle)  # noqa: E731
    C = cfg.slot_capacity
    K = max(cfg.frames_per_broadphase, 1)
    dev = worlds.bodies.pos.device
    neg = torch.tensor(-(2 ** 31), dtype=torch.int32, device=dev)
    ovf = marg = spec = neg
    rebuilds = 0
    # INVARIANT: the eligibility mask, the collider -> body owner lists and
    # the joint slots depend only on flags and topology, which nothing
    # inside a rollout changes, so they are built once
    elig = frame2_elig(worlds, cfg, plain=plain)
    owners = owner_csr(worlds.colliders.body_idx[0], worlds.bodies.n)
    joint_slots = (frame2_joint_slots(worlds, cfg, plain=plain)
                   if worlds.joints.j > 0 else None)
    jovf = torch.zeros((), dtype=torch.int32, device=dev)

    def build(w):
        # per-body position budget: the min over the body's active
        # colliders of the inflation each collider's tables were built with
        tables, budget_col = frame2_tables(
            w, cfg, frames=K, return_budget=True, elig=elig, plain=plain)
        act = (w.colliders.flags & COL_ACTIVE) != 0
        big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
        bc = torch.where(act, budget_col, big)
        budget = torch.full(w.bodies.inv_mass.shape, 3.0e38,
                            dtype=torch.float32, device=dev)
        budget = budget.scatter_reduce(1, w.colliders.body_idx.long(), bc,
                                       reduce="amin", include_self=True)
        return tables, w.bodies.pos, budget

    w = worlds
    traj = []
    if K > 1:
        tables, pos0, sweep = build(w)
        age = 1 % K
    for _ in range(n_frames):
        if K == 1:
            tables = frame2_tables(w, cfg, frames=1, elig=elig, plain=plain)
        else:
            viol = False
            if age != 0:
                b = w.bodies
                # positional staleness guard: each dynamic body must stay
                # inside its build-time swept box through the COMING frame
                disp = torch.abs(b.pos - pos0).amax(dim=-1)
                motion = (torch.sqrt(torch.sum(b.vel ** 2, dim=-1))
                          + _gmag(w) * cfg.dt) * cfg.dt
                esc = disp + motion > sweep + 1e-5
                viol = bool(torch.any(esc & (b.inv_mass > 0)))
                host_syncs += 1
            if age == 0 or viol:
                tables, pos0, sweep = build(w)
            rebuilds += int(viol)
            age = (1 if (age == 0 or viol) else age + 1) % K
        w, touched, partner, counts, aux = frame2_step(
            w, cfg, tables=tables, owners=owners, joint_slots=joint_slots,
            plain=plain)
        if joint_slots is not None:
            jovf = torch.maximum(jovf, aux["joint_overflow"])
        hard, m_, s_ = _frame_diag(C, counts)
        ovf = torch.maximum(ovf, hard)
        marg = torch.maximum(marg, m_)
        spec = torch.maximum(spec, s_)
        traj.append(record(w))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    diag = dict(slot_overflow=ovf.clamp(min=0), margin_dropped=marg.clamp(min=0),
                spec_dropped=spec.clamp(min=0), joint_overflow=jovf,
                forced_rebuilds=torch.tensor(rebuilds, dtype=torch.int32,
                                             device=dev),
                solve_overflow=zero, solve_dropped=zero, owner_overflow=zero)
    return w, (_stack_records(traj) if traj else None), diag


def make_batched_rollout(cfg: SolverConfig, max_pairs: int, n_frames: int,
                         record=None):
    """``worlds -> (final, traj, diag)`` for a fixed config and length."""
    return partial(batched_rollout, cfg=cfg, max_pairs=max_pairs,
                   n_frames=n_frames, record=record)
