"""Whole-frame XPBD solve for a world batch.

Replaces ``starframe_tpu/pallas/frame2.py``'s ``_frame2_kernel`` (via
``run_frame2``) with the CUDA kernel in ``csrc/frame2.cuh``, in every
configuration the reference has: contact-only or with joints, with or
without CCD, with or without per-frame solve-slot compaction (``Cs``), with
one collider -> body list for the batch or one per world. :func:`run_frame2`
launches it for CUDA tensors and runs :func:`frame2_plain`, the plain
PyTorch twin, for CPU tensors. Both take a frame's body planes and slot
tables and a :class:`Frame2Inputs`, what no frame of a call changes.

The kernel keeps each world's slot table (67 bytes a slot: the body-local
normal and anchors, the lambdas, a pass's four row-sum terms, the partner
and a mask byte) in shared memory beside the world's state and the
substep-start pose; each frame's live set (:func:`live_set`: the slots
whose manifold has an active point, which the slot phases walk) reuses
the planes only the frame's set-up reads (:func:`frame2_live_shared`).
Only rows that may hold a slot (K1's row rule) get a record where a table
of just them buys the SM more blocks (:func:`frame2_layout`: the walker's
5 of 204 rows, four worlds an SM in place of one); else every row does.
:func:`frame2_table_rows` gives how many table rows' records fit there,
and the wrapper hands the kernel a global table for the rest (none at the
main path's shapes). ``run_frame2.live_items`` (a one-element int64
tensor on the device) and ``run_frame2.slot_items`` (an int) count the
live items and all (row, solve slot) items of every frame run, kernel or
twin; ``.table_rows`` and ``.rows`` the rows the tables held and all. With
joints the kernel lists each frame's live joint items (the body's joint
slots with ``jact != 0``) once, and its joint passes walk that list, one
item a thread (:func:`frame2_joints_shared`: in shared memory past the
slot table, else in global memory).

The frame: manifolds once at the frame-start pose (with a velocity-expanded
speculative margin, anchors kept body-local), then ``substeps`` x
[integrate -> ``iterations`` x (Jacobi contact projection over each row's
slots, count-normalised and clipped; joints fused into it, or one coloured
Gauss-Seidel pass per joint colour after it) -> velocity reconstruction ->
restitution/friction velocity pass with motors and joint damping]. Every
dynamic collider owns its slot row, so corrections reach bodies by summing
rows (a body's colliders come from a CSR: world 0's ``cbody`` through
:func:`owner_csr` when the batch shares one topology, each world's own
through :func:`owner_csr_tables` when not; rollouts build it once); every
body owns its joint slots (``hopper.build_joint_slots``). With ``Cs`` each
row ranks its C slots once a frame (:func:`solve_order`) and the substeps
solve the first ``Cs``. With CCD each substep's integrated pose of a bullet
body is pulled back to its earliest time of impact against the frame's
manifolds before the solve (``ccd=True``), over every slot of the table.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

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

SCRATCH_FIELDS = 16  # csrc/common.cuh F2_FIELDS: float fields a slot record keeps
SLOT_BYTES = 4 * SCRATCH_FIELDS + 3  # and its int16 partner and mask byte
_KERNEL_V = (4, 8)  # vertex widths the kernel is compiled for
SHARED_LIMIT = 232448  # bytes of shared memory one H100 block may use
SM_BYTES = 233472  # csrc/frame2.cuh kSmPerSM: shared memory an SM shares out
SM_RESERVED = 1024  # kSmReserved: of it, what the runtime keeps a block
MAX_COMPACT_C = 32  # csrc/frame2.cuh kMaxC: table width a row can rank
# the joint tables run_frame2 takes: parameters [W, J], then slots [W, JC, N]
JOINT_SLOT_KEYS = ("jslot", "jside", "jact")


def kernel_verts(V: int):
    """The compiled vertex width a ``V``-vertex batch is padded to (None
    past the widest)."""
    return next((v for v in _KERNEL_V if v >= V), None)


def frame2_state_bytes(N: int, M: int, V: int, J: int) -> int:
    """Shared memory of one frame-kernel block's world state
    (``csrc/frame2.cuh`` ``shared_bytes``): the bodies, colliders and row
    sums, and with joints their 15 parameter rows and ``4 N`` words, of
    which each body's first item in the joint list takes ``N + 1``. A
    batch whose state does not fit is not eligible."""
    return (4 * (19 * N + (2 * V + 9) * M) + 4 * (3 * M + N + 1)
            + (4 * (len(_build.JOINT_KEYS) * J + 4 * N) if J > 0 else 0))


def frame2_joint_bytes(J: int) -> int:
    """Bytes of one world's joint list (``csrc/frame2.cuh``
    ``joint_bytes``): the build's 64 warp counts and 20 words for each of
    at most ``2J`` items (a joint lies in at most its two bodies' slots)."""
    return 4 * (64 + 20 * 2 * J) if J > 0 else 0


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def _sm_blocks(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM runs (``csrc/frame2.cuh``
    ``sm_blocks``: four of 128 threads where four fit its shared memory,
    two of 256 where two do, else one of 512)."""
    return next((k for k in (4, 2) if k * (smem + SM_RESERVED) <= SM_BYTES),
                1)


class Frame2Layout(NamedTuple):
    """Where one frame-kernel block keeps what (``csrc/frame2.cuh``
    ``Placement``): ``R`` table rows' records in shared memory (None: the
    world's state does not fit), of the ``rows`` the table holds (M, or
    ``Rs`` where ``ranked``: only the rows that may hold a slot keep
    records), the pose planes, the live set and the joint list in shared
    memory or not, the block's dynamic shared ``bytes`` and a world's
    global ``scratch`` bytes (0: none)."""

    R: int | None
    rows: int
    ranked: bool
    pose_shared: bool
    live_shared: bool
    joints_shared: bool
    bytes: int
    scratch: int


def _rank_words(M: int, rows: int) -> int:
    """Words of a ranked table's two int16 rank planes (``csrc/frame2.cuh``
    ``rank_words``: a rank for each of M colliders, a collider for each of
    ``rows`` ranks), ahead of the live set in the set-up's planes."""
    return (M + rows + 1) // 2


def _place_rows(N, M, V, J, Csol, rows, ranked) -> Frame2Layout:
    """The layout of a table of ``rows`` rows (``csrc/frame2.cuh``
    ``place_rows``): past the world's state the four ``[N]`` pose planes,
    then as many rows' records as fit, then (16-aligned) the joint list
    where it fits and costs the SM no block."""
    state = frame2_state_bytes(N, M, V, J)
    live_shared = frame2_live_shared(
        M, V, Csol, _rank_words(M, rows) if ranked else 0)
    R, pose_shared, joints_shared, smem = None, False, False, state
    if state <= SHARED_LIMIT:
        R = 0
        if state + 16 * N <= SHARED_LIMIT:
            per_row = SLOT_BYTES * Csol
            R = min(rows, (SHARED_LIMIT - state - 16 * N) // per_row)
            pose_shared, smem = True, state + 16 * N + per_row * R
            top = _align16(smem) + frame2_joint_bytes(J)
            joints_shared = (J > 0 and top <= SHARED_LIMIT
                             and _sm_blocks(top) == _sm_blocks(smem))
            smem = top if joints_shared else smem
    scratch = (0 if pose_shared and live_shared and (J <= 0 or joints_shared)
               else frame2_joint_bytes(J)
               + _align16(16 * N + frame2_live_bytes(M, Csol)))
    return Frame2Layout(R, rows, ranked, pose_shared, live_shared,
                        joints_shared, smem, scratch)


def frame2_layout(N: int, M: int, V: int, J: int, Csol: int,
                  Rs: int | None = None) -> Frame2Layout:
    """The frame kernel's layout at these shapes (``csrc/frame2.cuh``
    ``place``): a table of the ``Rs`` rows that may hold a slot (the most
    of any world) where it gives the SM more blocks than one of every row,
    else one of every row (also where ``Rs`` is None)."""
    every = _place_rows(N, M, V, J, Csol, M, False)
    if every.R is None or Rs is None or not 0 < Rs < M:
        return every
    few = _place_rows(N, M, V, J, Csol, Rs, True)
    return few if _sm_blocks(few.bytes) > _sm_blocks(every.bytes) else every


def frame2_joints_shared(N: int, M: int, V: int, J: int, Csol: int,
                         Rs: int | None = None) -> bool:
    """Whether the joint list goes to shared memory past the slot table
    (16-aligned; it takes no row from :func:`frame2_table_rows`): where it
    fits there and costs the SM no block (:func:`frame2_layout`). Else it
    goes to global memory beside the pose planes and the live set."""
    return frame2_layout(N, M, V, J, Csol, Rs).joints_shared


def frame2_table_rows(N: int, M: int, V: int, J: int, Csol: int,
                      Rs: int | None = None):
    """``R``: how many table rows keep their ``Csol``-slot records in the
    block's shared memory (:func:`frame2_layout`), the rest going to a
    global table. The shared memory left after the world's state first
    holds the four ``[N]`` substep-start pose planes; when they do not fit,
    they go to global memory too and R = 0. None when the state itself does
    not fit."""
    return frame2_layout(N, M, V, J, Csol, Rs).R


def frame2_shared_bytes(N: int, M: int, V: int, J: int, Csol: int,
                        Rs: int | None = None) -> int:
    """Dynamic shared memory of one frame-kernel block: the world's state,
    then (when they fit) the pose planes, the records of the first
    :func:`frame2_table_rows` table rows and the joint list."""
    return frame2_layout(N, M, V, J, Csol, Rs).bytes


def frame2_live_bytes(M: int, Csol: int) -> int:
    """Bytes of one world's live set (``csrc/frame2.cuh`` ``live_bytes``):
    the build's 64 warp counts, the row bits ``[ceil(Csol / 32), M]``
    (uint32) and one list entry an item (uint16 where ``Csol * M <=
    65536``, else uint32)."""
    items = Csol * M
    return 4 * (64 + -(-Csol // 32) * M) + (2 if items <= 65536 else 4) * items


def frame2_live_shared(M: int, V: int, Csol: int, after: int = 0) -> bool:
    """Whether the live set takes the shared memory of the planes only the
    frame's set-up reads (``csrc/frame2.cuh`` ``dead_words``: ``(2V + 7) M``
    words) past their first ``after`` words (a ranked table's rank planes);
    else it goes to global memory beside the pose planes."""
    return frame2_live_bytes(M, Csol) + 4 * after <= 4 * (2 * V + 7) * M


def frame2_scratch_bytes(N: int, M: int, V: int, J: int, Csol: int,
                         Rs: int | None = None) -> int:
    """Bytes of one world's global scratch (``csrc/frame2.cuh``
    ``scratch_bytes``: with joints the joint list, then the pose planes
    and the live set, 16-aligned), or 0 where all fit in shared memory."""
    return frame2_layout(N, M, V, J, Csol, Rs).scratch


def table_bytes(K: int, rows: int) -> int:
    """Bytes of one world's global slot table of ``K`` slots x ``rows``
    rows (``csrc/frame2.cuh`` ``table_bytes``)."""
    return -(-K * rows * SLOT_BYTES // 16) * 16


def live_set(pm, M: int):
    """The frame kernel's live set, plainly: ``pm [W, Csol * M]`` bool
    (a slot's manifold has an active point; item u = c * M + i) gives
    ``(items [W, Csol * M] long, n [W] long, bits [W, ceil(Csol / 32), M]
    long)``: each world's live items in ascending u in ``items[:, :n]``
    (the rest -1), and row i's live slots c as bit c % 32 of word c // 32.
    """
    W, T = pm.shape
    Csol = T // M
    u = torch.arange(T, device=pm.device).expand(W, T)
    n = pm.sum(dim=1)
    items = torch.sort(torch.where(pm, u, T), dim=1).values
    items = torch.where(items < T, items, -1)
    c = torch.arange(Csol, device=pm.device)
    shifted = pm.reshape(W, Csol, M).long() << (c % 32)[None, :, None]
    words = -(-Csol // 32)
    bits = torch.zeros((W, words, M), dtype=torch.long, device=pm.device)
    bits.index_add_(1, c // 32, shifted)
    return items, n, bits


def _live_counter(dev):
    """``run_frame2.live_items`` on ``dev``: allocated at the first frame
    (moved, once, if the frames move to another device)."""
    t = run_frame2.live_items
    if t is None or t.device != torch.device(dev):
        t = run_frame2.live_items = (
            torch.zeros(1, dtype=torch.int64, device=dev) if t is None
            else t.to(dev))
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class Frame2Inputs:
    """What :func:`run_frame2` and :func:`frame2_plain` read that no frame
    of a call changes (``parallel.frame2_inputs`` builds it once a call):
    collider planes ``[W, M]`` (``vlx``/``vly`` ``[W, V, M]``), body planes
    ``[W, N]`` (``invm``/``invi``/``dyn`` None where sleep leaves them to
    each frame; ``bullet`` for ``ccd``), ``slot_rows [W, M]`` (1 where a
    row may hold a slot: K1's row rule, outside which K2's tables hold no
    slot; the kernel keeps records of no other row where that pays,
    :func:`frame2_layout`), ``gravity [W, 2]``, the owner CSR
    (:func:`owner_csr` or :func:`owner_csr_tables`), ``joints`` (None:
    contact-only; ``_build.JOINT_KEYS`` ``[W, J]`` and
    ``JOINT_SLOT_KEYS`` ``[W, JC, N]``, ``jmm`` with +inf as 3.4e38), ints
    i32 and floats ``kin``'s dtype (the kernel takes f32), then the
    solve's parameters (``joint_solver`` ``"colored"`` or ``"jacobi"``;
    with ``0 < Cs < C`` rows solve their ``Cs`` closest slots, the TOI
    still over all C). Built, it checks its tensors and sets ``J``,
    ``per_world``, ``compact``, ``Rs`` (the most rows of a world that may
    hold a slot: one host read) and the kernel's layout: vertex width
    ``Vk`` (None past the widest) and the planes padded to it
    ``kvlx``/``kvly``, solve width ``Csol``, the rows its slot table holds
    ``table_rows`` (M, or Rs), shared table rows ``R`` (None: the state
    does not fit) and global ``scratch`` bytes, held on a CUDA device to
    the library's."""

    cbody: torch.Tensor
    vlx: torch.Tensor
    vly: torch.Tensor
    nverts: torch.Tensor
    radius: torch.Tensor
    fric: torch.Tensor
    rest: torch.Tensor
    sensor: torch.Tensor
    slot_rows: torch.Tensor
    kin: torch.Tensor
    invm: torch.Tensor | None
    invi: torch.Tensor | None
    dyn: torch.Tensor | None
    gravity: torch.Tensor
    owners: tuple
    C: int
    substeps: int
    iterations: int
    h: float
    dt: float
    margin: float
    compliance: float
    relaxation: float
    max_dpos: float
    rest_threshold: float
    lin_damp: float
    ang_damp: float
    joints: dict | None = None
    JC: int = 0
    joint_solver: str = "jacobi"
    n_colors: int = 1
    max_dpos_joint: float = 1e3
    bullet: torch.Tensor | None = None
    ccd: bool = False
    ccd_slop: float = 0.005
    Cs: int = 0

    def __post_init__(self):
        W, N = self.kin.shape
        M = self.cbody.shape[1]
        V = self.vlx.shape[1]
        fl = self.kin.dtype
        checks = [("cbody", self.cbody, i32, (W, M)),
                  ("nverts", self.nverts, i32, (W, M)),
                  ("vlx", self.vlx, fl, (W, V, M)),
                  ("vly", self.vly, fl, (W, V, M)),
                  ("gravity", self.gravity, fl, (W, 2))]
        checks += [(k, getattr(self, k), fl, (W, M))
                   for k in ("radius", "fric", "rest", "sensor",
                             "slot_rows")]
        checks += [(k, getattr(self, k), fl, (W, N))
                   for k in ("kin", "invm", "invi", "dyn")
                   if getattr(self, k) is not None]
        per_world = self.owners[0].dim() == 2
        lead = (W,) if per_world else ()
        checks += [("owner start", self.owners[0], i32, lead + (N + 1,)),
                   ("owner idx", self.owners[1], i32, lead + (M,))]
        compact = 0 < self.Cs < self.C
        if compact and self.C > MAX_COMPACT_C:
            raise ValueError(f"solve-slot compaction ranks at most "
                             f"{MAX_COMPACT_C} slots a row, got C = "
                             f"{self.C}")
        J = 0
        if self.joints is not None:
            if self.joint_solver not in ("colored", "jacobi"):
                raise ValueError(
                    f"unknown joint_solver {self.joint_solver!r}")
            J = self.joints["jtype"].shape[1]
            ints = ("jtype", "jba", "jbb", "jcolor", "jslot")
            checks += [(k, self.joints[k], i32 if k in ints else fl, (W, J))
                       for k in _build.JOINT_KEYS]
            checks += [(k, self.joints[k], i32 if k in ints else fl,
                        (W, self.JC, N)) for k in JOINT_SLOT_KEYS]
        if self.ccd:
            if self.bullet is None:
                raise ValueError("ccd=True needs the bodies' bullet flags")
            checks.append(("bullet", self.bullet, fl, (W, N)))
        for name, t, dtype, shape in checks:
            _check(name, t, dtype, shape, self.kin.device)
        Csol = self.Cs if compact else self.C
        Vk = kernel_verts(V)
        Rs = int(self.slot_rows.sum(dim=1).max()) if W > 0 else 0
        lay = frame2_layout(N, M, Vk, J, Csol, Rs) if Vk else None
        R, rows = (lay.R, lay.rows) if lay else (None, M)
        scratch = lay.scratch if lay else 0
        if Vk and _route(self.kin.device):  # the library's layout
            lib, a = _build.library(), (N, M, Vk, J, Csol, Rs)
            if (lib.sf_frame2_fields() != SCRATCH_FIELDS
                    or lib.sf_frame2_slot_bytes() != SLOT_BYTES
                    or lib.sf_frame2_table_rows(*a) != (-1 if R is None else R)
                    or lib.sf_frame2_table_size(*a) != rows
                    or lib.sf_frame2_shared_bytes(*a) != lay.bytes
                    or lib.sf_frame2_scratch_bytes(*a) != scratch
                    or bool(lib.sf_frame2_joints_shared(*a))
                    != lay.joints_shared):
                raise RuntimeError("frame kernel layout differs from "
                                   "this module's (SLOT_BYTES, frame2_*)")
        kvlx, kvly = self.vlx, self.vly
        if Vk and Vk != V:  # pad with copies of v0: every min, max and
            # manifold holds
            kvlx = torch.cat([kvlx, kvlx[:, :1].expand(W, Vk - V, M)], 1)
            kvly = torch.cat([kvly, kvly[:, :1].expand(W, Vk - V, M)], 1)
        for k, v in dict(J=J, per_world=per_world, compact=compact,
                         Csol=Csol, Vk=Vk, Rs=Rs, table_rows=rows, R=R,
                         scratch=scratch, kvlx=kvlx, kvly=kvly).items():
            object.__setattr__(self, k, v)


def owner_csr(cbody0, n_bodies: int, listed=None):
    """``(start [N + 1] i32, idx [M] i32)``: body n owns colliders
    ``idx[start[n]:start[n + 1]]``, ascending, in every world of a batch
    that shares world 0's topology. With ``listed`` ([M] bool: active in
    some world) the others are left out (past ``start[N]``): they have no
    slots in any world, so their rows would add exact zeros to their
    body's sums (a padded batch gives one body ~100 of them). Built on the
    device, with no host round trip."""
    cb = cbody0.long()
    if listed is not None:
        cb = torch.where(listed, cb, n_bodies)
    order = torch.argsort(cb, stable=True).to(i32)
    counts = torch.bincount(cb, minlength=n_bodies + 1)[:n_bodies]
    start = torch.zeros(n_bodies + 1, dtype=i32, device=cb.device)
    start[1:] = torch.cumsum(counts, 0).to(i32)
    return start, order


def owner_csr_tables(bcol, bmask, n_colliders: int):
    """The per-world form of :func:`owner_csr`: ``(start [W, N + 1] i32,
    idx [W, M] i32)`` listing, for each world, body n's colliders of the
    owner tables ``bcol``/``bmask [W, Kc, N]`` (``parallel.
    collider_owner_tables``: active colliders only, ascending, at most Kc a
    body). Entries of ``idx`` past ``start[:, N]`` are unused."""
    W, Kc, N = bcol.shape
    dev = bcol.device
    on = bmask > 0
    counts = on.sum(dim=1)  # [W, N]
    start = torch.zeros((W, N + 1), dtype=i32, device=dev)
    start[:, 1:] = torch.cumsum(counts, 1).to(i32)
    k = torch.arange(Kc, device=dev)[None, :, None]
    # masked-off entries go to a spare column, dropped below
    at = torch.where(on, start[:, None, :-1].long() + k, n_colliders)
    idx = torch.zeros((W, n_colliders + 1), dtype=i32, device=dev)
    idx.scatter_(1, at.reshape(W, -1), bcol.reshape(W, -1).to(i32))
    return start, idx[:, :n_colliders].contiguous()


def _owner_table(start, order):
    """An :func:`owner_csr` or :func:`owner_csr_tables` padded to ``(idx
    [W or 1, K, N] long, mask [W or 1, K, N] f32)``: row k holds each
    body's k-th collider (ascending), mask 0 past its count."""
    if start.dim() == 1:
        start, order = start[None], order[None]
    counts = start[:, 1:] - start[:, :-1]
    k = torch.arange(max(int(counts.max()), 1),
                     device=order.device)[None, :, None]
    mask = k < counts[:, None]
    at = torch.clamp(start[:, None, :-1] + k, max=order.shape[1] - 1).long()
    idx = torch.gather(order.long(), 1, at.reshape(at.shape[0], -1))
    return (torch.where(mask, idx.reshape(at.shape), 0), mask.to(f32))


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


def solve_order(sep, pmask, touch0, margin: float, C: int):
    """The per-frame solve-slot ranking of ``pallas/frame2.py:361-407``:
    each slot's tier (0 touching, 1 imminent ``sep < margin``, 2
    speculative-active, 3 empty), ranked by the exact total order (tier,
    ``sep_min``, slot index). ``sep``/``pmask [2, W, C * M]``, ``touch0 [W,
    C * M]``. Returns ``(order [W, C, M] long, nact [W, 2, M] f32)``:
    ``order[:, s]`` is the slot of rank s; ``nact`` counts the imminent
    (tier <= 1) and pmask-active (tier <= 2) slots of each row."""
    W, CM = touch0.shape
    M = CM // C
    pm_any = pmask.amax(dim=0)
    sep_min = torch.where(pmask > 0, sep, 1e9).amin(dim=0)
    tier = torch.where(
        touch0 > 0, 0.0, torch.where((sep_min < margin) & (pm_any > 0), 1.0,
                                     torch.where(pm_any > 0, 2.0, 3.0)))
    t = tier.reshape(W, C, M)
    sm = sep_min.reshape(W, C, M)
    tc, sc = t[:, :, None], sm[:, :, None]  # slot c
    t2, s2 = t[:, None], sm[:, None]  # slot c2
    lower = (torch.arange(C, device=t.device)[None, :]
             < torch.arange(C, device=t.device)[:, None])[None, :, :, None]
    before = (t2 < tc) | ((t2 == tc) & ((s2 < sc) | ((s2 == sc) & lower)))
    rank = before.sum(dim=2)  # [W, C, M], a permutation of 0..C-1
    slots = torch.arange(C, device=t.device)[None, :, None].expand(W, C, M)
    order = torch.empty_like(rank).scatter_(1, rank, slots)
    nact = torch.stack([(t <= 1.0).to(f32).sum(dim=1),
                        (t <= 2.0).to(f32).sum(dim=1)], dim=1)
    return order, nact


def frame2_plain(posx, posy, ang, velx, vely, angvel, partner, slot_act,
                 inputs: Frame2Inputs, masses=None):
    """Plain PyTorch twin of :func:`run_frame2`: the TPU kernel's sequence
    of array operations, with ``torch.gather`` in place of its lane gathers
    and the slots of a row packed on one axis ``[W, C * M]`` (slot-major),
    the joint slots of a body on ``[W, JC * N]``. With ``0 < Cs < C`` the
    slots are ranked once (:func:`solve_order`) and the substeps run on the
    first ``Cs``; with CCD too, the TOI minimum still runs over all C
    slots, each at its substep-start anchors."""
    x = inputs
    invm, invi, dyn = masses or (x.invm, x.invi, x.dyn)
    kin, cbody, vlx, vly, nverts, radius, fric, rest, sensor, C, h, dt = (
        x.kin, x.cbody, x.vlx, x.vly, x.nverts, x.radius, x.fric, x.rest,
        x.sensor, x.C, x.h, x.dt)
    joints, max_dpos, max_dpos_joint = x.joints, x.max_dpos, x.max_dpos_joint
    Cs = x.Cs if x.compact else 0
    W, N = posx.shape
    M = cbody.shape[1]
    V = vlx.shape[1]
    cbl = cbody.long()

    def gat(x, idx):
        return torch.gather(x, 1, idx)

    def tile_w(x, k):  # [W, M] -> [W, k*M]: own-side quantity per slot
        return x.repeat(1, k)

    def sum_w(x, k):  # [..., k*M] -> [..., M]: row sums in slot order
        acc = x[..., 0:M]
        for c in range(1, k):
            acc = acc + x[..., c * M:(c + 1) * M]
        return acc

    def min_w(x, k):  # [..., k*M] -> [..., M]: row minima over the slots
        acc = x[..., 0:M]
        for c in range(1, k):
            acc = torch.minimum(acc, x[..., c * M:(c + 1) * M])
        return acc

    def tile_c(x):
        return tile_w(x, C)

    oidx, omask = _owner_table(*x.owners)

    def to_bodies(vals):  # [Q, W, M] row sums -> [Q, W, N] body sums
        acc = None
        for k in range(oidx.shape[1]):
            idx = oidx[:, k].expand(W, N)[None].expand(vals.shape[0], W, N)
            g = torch.gather(vals, 2, idx) * omask[:, k]
            acc = g if acc is None else acc + g
        return acc

    gx = x.gravity[:, 0:1]
    gy = x.gravity[:, 1:2]
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

    margin_eff = x.margin + dt * (tile_c(o_spd) + p_spd)
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

    # per-frame solve-slot compaction: gather every per-slot array into
    # rank order and keep the first Cs; the full table stays for the TOI
    Cp, compact = C, 0 < Cs < C
    full_cb, full_pb = cb_, pb
    if compact:
        order, nact = solve_order(m.sep, pmask, touched, x.margin, C)
        src = (order[:, :Cs] * M
               + torch.arange(M, device=order.device)).reshape(W, Cs * M)

        def cpk(x):  # [..., W, C*M] -> [..., W, Cs*M]
            return torch.gather(x, -1, src.expand(x.shape[:-1] + src.shape[1:]))

        cb_ = SimpleNamespace(**{k: cpk(v) for k, v in vars(cb_).items()})
        pd_ = SimpleNamespace(**{k: cpk(v) for k, v in vars(pd_).items()})
        pc, pb, touched = cpk(pc), cpk(pb), cpk(touched)
        Cp = Cs

    # the live set the kernel builds, counted as it counts it
    _live_counter(posx.device).add_(
        live_set(cb_.pmask.amax(dim=0) > 0, M)[1].sum())
    run_frame2.slot_items += W * Cp * M
    run_frame2.table_rows += W * M  # the twin's table has every row
    run_frame2.rows += W * M

    def tile_cp(x):
        return tile_w(x, Cp)

    def sum_cp(x):
        return sum_w(x, Cp)

    def slot_pose(cab, sab, px, py, pb_=None, k=None):
        pb_ = pb if pb_ is None else pb_
        k = Cp if k is None else k
        return PairPose(
            tile_w(gat(px, cbl), k), tile_w(gat(py, cbl), k),
            tile_w(gat(cab, cbl), k), tile_w(gat(sab, cbl), k),
            gat(px, pb_), gat(py, pb_), gat(cab, pb_), gat(sab, pb_))

    def slot_vel(vx, vy, om):
        return PairVel(
            tile_cp(gat(vx, cbl)), tile_cp(gat(vy, cbl)), tile_cp(gat(om, cbl)),
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
    # the TOI walks every slot of the table: with compaction the dropped
    # slots' substep-start anchors and normal are not carried, so it takes
    # all C slots' at the substep-start pose (the same formula)
    blt_t = tile_c(gat(x.bullet, cbl)) if x.ccd else None
    for _ in range(x.substeps):
        px0, py0, an0 = px, py, an
        vx = vx + gx * h * dyn
        vy = vy + gy * h * dyn
        px = px + vx * h
        py = py + vy * h
        an = an + om * h
        vtx, vty, vtom = vx, vy, om

        if x.ccd:
            # continuous collision: clamp bullets' integrated advance at
            # their earliest TOI against the frame manifolds; velocities
            # are not scaled (restitution sees the true approach speed)
            if compact:
                k_0 = _pair_kinematics(full_cb, slot_pose(
                    torch.cos(an0), torch.sin(an0), px0, py0, full_pb, C))
                kin0_t, n0_t = k_0[6:10], k_0[0:2]
            else:
                kin0_t, n0_t = kin0, n0
            wax1, way1, wbx1, wby1 = _pair_kinematics(full_cb, slot_pose(
                torch.cos(an), torch.sin(an), px, py, full_pb, C))[6:10]
            wax0, way0, wbx0, wby0 = kin0_t
            nxp, nyp = n0_t[0][None], n0_t[1][None]
            c0 = (wbx0 - wax0) * nxp + (wby0 - way0) * nyp
            c1 = (wbx1 - wax1) * nxp + (wby1 - way1) * nyp
            advance = c0 - c1
            allowed = torch.clamp(c0, min=0.0) + x.ccd_slop
            need = (advance > allowed) & (full_cb.solve_mask > 0.0)
            f_pt = torch.where(need, allowed / torch.clamp(advance, min=1e-10),
                               1.0)
            f_slot = torch.where(blt_t > 0, torch.minimum(f_pt[0], f_pt[1]),
                                 1.0)
            # collider -> body: 1 - sum(1 - f), exact for one-collider
            # bullets and conservative for compound ones
            neg = to_bodies((1.0 - min_w(f_slot, C))[None])[0]
            f_body = torch.clamp(1.0 - neg, 0.0, 1.0)
            hit = f_body < 1.0  # unclamped bodies keep their pose bitwise
            px = torch.where(hit, px0 + f_body * (px - px0), px)
            py = torch.where(hit, py0 + f_body * (py - py0), py)
            an = torch.where(hit, an0 + f_body * (an - an0), an)

        dxx = torch.zeros_like(px)
        dxy = torch.zeros_like(py)
        dth = torch.zeros_like(an)
        lam_n = torch.zeros_like(cb_.sep)
        for _it in range(x.iterations):
            cab, sab = torch.cos(an), torch.sin(an)
            pose = slot_pose(cab, sab, px, py)
            vals_a, _, lam_i = solve_contacts_b(
                pose, None, pd_, cb_, h, x.compliance, kin0=kin0)
            lam_n = lam_n + lam_i
            ab = to_bodies(sum_cp(vals_a))
            if jd is not None and x.joint_solver == "jacobi":
                # joints: averaged Jacobi fused with the contact apply
                ab = ab + joint_rows(jd, cab, sab, px, py, an)
            cnt = torch.clamp(ab[3], min=1.0)
            ddx = torch.clamp(ab[0] * x.relaxation / cnt, -max_dpos, max_dpos)
            ddy = torch.clamp(ab[1] * x.relaxation / cnt, -max_dpos, max_dpos)
            dda = torch.clamp(ab[2] * x.relaxation / cnt, -max_dpos, max_dpos)
            px = px + ddx
            py = py + ddy
            an = an + dda
            dxx = dxx + ddx
            dxy = dxy + ddy
            dth = dth + dda
            if jd is not None and x.joint_solver == "colored":
                # coloured Gauss-Seidel: one pass per colour, the last one
                # sweeping every colour past the static bound; clipped by
                # the raw max_dpos (upkeep, not depenetration)
                for color in range(x.n_colors):
                    cmask = (jcolor >= color if color == x.n_colors - 1
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
            lam_n, h, x.rest_threshold, kin=kin_v)
        abv = to_bodies(sum_cp(cv_a))
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
        if x.lin_damp > 0.0:
            sdamp = 1.0 / (1.0 + h * x.lin_damp)
            vx = vx * sdamp
            vy = vy * sdamp
        if x.ang_damp > 0.0:
            om = om * (1.0 / (1.0 + h * x.ang_damp))
        kin0, n0 = kin_v[6:10], kin_v[0:2]
    out = (px, py, an, vx, vy, om, touched.reshape(W, Cp, M))
    if compact:
        return (*out, pc.reshape(W, Cs, M).to(i32), nact)
    return out


def run_frame2(posx, posy, ang, velx, vely, angvel, partner, slot_act,
               inputs: Frame2Inputs, masses=None, plain: bool = False):
    """Run one frame's XPBD substeps for a world batch: the frame's body
    planes ``[W, N]`` f32, its slot tables ``partner`` (i32) and
    ``slot_act`` (f32, 0 or 1: the kernel keeps each mask as one bit)
    ``[W, C, M]``, and ``inputs``; ``masses`` (``invm, invi, dyn``) stand
    in for the inputs' own, which sleep leaves to each frame. Returns
    ``(posx, posy, ang, velx, vely, angvel, touched [W, Cp, M])``, ``Cp =
    Cs`` when compacting, else C; compacting, two more follow:
    ``partner_solve [W, Cs, M]`` i32 (the table ``touched`` indexes) and
    ``nact [W, 2, M]`` f32 (each row's imminent and pmask-active slots).
    Launches count in ``run_frame2.launches`` (CCD's in ``.ccd_launches``),
    and also in ``.compact_launches`` (compacted), ``.owner_launches``
    (per-world owner tables) and ``.shared_table_launches`` (the whole
    slot table in shared memory); ``.table_rows`` adds the rows each
    world's table holds (``inputs.table_rows``), ``.rows`` its M.
    ``plain=True`` runs the twin even on CUDA tensors (for timing the
    kernel against it)."""
    x = inputs
    W, N = x.kin.shape
    M, C, dev = x.cbody.shape[1], x.C, x.kin.device
    if masses is None and x.invm is None:
        raise ValueError("these inputs hold no masses: pass the frame's "
                         "masses=(invm, invi, dyn)")
    for name, t in zip(("posx", "posy", "ang", "velx", "vely", "angvel",
                        "invm", "invi", "dyn"),
                       (posx, posy, ang, velx, vely, angvel, *(masses or ()))):
        _check(name, t, f32, (W, N), dev)
    for name, t, dtype in (("partner", partner, i32),
                           ("slot_act", slot_act, f32)):
        _check(name, t, dtype, (W, C, M), dev)
    if x.kin.dtype != f32:
        raise ValueError(f"inputs: dtype {x.kin.dtype}, expected {f32}")
    if plain or not _route(dev):
        return frame2_plain(posx, posy, ang, velx, vely, angvel, partner,
                            slot_act, x, masses=masses)

    invm, invi, dyn = masses or (x.invm, x.invi, x.dyn)
    if x.Vk is None:
        raise ValueError(f"frame kernel supports up to {_KERNEL_V[-1]} "
                         f"vertices per collider, got {x.vlx.shape[1]}")
    if x.R is None:
        raise ValueError(
            f"frame kernel needs "
            f"{frame2_shared_bytes(N, M, x.Vk, x.J, x.Csol)} bytes of shared "
            f"memory for the world's state at N={N}, M={M}, V={x.Vk}, "
            f"J={x.J}; a block has {SHARED_LIMIT}")
    Cs, R, rows, h, compact = x.Cs, x.R, x.table_rows, x.h, x.compact
    u8 = torch.uint8
    # table rows past R keep their records in a global table of the same
    # layout; with compaction and CCD the dropped slots go to a side table
    # (the TOI reads them); pose planes that do not fit go to global memory
    gtab = (torch.empty((W, table_bytes(x.Csol, rows - R)), dtype=u8,
                        device=dev) if R < rows else None)
    side = (torch.empty((W, table_bytes(C - Cs, M)), dtype=u8, device=dev)
            if compact and x.ccd else None)
    # the pose planes, the live set and the joint list, where they do not
    # fit in shared memory
    gscratch = (torch.empty((W, x.scratch), dtype=u8, device=dev)
                if x.scratch else None)
    outs = [torch.empty((W, N), dtype=f32, device=dev) for _ in range(6)]
    # compacting: the whole table in rank order, the first Cs returned
    touched = torch.empty((W, C, M), dtype=f32, device=dev)
    o_partner = (torch.empty((W, C, M), dtype=i32, device=dev) if compact
                 else None)
    nact = torch.empty((W, 2, M), dtype=f32, device=dev) if compact else None
    p = _build.ptr
    jptrs = [p(x.joints[k]) if x.joints is not None else None
             for k in _build.JOINT_KEYS + JOINT_SLOT_KEYS]
    args = _build.Frame2Args(
        *(p(t) for t in (posx, posy, ang, velx, vely, angvel, invm, invi,
                         dyn, x.kin, x.cbody, x.kvlx, x.kvly, x.nverts,
                         x.radius, x.fric, x.rest, x.sensor, partner,
                         slot_act, x.gravity, *x.owners)),
        p(gtab) if gtab is not None else None,
        *(p(t) for t in (*outs, touched)),
        W, N, M, x.Vk, C, x.substeps, x.iterations,
        h, x.dt, x.margin, x.compliance / (h * h), x.relaxation, x.max_dpos,
        x.rest_threshold, 1.0 / (1.0 + h * x.lin_damp),
        1.0 / (1.0 + h * x.ang_damp), int(x.lin_damp > 0.0),
        int(x.ang_damp > 0.0), *jptrs, x.J,
        x.JC if x.joints is not None else 0,
        int(x.joint_solver == "colored"), x.n_colors, x.max_dpos_joint,
        h * h, p(x.bullet) if x.ccd else None,
        p(side) if side is not None else None, int(x.ccd), x.ccd_slop,
        int(x.per_world), Cs if compact else 0,
        p(o_partner) if compact else None, p(nact) if compact else None,
        p(gscratch) if gscratch is not None else None,
        p(_live_counter(dev)), p(x.slot_rows), x.Rs)
    _build.launch("sf_frame2", args, dev)
    run_frame2.slot_items += W * x.Csol * M
    run_frame2.table_rows += W * rows
    run_frame2.rows += W * M
    if R == rows:
        run_frame2.shared_table_launches += 1
    if x.ccd:
        run_frame2.ccd_launches += 1
    else:
        run_frame2.launches += 1
    if x.per_world:
        run_frame2.owner_launches += 1
    if not compact:
        return (*outs, touched)
    run_frame2.compact_launches += 1
    return (*outs, touched[:, :Cs].contiguous(),
            o_partner[:, :Cs].contiguous(), nact)


run_frame2.launches = 0
run_frame2.ccd_launches = 0  # the ccd instances', counted apart
run_frame2.compact_launches = 0  # launches with Cs (also in one above)
run_frame2.owner_launches = 0  # launches with per-world owner tables
# launches whose whole slot table sat in shared memory (R = table_rows)
run_frame2.shared_table_launches = 0
# the rows each world's slot table held (M, or Rs where only the rows that
# may hold a slot keep records) and all rows, over every frame run
run_frame2.table_rows = 0
run_frame2.rows = 0
# the frames' live (row, solve slot) items (live_set), counted on the
# device (a [1] int64 tensor, None before the first frame), and all of them
run_frame2.live_items = None
run_frame2.slot_items = 0
