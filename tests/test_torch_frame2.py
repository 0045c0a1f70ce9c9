"""The frame twin (``hopper/frame2.py``) against the JAX package's
``run_frame2`` (Pallas, interpret mode) on the same inputs: a world batch
advanced into contact, its slot tables, one frame through both. ``touched``
equal; positions to 2e-4, angles to 5e-4 and velocities to 2e-2, the
frame-kernel bounds of tests/test_frame2.py."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch.config import Capacity, SolverConfig  # noqa: E402

from _torch_parity import build_pile, frame2_args, jax_run_frame2  # noqa: E402


def _pile(cfg):
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    w, _ = build_pile(st.WorldBuilder, st.Shape, seed=6).build(
        cap, device="cpu")
    return st.replicate_world(w, 2), cfg


def _batched(cfg):
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                  seed=2, device="cpu")
    return sc.world, cfg


CASES = {
    "pile128": (_pile, SolverConfig(substeps=4, slot_capacity=8), 18),
    "batched256": (_batched, SolverConfig(
        substeps=3, slot_capacity=8, frames_per_broadphase=4), 14),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_twin_matches_pallas(case):
    make, cfg, n_frames = CASES[case]
    worlds, cfg = make(cfg)
    # advance into contact (the twin's rollout), then take one frame's
    # inputs: body/collider arrays and fresh K-frame slot tables
    worlds, _, _ = parallel.batched_rollout(worlds, cfg, 0, n_frames,
                                            record=lambda _: None)
    tables = parallel.frame2_tables(worlds, cfg,
                                    frames=cfg.frames_per_broadphase)
    args, inputs = frame2_args(worlds, cfg, tables)
    ref = jax_run_frame2(args, inputs)
    got = hopper.run_frame2(*args, inputs)
    assert hopper.run_frame2.launches == 0  # CPU tensors took the twin

    touched = got[6].numpy()
    assert touched.sum() > 10, "no touching contacts: vacuous"
    np.testing.assert_array_equal(np.asarray(ref[6]), touched)
    names = ("posx", "posy", "ang", "velx", "vely", "angvel")
    tols = (2e-4, 2e-4, 5e-4, 2e-2, 2e-2, 2e-2)
    for name, a, b, tol in zip(names, ref[:6], got[:6], tols):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    # the frame moved things: contacts pushed back against gravity
    assert float(torch.abs(got[4] - args[4]).max()) > 0.1


def test_off_slice_configs_raise():
    """The three branches ported last (compaction, per-world owner tables,
    sleep) step once and return their counters; only a batch the kernels
    cannot hold still raises, naming the single-world tier (A3)."""
    sc = st.scenes.batched_worlds(n_worlds=1, n_bodies=256, substeps=2,
                                  device="cpu")
    import dataclasses

    for kw in (dict(batch_solve_capacity=4),
               dict(batch_uniform_topology=False), dict(sleep_velocity=0.1),
               dict(ccd=True)):
        cfg = dataclasses.replace(sc.config, **kw)
        w, touched, _, _, aux = parallel.frame2_step(sc.world, cfg)
        assert int(w.step_count) == 1
        assert touched.shape[1] == (parallel._batch_solve_cap(cfg) or 8)
        assert {k: int(v) for k, v in aux.items()} == dict(
            joint_overflow=0, owner_overflow=0, solve_overflow=0,
            solve_dropped=0)
    cfg = dataclasses.replace(sc.config, use_pallas=False)
    with pytest.raises(NotImplementedError, match="A3"):
        parallel.frame2_step(sc.world, cfg)


# ---- where the frame kernel keeps its slot table --------------------------
# (hopper.frame2_table_rows: the rows whose records sit in shared memory)

def _phase_shapes():
    """(N, M, V, J, solve slots) of each K4 phase chip_smoke.py runs: the
    main path at its 8 slots, compacted at 4 and 6 of 8 and 8 of 16 (also
    with CCD: the same shapes), the jointed batches, the projectile and
    escorted batches, per-world lists' alternating batch, V = 8."""
    main = st.scenes.batched_worlds(n_worlds=1, n_bodies=256, device="cpu")
    n, m = main.world.bodies.n, main.world.colliders.m
    out = {"main": (n, m, 4, 0, main.config.slot_capacity)}
    for C, Cs in ((8, 4), (8, 6), (16, 8)):
        out[f"compact{Cs}of{C}"] = (n, m, 4, 0, Cs)
    for name in ("mechanism", "rope_bridge"):
        sc = st.scenes.batchify(getattr(st.scenes, name)(device="cpu"), 1)
        w = sc.world
        out[name] = (w.bodies.n, w.colliders.m, 4, w.joints.j,
                     sc.config.slot_capacity)
    out["projectile"] = (128, 128, 4, 0, 8)
    out["escorted"] = (128, 128, 4, 0, 4)
    out["owners_alternating"] = (128, 128, 4, 0, 8)
    out["verts8"] = (128, 128, 8, 0, 8)
    # the benchmark's walker (portbench/scenes/bipedal_walker.py): 199 edge
    # bodies and 5 parts, the hull's five vertices, 12 joint rows, 8 slots
    out["walker"] = (204, 204, 8, 12, 8)
    return out


PHASES = _phase_shapes()


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_every_phase_keeps_its_whole_table_in_shared_memory(phase):
    N, M, V, J, csol = PHASES[phase]
    assert hopper.frame2_table_rows(N, M, V, J, csol) == M
    smem = hopper.frame2_shared_bytes(N, M, V, J, csol)
    table_end = (hopper.frame2.frame2_state_bytes(N, M, V, J) + 16 * N
                 + hopper.frame2.SLOT_BYTES * csol * M)
    # a jointed phase's joint list follows the table, 16-aligned
    assert hopper.frame2.frame2_joints_shared(N, M, V, J, csol) == (J > 0)
    assert smem == (-(-table_end // 16) * 16
                    + hopper.frame2.frame2_joint_bytes(J) if J else table_end)
    assert smem <= hopper.frame2.SHARED_LIMIT
    # and leaves the block's threads (two blocks an SM at 256, else one
    # at 512: csrc/frame2.cuh block_threads) as the table alone did
    two = 2 * (table_end + 1024) <= 233472
    assert (2 * (smem + 1024) <= 233472) == two
    # the live set reuses the set-up's planes: no byte of its own
    assert hopper.frame2.frame2_live_shared(M, V, csol)
    assert hopper.frame2.frame2_scratch_bytes(N, M, V, J, csol) == 0


def test_main_path_table_and_block_bytes():
    """The main path's 2,048 slots: 67 bytes each (16 floats: normal,
    anchors, lambdas and a pass's four row-sum terms; the int16 partner;
    the mask byte), 137,216 bytes beside the 40,964 of the world's state
    and 4,096 of pose planes."""
    assert hopper.frame2.SLOT_BYTES == 67
    assert hopper.frame2.frame2_state_bytes(256, 256, 4, 0) == 40964
    assert hopper.frame2_shared_bytes(256, 256, 4, 0, 8) == (
        40964 + 4096 + 137216)


SPLIT = {  # (N, M, V, J, solve slots) -> (R, pose planes in shared memory)
    "1024x1024": ((1024, 1024, 4, 0, 8), (97, True)),
    "1024x1024_v8": ((1024, 1024, 8, 0, 8), (36, True)),
    "16_slots_uncompacted": ((256, 256, 4, 0, 16), (174, True)),
    "850_joints": ((1024, 1024, 4, 850, 8), (0, False)),
    "state_too_big": ((1024, 1024, 4, 1024, 8), (None, False)),
}


@pytest.mark.parametrize("case", sorted(SPLIT))
def test_table_rows_past_shared_memory(case):
    """Shapes whose table does not fit: rows i >= R go to a global table
    (all of them, and the pose planes too, when the state leaves no room
    for the planes); a state that does not fit is refused (None)."""
    (N, M, V, J, csol), (R, pose_shared) = SPLIT[case]
    assert hopper.frame2_table_rows(N, M, V, J, csol) == R
    state = hopper.frame2.frame2_state_bytes(N, M, V, J)
    smem = hopper.frame2_shared_bytes(N, M, V, J, csol)
    assert smem <= hopper.frame2.SHARED_LIMIT or R is None
    if pose_shared:
        assert smem == state + 16 * N + hopper.frame2.SLOT_BYTES * csol * R
        # one more row would not fit
        assert (smem + hopper.frame2.SLOT_BYTES * csol
                > hopper.frame2.SHARED_LIMIT)
    else:
        assert smem == state
    # pose planes that do not fit go to the world's global scratch
    if R is not None:
        scratch = hopper.frame2.frame2_scratch_bytes(N, M, V, J, csol)
        assert (scratch > 0) == (not pose_shared)


JOINT_LIST = {  # (N, M, V, J, solve slots) -> (R, the joint list shared)
    "walker": ((204, 204, 8, 12, 8), (204, True)),
    "rope_bridge": ((128, 128, 4, 50, 8), (128, True)),
    "rope_bridge_10_slots": ((128, 128, 4, 50, 10), (128, False)),
    "rope_bridge_23_slots": ((128, 128, 4, 50, 23), (128, False)),
    "850_joints": ((1024, 1024, 4, 850, 8), (0, False)),
}


@pytest.mark.parametrize("case", sorted(JOINT_LIST))
def test_joint_list_placement(case):
    """The joint list (64 warp counts and 20 words for each of at most 2J
    items) sits past the slot table where it fits, so no shape loses a
    table row to it, unless it would cost the block its second block an SM
    (the rope bridge at 10 slots); else in the world's global scratch after
    the pose planes and the live set, each 16-aligned."""
    (N, M, V, J, csol), (R, shared) = JOINT_LIST[case]
    f2 = hopper.frame2
    if case == "rope_bridge_10_slots":
        # the table alone leaves two blocks an SM, with the list one
        smem = hopper.frame2_shared_bytes(N, M, V, J, csol)
        assert 2 * (smem + f2.SM_RESERVED) <= f2.SM_BYTES
        top = -(-smem // 16) * 16 + f2.frame2_joint_bytes(J)
        assert top <= f2.SHARED_LIMIT
        assert 2 * (top + f2.SM_RESERVED) > f2.SM_BYTES
    assert f2.frame2_joint_bytes(J) == 4 * (64 + 40 * J)
    assert hopper.frame2_table_rows(N, M, V, J, csol) == R
    assert f2.frame2_joints_shared(N, M, V, J, csol) == shared
    scratch = f2.frame2_scratch_bytes(N, M, V, J, csol)
    if shared:
        assert scratch == 0
    else:
        head = -(-(16 * N + f2.frame2_live_bytes(M, csol)) // 16) * 16
        assert scratch == -(-(head + f2.frame2_joint_bytes(J)) // 16) * 16
    assert f2.frame2_joint_bytes(0) == 0


@pytest.mark.parametrize("V", [4, 8])
def test_eligibility_follows_the_world_state_only(V):
    """``frame2_shapes_ok`` answers as it did before the slot table moved
    into shared memory (the state's bytes within the block, N, M and J
    within 1024) on a grid up to N = M = 1024 and J = MAX_JOINTS, for a
    plain, a compacted and a 32-slot table."""
    from types import SimpleNamespace

    def old_smem(N, M, V, J):  # the parent's frame2_shared_bytes
        return (4 * (19 * N + (2 * V + 9) * M) + 4 * (3 * M + N + 1)
                + (4 * (15 * J + 4 * N) if J > 0 else 0))

    sizes = (1, 128, 256, 512, 700, 1000, 1024, 1025)
    joints = (0, 10, 256, 700, 850, 900, parallel.MAX_JOINTS)
    cfgs = [SolverConfig(slot_capacity=8), SolverConfig(
        slot_capacity=16, batch_solve_capacity=8),
        SolverConfig(slot_capacity=32)]
    n_ok = n_no = 0
    for N in sizes:
        for M in sizes:
            for J in joints:
                w = SimpleNamespace(
                    bodies=SimpleNamespace(n=N), joints=SimpleNamespace(j=J),
                    colliders=SimpleNamespace(m=M, max_verts=V))
                want = (N <= 1024 and M <= 1024 and J <= parallel.MAX_JOINTS
                        and old_smem(N, M, V, J) <= 232448)
                for cfg in cfgs:
                    assert parallel.frame2_shapes_ok(w, cfg) == want, (
                        N, M, J, cfg.slot_capacity)
                n_ok += want
                n_no += not want
    assert n_ok > 50 and n_no > 50


# ---- a table of only the rows that may hold a slot ------------------------
# (hopper.frame2.frame2_layout: where it buys the SM more blocks)


def _floor_batch(n_dynamic=(32, 32), sensor=False):
    """Worlds of ``_torch_parity.build_static_floor``, one a count of
    dynamic bodies (each world its own topology where they differ)."""
    from _torch_parity import build_static_floor

    worlds = []
    for n in n_dynamic:
        b, cap = build_static_floor(st.WorldBuilder, st.Shape, n_dynamic=n,
                                    sensor=sensor)
        worlds.append(b.build(Capacity(**cap), device="cpu")[0])
    return parallel.stack_worlds(worlds)


def _walker_layout():
    """The benchmark's walker (2 CPU envs): 5 of 204 rows may hold a slot,
    so a table of them (51,280 bytes a block in place of 157,952) runs
    four blocks an SM in place of one."""
    from _torch_parity import walker_batch

    cfg, w = walker_batch(2, 6700417, "cpu")
    k4 = parallel.frame2_inputs(w, cfg).k4
    assert (k4.Rs, k4.table_rows, k4.R) == (5, 5, 5)
    lay = hopper.frame2.frame2_layout(204, 204, 8, 12, 8, 5)
    assert lay.ranked and lay.joints_shared and lay.scratch == 0
    # the state, the pose planes, 5 rows' records, 16-aligned, the list
    assert lay.bytes == 51280 == -(-(43156 + 3264 + 5 * 536) // 16) * 16 + 2176
    assert hopper.frame2._sm_blocks(lay.bytes) == 4
    assert hopper.frame2_shared_bytes(204, 204, 8, 12, 8) == 157952
    assert hopper.frame2._sm_blocks(157952) == 1


def _batched_rl_layout():
    """``batched_rl``'s worlds: 253 of 256 rows may hold a slot, which buys
    no block, so the table keeps every row (R = M) and the parent's bytes
    at V = 4 and 8."""
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, device="cpu")
    k4 = parallel.frame2_inputs(sc.world, sc.config).k4
    assert (k4.Rs, k4.table_rows, k4.R) == (253, 256, 256)
    for V, smem in ((4, 182276), (8, 190468)):
        lay = hopper.frame2.frame2_layout(256, 256, V, 0, 8, 253)
        assert not lay.ranked and lay.R == lay.rows == 256
        assert lay.bytes == smem == hopper.frame2_shared_bytes(
            256, 256, V, 0, 8)


def _per_world_owners_layout():
    """Per-world owner lists on worlds that differ in the rows that may
    hold a slot (32 and 24 dynamic bodies): Rs is the larger count."""
    w = _floor_batch((32, 24))
    cfg = SolverConfig(substeps=4, slot_capacity=8,
                       batch_uniform_topology=False)
    x = parallel.frame2_inputs(w, cfg)
    assert x.k4.slot_rows.sum(dim=1).tolist() == [32.0, 24.0]
    assert (x.k4.Rs, x.k4.table_rows, x.k4.R) == (32, 32, 32)
    # every row's table: one block an SM; the 32 rows': two
    assert hopper.frame2._sm_blocks(hopper.frame2_shared_bytes(
        256, 256, 4, 0, 8)) == 1
    assert hopper.frame2._sm_blocks(hopper.frame2_shared_bytes(
        256, 256, 4, 0, 8, 32)) == 2


def _ranked_tables_never_split():
    """Over a grid of shapes, a ranked table (chosen only where it buys a
    block) keeps every row in shared memory: a table that spills holds
    the block above half an SM. Where Rs rows buy no block, the layout is
    every row's, bit for bit."""
    n_ranked = 0
    for N in (64, 128, 204, 256, 512, 1024):
        for V, J, csol in ((4, 0, 8), (8, 12, 8), (4, 50, 16), (4, 0, 32)):
            every = hopper.frame2.frame2_layout(N, N, V, J, csol)
            for Rs in (1, 5, N // 8, N // 2, N - 3, N):
                lay = hopper.frame2.frame2_layout(N, N, V, J, csol, Rs)
                if lay.ranked:
                    n_ranked += 1
                    assert lay.R == lay.rows == Rs
                    assert (hopper.frame2._sm_blocks(lay.bytes)
                            > hopper.frame2._sm_blocks(every.bytes))
                else:
                    assert lay == every
    assert n_ranked > 20


RANKED = {"walker": _walker_layout, "batched_rl": _batched_rl_layout,
          "per_world_owners": _per_world_owners_layout,
          "never_split": _ranked_tables_never_split}


@pytest.mark.parametrize("case", sorted(RANKED))
def test_table_of_the_rows_that_may_hold_a_slot(case):
    """Where K4's table holds only the rows that may hold a slot (K1's row
    rule; Rs: the most of any world, one host read a call): the walker
    gets four blocks an SM, ``batched_rl`` keeps the parent's layout, per-
    world owners take the largest world's count."""
    RANKED[case]()


def _moving_sensor():
    """A floor batch with a sensor tile (a row that may not hold a slot)
    and a sensor on a kinematic body (one that may), 5 frames in."""
    w = _floor_batch((32, 32), sensor=True)
    cfg = SolverConfig(substeps=4, slot_capacity=8)
    w = parallel.batched_rollout(w, cfg, 0, 5, record=lambda _: None)[0]
    return cfg, w


def _walker_frames():
    from _torch_parity import walker_batch

    return walker_batch(2, 6700417, "cpu", frames=20)


@pytest.mark.parametrize("case", ["moving_sensor", "walker"])
def test_tables_hold_no_slot_outside_the_row_rule(case):
    """What K4's table of only some rows rests on: K2's plain tables hold
    no slot on a row that K1's row rule (``parallel._slot_rows``)
    excludes, and rows it admits do hold slots."""
    cfg, w = (_moving_sensor if case == "moving_sensor" else _walker_frames)()
    x = parallel.frame2_inputs(w, cfg)
    rows = x.k4.slot_rows
    _, act, *_ = parallel.frame2_tables(
        w, cfg, frames=max(cfg.frames_per_broadphase, 1), plain=True)
    assert float((act * (1.0 - rows)[:, None, :]).sum()) == 0.0
    assert float(act.sum()) > 0, "no slot at all: vacuous"
    assert int(rows.sum(dim=1).max()) == x.k4.Rs < w.colliders.m
    if case == "moving_sensor":
        # the kinematic sensor (the last row) holds slots; the static
        # sensor tile (row 0) may not
        assert bool((rows[:, -1] == 1).all()) and bool((rows[:, 0] == 0).all())
        assert float(act[:, :, -1].sum()) > 0


def test_slot_record_layout_matches_the_kernel_source():
    """The CUDA header's record (its float fields, the shared-memory limit)
    is what the wrapper sizes tables by (checked here without nvcc; the
    library checks it again when it loads)."""
    import re
    from pathlib import Path

    src = (Path(hopper.frame2.__file__).parent.parent / "csrc"
           / "common.cuh").read_text()
    enum = re.search(r"enum Frame2Field \{(.*?)F2_FIELDS", src, re.S).group(1)
    fields = re.findall(r"\bF2_[A-Z0-9]+\b", enum)
    assert len(fields) == hopper.frame2.SCRATCH_FIELDS
    assert re.search(r"#define F2_SLOT_BYTES \(4 \* F2_FIELDS \+ 3\)", src)
    limit = int(re.search(r"#define F2_SHARED_LIMIT (\d+)", src).group(1))
    assert limit == hopper.frame2.SHARED_LIMIT


# ---- the live set: the (row, slot) items the slot phases walk -------------

LIVE_SHARED = {  # (M, V, solve slots) -> the live set in the set-up's planes
    "main": ((256, 4, 8), True),
    "1024_rows": ((1024, 4, 8), True),
    "16_slots": ((256, 4, 16), True),
    "27_slots": ((256, 4, 27), True),
    "28_slots": ((256, 4, 28), False),
    "32_slots_v8": ((256, 8, 32), True),
}


@pytest.mark.parametrize("case", sorted(LIVE_SHARED))
def test_live_set_placement(case):
    """The live set (64 warp counts, a uint32 of row bits a row and 32
    slots, a uint16 entry an item) takes the (2V + 7) M words only the
    set-up reads where it fits; a wider table keeps it in global memory."""
    (M, V, csol), shared = LIVE_SHARED[case]
    live = hopper.frame2.frame2_live_bytes(M, csol)
    assert live == 4 * (64 + -(-csol // 32) * M) + 2 * csol * M
    assert hopper.frame2.frame2_live_shared(M, V, csol) == shared
    assert (live <= 4 * (2 * V + 7) * M) == shared
    # a global live set sits after the pose planes in the world's scratch
    scratch = hopper.frame2.frame2_scratch_bytes(M, M, V, 0, csol)
    assert scratch == (0 if shared else -(-(16 * M + live) // 16) * 16)


def _frame_masks(C, Cs, monkeypatch):
    """One twin frame of a 2-world batch 40 frames into contact at C slots
    (compacted to Cs): ``(pm [W, Csol * M] bool, the twin's outputs, M)``,
    pm the live set's input."""
    import dataclasses

    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                  seed=2, device="cpu")
    cfg = dataclasses.replace(sc.config, slot_capacity=C,
                              batch_solve_capacity=Cs)
    w, _, _ = parallel.batched_rollout(sc.world, cfg, 0, 40,
                                       record=lambda _: None)
    seen, outs = [], []
    model, call = hopper.frame2.live_set, parallel.run_frame2
    monkeypatch.setattr(hopper.frame2, "live_set",
                        lambda pm, M: seen.append(pm) or model(pm, M))
    monkeypatch.setattr(parallel, "run_frame2",
                        lambda *a, **k: outs.append(call(*a, **k)) or outs[-1])
    parallel.frame2_step(w, cfg)
    assert len(seen) == len(outs) == 1
    return seen[0], outs[0], w.colliders.m


LIVE_MODEL = {"uncompacted": (8, 0), "cs4of8": (8, 4), "cs8of16": (16, 8),
              "all_empty": None, "all_live": None}


@pytest.mark.parametrize("case", sorted(LIVE_MODEL))
def test_live_set_model(case, monkeypatch):
    """``live_set``: each world's live items in ascending u = c * M + i
    (the rest -1) and row i's live slots as bits, against a plain loop;
    on a frame's real masks (with compaction the live count is each row's
    pmask-active slots, at most Cs) and on an all-empty and all-live
    table."""
    if LIVE_MODEL[case] is None:
        M, Csol = 40, 36  # two words of row bits
        pm = torch.full((2, Csol * M), case == "all_live")
    else:
        C, Cs = LIVE_MODEL[case]
        pm, _, M = _frame_masks(C, Cs, monkeypatch)
        Csol = pm.shape[1] // M
        assert Csol == (Cs or C)
        assert 0 < int(pm.sum()) < pm.numel(), "vacuous masks"
    items, n, bits = hopper.frame2.live_set(pm, M)
    W, T = pm.shape
    for w in range(W):
        want = [u for u in range(T) if pm[w, u]]
        assert int(n[w]) == len(want)
        assert items[w, :len(want)].tolist() == want
        assert bool((items[w, len(want):] == -1).all())
    c = torch.arange(Csol)
    got = (bits[:, c // 32, :] >> (c % 32)[None, :, None]) & 1
    assert torch.equal(got.bool(), pm.reshape(W, Csol, M))
    if case == "all_empty":
        assert int(n.sum()) == 0 and int(bits.sum()) == 0


def test_live_set_counts_the_compacted_table(monkeypatch):
    """With compaction the live set is the table's first Cs ranks: each
    row's pmask-active slots (``nact[:, 1]``, counted over all C) up to
    Cs."""
    pm, outs, M = _frame_masks(8, 4, monkeypatch)
    W, nact = pm.shape[0], outs[8]
    live = hopper.frame2.live_set(pm, M)[1]
    assert torch.equal(live, nact[:, 1].clamp(max=4).sum(dim=1).long())
    assert bool((nact[:, 1] > 4).any()), "no row past Cs: vacuous"
    assert int(live.sum()) < W * 4 * M


def test_live_counters_match_the_twin_pmask(monkeypatch):
    """``run_frame2.live_items`` / ``slot_items`` over 8 CPU frames of a
    2-world 256-body batch: each frame's slots with an active manifold
    point (the twin's pmask: the manifold's point masks x K2's slot_act),
    and W * C * M a frame."""
    from starframe_tpu_torch.hopper import frame2 as f2

    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                  seed=2, device="cpu")
    w, cfg = sc.world, sc.config
    acts, pmasks = [], []
    call, mb = parallel.run_frame2, f2.manifold_batch

    def run(*args, **kw):
        acts.append(args[7])  # slot_act
        return call(*args, **kw)

    def manifold(*args):
        m = mb(*args)
        pmasks.append(m.pmask)
        return m

    monkeypatch.setattr(parallel, "run_frame2", run)
    monkeypatch.setattr(f2, "manifold_batch", manifold)
    monkeypatch.setattr(f2.run_frame2, "live_items", None)
    monkeypatch.setattr(f2.run_frame2, "slot_items", 0)
    parallel.batched_rollout(w, cfg, 0, 8, record=lambda _: None)
    assert len(acts) == len(pmasks) == 8
    W, C, M = acts[0].shape
    want = sum(int(((pm * a.reshape(W, C * M)[None]).amax(dim=0) > 0).sum())
               for pm, a in zip(pmasks, acts))
    assert want > 0
    assert f2.run_frame2.live_items.dtype == torch.int64
    assert int(f2.run_frame2.live_items) == want
    assert f2.run_frame2.slot_items == 8 * W * C * M
    assert want < f2.run_frame2.slot_items
