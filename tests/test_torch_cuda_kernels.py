"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: they skip without ``torch.cuda.is_available()``. Run them
on a machine with an H100 (the suite's conftest imports jax, which that
machine lacks, hence ``--noconftest``)::

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py -q

Tolerances: eligibility, the integer slot tables and the joint slots are
exact (the kernels compute the same compares on the same f32 boxes and
indices); the slot budget to 1e-6; one frame's poses to 1e-4 and
velocities to 1e-3, with or without joints (the kernel sums the same terms
in the same order as the twin, so what remains is the last bit of
``cosf``/``sinf`` and of the frame's contact thresholds). The tile
engine's kernels: integer outputs and ``touched`` equal, the rest as each
test states.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch.config import Capacity, SolverConfig  # noqa: E402
from starframe_tpu_torch.scenes import (  # noqa: E402
    batched_worlds,
    batchify,
    mechanism,
    rope_bridge,
)
from starframe_tpu_torch.shapes import Shape  # noqa: E402
from starframe_tpu_torch.state import BODY_BULLET, WorldBuilder  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sc = batched_worlds(n_worlds=64, n_bodies=256, substeps=4,
                        device="cuda")
    # a few frames in, so the tables and manifolds hold real contacts
    w, _, _ = parallel.batched_rollout(sc.world, sc.config, 0, 40,
                                       record=lambda _: None)
    return sc.config, w


def test_elig_kernel_matches_twin(scene):
    cfg, w = scene
    args = parallel.frame2_inputs(w, cfg).elig
    n0 = hopper.build_elig_mask.launches
    got = hopper.build_elig_mask(*args)
    assert hopper.build_elig_mask.launches == n0 + 1
    assert torch.equal(got, hopper.elig_mask_plain(*args))


@pytest.mark.parametrize("frames", [1, 4])
def test_slot_kernel_matches_twin(scene, frames):
    cfg, w = scene
    elig = parallel.frame2_elig(w, cfg)
    n0 = hopper.build_slot_tables.launches
    got, gb = parallel.frame2_tables(w, cfg, frames=frames, elig=elig,
                                     return_budget=True)
    assert hopper.build_slot_tables.launches == n0 + 1
    ref, rb = parallel.frame2_tables(w, cfg, frames=frames, elig=elig,
                                     return_budget=True, plain=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    torch.testing.assert_close(gb, rb, rtol=0, atol=1e-6)
    assert int(got[3].max()) > 0, "no touching candidates: vacuous"


def _edge_world(n, worlds, max_verts=4, shuffle=False):
    """``worlds`` copies of ``_torch_parity.build_pile``'s ``n``-collider
    pile edited by ``slot_edge_arrays`` (layers 0 and 31, a moving sensor,
    collider 7 off in world 1, jostled and squeezed worlds), optionally with
    the colliders in a shuffled index order; on the card."""
    from _torch_parity import build_pile, shuffle_colliders, slot_edge_arrays

    from starframe_tpu_torch import io as tio

    b = build_pile(WorldBuilder, Shape, n=n, seed=3, sensor_idx=4)
    world, _ = b.build(Capacity(max_bodies=n, max_colliders=n,
                                max_pairs=8 * n, max_joints=0,
                                max_verts=max_verts), device="cuda")
    a = slot_edge_arrays(tio.world_to_numpy(
        parallel.replicate_world(world, worlds)))
    return tio.world_from_numpy(shuffle_colliders(a) if shuffle else a,
                                "cuda")


def _slot_kernels_match_twins(w, cfg):
    """K1 and K2 (``partner_aware`` off and on) against their twins: the
    mask and the integer tables equal, the budget to 1e-6. Returns the
    partner-aware counts."""
    n0 = hopper.build_elig_mask.launches
    elig = parallel.frame2_elig(w, cfg)
    assert hopper.build_elig_mask.launches == n0 + 1
    assert torch.equal(elig, parallel.frame2_elig(w, cfg, plain=True))
    for frames in (1, 4):
        n0 = hopper.build_slot_tables.launches
        got, gb = parallel.frame2_tables(w, cfg, frames=frames, elig=elig,
                                         return_budget=True)
        assert hopper.build_slot_tables.launches == n0 + 1
        ref, rb = parallel.frame2_tables(w, cfg, frames=frames, elig=elig,
                                         return_budget=True, plain=True)
        for name, a, b in zip(("partner", "slot_act", "count",
                               "count_touch", "count_close"), got, ref):
            assert torch.equal(a, b), (frames, name)
        torch.testing.assert_close(gb, rb, rtol=0, atol=1e-6)
    return got[2:5]


@pytest.mark.parametrize("n, worlds, C, max_verts", [
    (1024, 4, 32, 4),  # the widest M: 32 chunks, 512 threads
    (200, 8, 32, 4),   # a partial last chunk; K2's byte-wise mask loads
    (130, 8, 32, 4),   # K1's unaligned rows, stored byte by byte
    (200, 8, 1, 4),
    (200, 8, 8, 8),    # V = 8
])
def test_slot_kernels_match_twins_at_edges(n, worlds, C, max_verts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    w = _edge_world(n, worlds, max_verts)
    count, touch, _ = _slot_kernels_match_twins(
        w, SolverConfig(slot_capacity=C, frames_per_broadphase=4))
    assert int(touch.max()) > C and int(count.max()) > C, "no overflow"


def test_elig_kernel_matches_twin_at_4096_colliders():
    """K1 alone (K2 takes at most 1024 colliders) at its widest, 4096
    colliders, a 16-collider group of each row a thread; one more collider
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    w = _edge_world(4096, 1)
    cfg = SolverConfig()
    elig = parallel.frame2_elig(w, cfg)
    assert torch.equal(elig, parallel.frame2_elig(w, cfg, plain=True))
    assert int(elig.sum()) > 0
    with pytest.raises(RuntimeError, match="sf_elig"):
        parallel.frame2_elig(_edge_world(4097, 1), cfg)


def test_slot_kernels_match_twins_shuffled(scene):
    """The main path's settled batch with its colliders in a shuffled index
    order, where few 32-partner chunks are culled (in the WorldBuilder's
    spatially coherent order, the tests above, about half are): both
    kernels equal to their twins. The rank order follows the index, so the
    two orders' tables are not compared with each other."""
    from _torch_parity import shuffle_colliders

    from starframe_tpu_torch import io as tio

    cfg, w = scene
    w = tio.world_from_numpy(shuffle_colliders(tio.world_to_numpy(w)), "cuda")
    _, touch, _ = _slot_kernels_match_twins(w, cfg)
    assert int(touch.sum()) > 0, "no touching candidates: vacuous"


def _bulleted(w):
    """``w`` with every dynamic body flagged a bullet (CCD's TOI pass then
    runs on every row)."""
    b = w.bodies
    flags = torch.where(b.inv_mass > 0, b.flags | BODY_BULLET, b.flags)
    return dataclasses.replace(w, bodies=dataclasses.replace(b, flags=flags))


def _live_counts():
    """``(live, slots)``: ``run_frame2``'s item counters now."""
    live = hopper.run_frame2.live_items
    return (0 if live is None else int(live.sum()),
            hopper.run_frame2.slot_items)


def _every_row(inputs):
    """``inputs`` (``parallel.frame2_inputs``) with every row flagged as one
    that may hold a slot: K4 then keeps a record for every row (the layout
    of a shape whose rows that may hold a slot buy no block)."""
    k4 = inputs.k4
    return dataclasses.replace(inputs, k4=dataclasses.replace(
        k4, slot_rows=torch.ones_like(k4.slot_rows)))


def _frame_kernel_matches_twin(cfg, w, touching=True, inputs=None):
    tables = parallel.frame2_tables(w, cfg,
                                    frames=max(cfg.frames_per_broadphase, 1),
                                    elig=parallel.frame2_elig(w, cfg))
    counter = "ccd_launches" if cfg.ccd else "launches"
    n0 = getattr(hopper.run_frame2, counter)
    c0 = hopper.run_frame2.compact_launches
    o0 = hopper.run_frame2.owner_launches
    live, slots = _live_counts()
    wk, tk, pk, _, ak = parallel.frame2_step(w, cfg, tables=tables,
                                             inputs=inputs)
    assert getattr(hopper.run_frame2, counter) == n0 + 1
    compact = 0 < cfg.batch_solve_capacity < cfg.slot_capacity
    assert hopper.run_frame2.compact_launches == c0 + compact
    assert hopper.run_frame2.owner_launches == o0 + (
        not cfg.batch_uniform_topology)
    # the kernel's live items (its device counter) are the twin's count
    live_k, slots_k = _live_counts()
    wp, tp, pp, _, ap = parallel.frame2_step(w, cfg, tables=tables,
                                             inputs=inputs, plain=True)
    live_p, slots_p = _live_counts()
    assert 0 < live_k - live == live_p - live_k < slots_k - slots
    assert slots_k - slots == slots_p - slots_k
    assert torch.equal(tk, tp)
    assert torch.equal(pk, pp)  # partner_solve when compacting
    assert {k: int(v) for k, v in ak.items()} == {
        k: int(v) for k, v in ap.items()}
    assert not touching or float(tk.sum()) > 0, "no touching contacts: vacuous"
    bk, bp = wk.bodies, wp.bodies
    torch.testing.assert_close(bk.pos, bp.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(bk.angle, bp.angle, rtol=0, atol=1e-4)
    torch.testing.assert_close(bk.vel, bp.vel, rtol=0, atol=1e-3)
    torch.testing.assert_close(bk.ang_vel, bp.ang_vel, rtol=0, atol=1e-3)
    assert torch.equal(bk.sleep_count, bp.sleep_count)
    return ak


def test_frame_kernel_matches_twin(scene):
    _frame_kernel_matches_twin(*scene)


def test_frame_kernel_ccd_matches_twin(scene):
    """K4's CCD instance on the settled batch with every dynamic body a
    bullet, and on tests/test_ccd.py's bullet batch mid-impact (1000 m/s,
    the third frame): the non-CCD bounds."""
    cfg, w = scene
    _frame_kernel_matches_twin(dataclasses.replace(cfg, ccd=True),
                               _bulleted(w))
    b = WorldBuilder()
    b.gravity = (0.0, 0.0)
    wall = b.add_static(pos=(0.0, 0.0))
    b.add_collider(wall, Shape.box(0.1, 2.0))
    bullet = b.add_body(pos=(-3.0, 0.0), vel=(1000.0, 0.0), bullet=True)
    b.add_collider(bullet, Shape.circle(0.05))
    for i in range(126):
        pad = b.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        b.add_collider(pad, Shape.circle(0.3))
    world, _ = b.build(Capacity(max_bodies=128, max_colliders=128,
                                max_pairs=512, max_joints=0, max_verts=4),
                       device="cuda")
    bw = parallel.replicate_world(world, 4)
    bcfg = SolverConfig(substeps=10, slot_capacity=8, ccd=True)
    bw, _, _ = parallel.batched_rollout(bw, bcfg, 0, 2, record=lambda _: None)
    _frame_kernel_matches_twin(bcfg, bw)


def test_frame_kernel_live_set_in_global_memory_matches_twin(scene):
    """A table too wide for the set-up's planes (V = 4, C = 32) keeps its
    live set in global memory beside the pose planes: the kernel against
    its twin, its live count the twin's."""
    cfg, w = scene
    assert not hopper.frame2.frame2_live_shared(w.colliders.m, 4, 32)
    _frame_kernel_matches_twin(dataclasses.replace(cfg, slot_capacity=32), w)


def test_live_counter_is_one_device_tensor(scene):
    """The live counter is allocated once: frames add to the same int64
    tensor on the card, with no host read."""
    cfg, w = scene
    parallel.frame2_step(w, cfg)
    live = hopper.run_frame2.live_items
    assert live.device.type == "cuda" and live.dtype == torch.int64
    before = int(live.sum())
    parallel.frame2_step(w, cfg)
    assert hopper.run_frame2.live_items is live
    assert int(live.sum()) > before


@pytest.mark.parametrize("ccd", [False, True])
def test_frame_kernel_compact_matches_twin(scene, ccd):
    """K4's ``Cs`` form (C = 8, Cs = 4) on the settled batch, without and
    with CCD (every dynamic body a bullet): ``touched``, ``partner_solve``
    and the solve counters equal, ``nact`` equal on a direct call, poses
    and velocities to the non-compacted bounds."""
    from _torch_parity import frame2_args

    cfg, w = scene
    cfg = dataclasses.replace(cfg, batch_solve_capacity=4, ccd=ccd)
    if ccd:
        w = _bulleted(w)
    _frame_kernel_matches_twin(cfg, w)
    args, inputs = frame2_args(w, cfg, parallel.frame2_tables(w, cfg))
    k = hopper.run_frame2(*args, inputs)
    p = hopper.run_frame2(*args, inputs, plain=True)
    assert torch.equal(k[7], p[7]) and torch.equal(k[8], p[8])
    assert int(k[8][:, 1].max()) > 4, "no row has more than Cs: vacuous"


def _escorted(escorts, worlds=4):
    """The escorted bullet batch of ``_torch_parity.build_escorted`` on the
    card: a bullet at 1000 m/s, ``escorts`` static circles 0.02 m from it
    and a thin wall 3 m ahead, which ranks after every escort."""
    from _torch_parity import build_escorted

    b, cap = build_escorted(WorldBuilder, Shape, escorts)
    world, _ = b.build(Capacity(**cap), device="cuda")
    return parallel.replicate_world(world, worlds)


def test_frame_kernel_compact_ccd_takes_the_whole_table():
    """The bullet's wall slot ranks past Cs and is dropped from the solve;
    the kernel's TOI still sees it (the dropped slots' anchors computed at
    the substep-start pose), as the twin's does: equal to the twin in the
    impact frame, and the bullet on the wall's face after three frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = SolverConfig(substeps=10, slot_capacity=8, ccd=True,
                       batch_solve_capacity=4)
    w = _escorted(4)
    # no solved slot touches: the wall's is dropped, the escorts' do not
    aux = _frame_kernel_matches_twin(cfg, w, touching=False)
    assert int(aux["solve_dropped"]) == 4  # the wall, in each world
    w, _, _ = parallel.batched_rollout(w, cfg, 0, 3, record=lambda _: None)
    x = w.bodies.pos[:, 1, 0]
    assert bool(((x > -0.21) & (x <= -0.14)).all()), x


def test_frame_kernel_per_world_owners_matches_twin(scene):
    """K4 with per-world owner tables: bitwise the uniform kernel on a
    batch of one topology, and against its twin on two alternating
    topologies (one-collider bodies and 3-collider compounds)."""
    cfg, w = scene
    het = dataclasses.replace(cfg, batch_uniform_topology=False)
    tables = parallel.frame2_tables(w, cfg)
    a = parallel.frame2_step(w, cfg, tables=tables)[0].bodies
    b = parallel.frame2_step(w, het, tables=tables)[0].bodies
    for f in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    from _torch_parity import build_compound128, build_pile

    worlds = []
    for make in (build_pile, build_compound128):
        out = make(WorldBuilder, Shape)
        builder = out[0] if isinstance(out, tuple) else out
        world, _ = builder.build(Capacity(
            max_bodies=128, max_colliders=128, max_pairs=1024, max_joints=0,
            max_verts=4), device="cuda")
        worlds.append(world)
    batch = parallel.stack_worlds(worlds * 16)
    hcfg = SolverConfig(substeps=4, slot_capacity=8,
                        batch_uniform_topology=False,
                        max_colliders_per_body=3)
    batch, _, diag = parallel.batched_rollout(batch, hcfg, 0, 12,
                                              record=lambda _: None)
    assert int(diag["owner_overflow"]) == 0
    _frame_kernel_matches_twin(hcfg, batch)


def test_sleeping_rollout_is_bitwise_reproducible(scene):
    """Sleep on (``sleep_velocity`` 0.1, 5 frames): a rerun is bitwise the
    same, and an asleep body's pose stays bitwise unchanged."""
    cfg, w = scene
    cfg = dataclasses.replace(cfg, sleep_velocity=0.1, sleep_frames=5)
    a, _, _ = parallel.batched_rollout(w, cfg, 0, 12, record=lambda _: None)
    b, _, _ = parallel.batched_rollout(w, cfg, 0, 12, record=lambda _: None)
    for f in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    asleep = parallel._asleep(a.bodies, cfg)
    assert bool(asleep.any()), "nothing fell asleep: vacuous"
    c = parallel.frame2_step(a, cfg)[0]
    still = asleep & parallel._asleep(c.bodies, cfg)
    assert torch.equal(c.bodies.pos[still], a.bodies.pos[still])
    _frame_kernel_matches_twin(cfg, a)


# vertex capacity -> the shapes of a pile that fills it (on a capsule
# ground, 2 vertices). The kernel is compiled for 4 and 8 vertices: 3 and 5
# go through the wrapper's padding (copies of vertex 0), 8 is the default
# Capacity.max_verts.
PILE_SHAPES = {
    3: (Shape.circle(0.45), Shape.regular_polygon(3, 0.5),
        Shape.capsule(0.3, 0.2)),
    5: (Shape.circle(0.45), Shape.box(0.4, 0.35),
        Shape.regular_polygon(5, 0.45)),
    8: (Shape.circle(0.45), Shape.box(0.4, 0.35), Shape.hexagon(0.45),
        Shape.regular_polygon(8, 0.45)),
}


@pytest.mark.parametrize("max_verts", sorted(PILE_SHAPES))
def test_frame_kernel_matches_twin_vertex_widths(max_verts):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    shapes = PILE_SHAPES[max_verts]
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.capsule(40.0, 0.5), friction=0.5)
    for i in range(127):
        row, col = divmod(i, 16)
        body = b.add_body(pos=(-8.25 + col * 1.1, 0.7 + row * 1.1))
        b.add_collider(body, shapes[i % len(shapes)], friction=0.5,
                       restitution=0.2)
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=max_verts)
    world, _ = b.build(cap, device="cuda")
    assert world.colliders.verts.shape[-2] == max_verts
    assert int(world.colliders.nverts.max()) == max_verts
    w = parallel.replicate_world(world, 64)
    noise = 0.1 * np.random.default_rng(3).standard_normal(
        tuple(w.bodies.vel.shape), dtype=np.float32)
    dyn = (w.bodies.inv_mass > 0)[..., None]
    vel = torch.where(dyn, w.bodies.vel + torch.as_tensor(noise, device="cuda"),
                      w.bodies.vel)
    w = dataclasses.replace(w, bodies=dataclasses.replace(w.bodies, vel=vel))
    cfg = SolverConfig(substeps=4, frames_per_broadphase=4)
    w, _, _ = parallel.batched_rollout(w, cfg, 0, 40, record=lambda _: None)
    _frame_kernel_matches_twin(cfg, w)


def test_rollout_is_bitwise_reproducible(scene):
    cfg, w = scene
    a, _, da = parallel.batched_rollout(w, cfg, 0, 6, record=lambda _: None)
    b, _, db = parallel.batched_rollout(w, cfg, 0, 6, record=lambda _: None)
    assert torch.equal(a.bodies.pos, b.bodies.pos)
    assert torch.equal(a.bodies.vel, b.bodies.vel)
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}


@pytest.fixture(scope="module")
def split_table():
    """Shapes whose slot table does not fit in shared memory beside the
    world's state: 4 worlds of 1024 bodies (R = 97 of 1024 rows at C = 8)
    and 2 worlds of 1024 bodies with 850 distance joints (the pose planes
    do not fit either: R = 0, everything in global memory), 40 frames into
    contact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sc = batched_worlds(n_worlds=4, n_bodies=1024, substeps=4,
                        device="cuda")
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(60.0, 0.5), friction=0.5)
    ids = []
    for i in range(1023):
        row, col = divmod(i, 40)
        body = b.add_body(pos=(-22.0 + col * 1.1, 0.6 + row * 1.1))
        b.add_collider(body, Shape.circle(0.45) if i % 2 else
                       Shape.box(0.45, 0.45), friction=0.5)
        ids.append(body)
    for k in range(850):
        b.distance_joint(ids[k], ids[k + 1])
    jw, _ = b.build(Capacity(max_bodies=1024, max_colliders=1024,
                             max_pairs=8192, max_joints=850, max_verts=4),
                    device="cuda")
    jcfg = SolverConfig(substeps=4, frames_per_broadphase=4)
    out = {}
    for name, w, cfg in (("contacts", sc.world, sc.config),
                         ("joints", parallel.replicate_world(jw, 2), jcfg)):
        w, _, _ = parallel.batched_rollout(w, cfg, 0, 40,
                                           record=lambda _: None)
        out[name] = (cfg, w)
    return out


SPLIT_FORMS = {
    "contacts": ("contacts", {}),
    "ccd": ("contacts", dict(ccd=True)),
    "compact_ccd": ("contacts", dict(ccd=True, slot_capacity=16,
                                     batch_solve_capacity=8)),
    "joints_pose_in_global": ("joints", {}),
}


@pytest.mark.parametrize("form", sorted(SPLIT_FORMS))
def test_frame_kernel_split_table_matches_twin(split_table, form):
    """K4 with rows i >= R in the global table (and, with 850 joints, the
    pose planes too) against its twin: the tolerances of the whole-table
    forms; the launch is not counted as a shared-table one."""
    scene, kw = SPLIT_FORMS[form]
    cfg, w = split_table[scene]
    cfg = dataclasses.replace(cfg, **kw)
    if cfg.ccd:
        w = _bulleted(w)
    csol = parallel._batch_solve_cap(cfg) or cfg.slot_capacity
    R = hopper.frame2_table_rows(w.bodies.n, w.colliders.m, 4, w.joints.j,
                                 csol)
    assert R == (0 if scene == "joints" else 97), R
    n0 = hopper.run_frame2.shared_table_launches
    _frame_kernel_matches_twin(cfg, w)
    assert hopper.run_frame2.shared_table_launches == n0


@pytest.mark.parametrize("scene_name", ["contacts", "joints"])
def test_split_table_rollout_is_bitwise_reproducible(split_table, scene_name):
    cfg, w = split_table[scene_name]
    a, _, da = parallel.batched_rollout(w, cfg, 0, 4, record=lambda _: None)
    b, _, db = parallel.batched_rollout(w, cfg, 0, 4, record=lambda _: None)
    for field in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, field), getattr(b.bodies, field))
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}


def test_main_scene_table_is_shared(scene):
    """The main path's shapes keep every row's records in shared memory
    (R = M), counted in run_frame2.shared_table_launches."""
    cfg, w = scene
    n0 = hopper.run_frame2.shared_table_launches
    parallel.frame2_step(w, cfg)
    assert hopper.run_frame2.shared_table_launches == n0 + 1


JOINTED = {"mechanism": mechanism, "rope_bridge": rope_bridge}


@pytest.fixture(scope="module")
def jointed():
    """Both jointed batches at 64 worlds, 30 frames in (the wheel's paddles
    among the circles, the loads on the rope)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    out = {}
    for name, make in JOINTED.items():
        sc = batchify(make(substeps=4, device="cuda"), 64)
        w, _, _ = parallel.batched_rollout(sc.world, sc.config, 0, 30,
                                           record=lambda _: None)
        out[name] = (sc.config, w)
    return out


@pytest.mark.parametrize("JC", [4, 2])
@pytest.mark.parametrize("name", sorted(JOINTED))
def test_joint_slot_kernel_matches_twin(jointed, name, JC):
    cfg, w = jointed[name]
    cfg = dataclasses.replace(cfg, joint_slot_capacity=JC)
    n0 = hopper.build_joint_slots.launches
    got = parallel.frame2_joint_slots(w, cfg)
    assert hopper.build_joint_slots.launches == n0 + 1
    ref = parallel.frame2_joint_slots(w, cfg, plain=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[3].max()) >= 2
    overflow = parallel.frame2_inputs(w, cfg).joint_overflow
    # JC = 2: the rope's middle particle holds three joints
    assert int(overflow) == (64 if (JC == 2 and name == "rope_bridge")
                             else 0)


@pytest.mark.parametrize("solver", ["colored", "jacobi"])
@pytest.mark.parametrize("name", sorted(JOINTED))
def test_frame_kernel_with_joints_matches_twin(jointed, name, solver):
    cfg, w = jointed[name]
    _frame_kernel_matches_twin(
        dataclasses.replace(cfg, joint_solver=solver), w)


@pytest.mark.parametrize("solver", ["colored", "jacobi"])
@pytest.mark.parametrize("case", ["rope_bridge_10_slots",
                                  "rope_bridge_23_slots", "850_joints"])
def test_frame_kernel_joint_list_in_global_memory_matches_twin(
        jointed, split_table, case, solver):
    """A joint list that does not fit past the slot table, or would cost
    the block its second block an SM there, goes to the world's global
    scratch, through the same accessor: the rope bridge at 10 slots (two
    256-thread blocks an SM) and at 23 (R = M and the pose planes and live
    set in shared memory, so the list alone is global) and the 850-joint
    batch (everything global), against the twin, both tiers; every row
    keeps a record (at 23 slots the rope's 47 rows that may hold a slot
    would leave the list room in shared memory)."""
    if case == "850_joints":
        cfg, w = split_table["joints"]
    else:
        cfg, w = jointed["rope_bridge"]
        cfg = dataclasses.replace(
            cfg, slot_capacity=int(case.split("_")[2]))
    cfg = dataclasses.replace(cfg, joint_solver=solver)
    N, M, J = w.bodies.n, w.colliders.m, w.joints.j
    C = cfg.slot_capacity
    assert not hopper.frame2.frame2_joints_shared(N, M, 4, J, C)
    assert (hopper.frame2_table_rows(N, M, 4, J, C)
            == (M if case != "850_joints" else 0))
    assert hopper.frame2.frame2_scratch_bytes(N, M, 4, J, C) > 0
    every = _every_row(parallel.frame2_inputs(w, cfg))
    _frame_kernel_matches_twin(cfg, w, inputs=every)


# the benchmark's walker cell, its configuration and scene (portbench/)
WALKER_CELL = "bipedal_walker.random_actions"
WALKER_SEED = 2_718_281_828


@pytest.fixture(scope="module")
def walker():
    """64 BipedalWalker-v3 envs of the benchmark's walker cell, each env's
    motors set once by the cell's control, 60 frames in (legs on the
    ground): ``(cfg, world)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "portbench"
    if str(bench) not in sys.path:
        sys.path.append(str(bench))
    from harness import cells

    cell = cells.resolve(WALKER_CELL)
    args = dict(cell.config["scene_args"], n_worlds=64)
    w = cell.control.apply(cell.scene.program(args, WALKER_SEED, "cuda"),
                           WALKER_SEED, 0)
    cfg = cells.solver_config(cell.config)
    w, _, _ = parallel.batched_rollout(w, cfg, 0, 60, record=lambda _: None)
    return cfg, w


@pytest.mark.parametrize("solver", ["colored", "jacobi"])
def test_frame_kernel_on_walker_matches_twin(walker, solver):
    """K4's joint branch on the walker batch (``<8, true, false>``: the
    hull's five vertices; 24 live joint items of 1,224 a world, six
    colours of eight passes) against its twin, both tiers; the joint list
    in shared memory."""
    cfg, w = walker
    N, M, J = w.bodies.n, w.colliders.m, w.joints.j
    assert hopper.frame2.frame2_joints_shared(N, M, 8, J, cfg.slot_capacity)
    _frame_kernel_matches_twin(dataclasses.replace(cfg, joint_solver=solver),
                               w)


def test_live_joint_items_are_the_joint_slots_every_frame(walker,
                                                          monkeypatch):
    """K3's counters over a traced 5-frame rollout of the walker batch
    (one K3 build a call, which K4's joint list walks every frame):
    ``build_joint_slots.live_slots`` 24 a world (the joint list's items),
    ``slot_items`` W x JC x N."""
    cfg, w = walker
    W, N = w.bodies.pos.shape[0], w.bodies.n
    monkeypatch.setattr(hopper.build_joint_slots, "live_slots", None)
    monkeypatch.setattr(hopper.build_joint_slots, "slot_items", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        parallel.batched_rollout(w, cfg, 0, 5, record=lambda _: None)
    assert int(hopper.build_joint_slots.live_slots.sum()) == 24 * W
    assert hopper.build_joint_slots.slot_items == (
        W * cfg.joint_slot_capacity * N)


@pytest.fixture(scope="module")
def static_floor():
    """16 worlds of ``_torch_parity.build_static_floor`` (32 dynamic bodies
    over 223 static tiles, 256 rows), and a per-world pair of it with 32
    and 24 dynamic bodies, 20 frames into contact: ``{name: (cfg, w)}``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from _torch_parity import build_static_floor

    def world(n):
        b, cap = build_static_floor(WorldBuilder, Shape, n_dynamic=n)
        return b.build(Capacity(**cap), device="cuda")[0]

    cfg = SolverConfig(substeps=4, slot_capacity=8)
    out = {}
    for name, w, c in (
            ("uniform", parallel.replicate_world(world(32), 16), cfg),
            ("per_world", parallel.stack_worlds([world(32), world(24)] * 8),
             dataclasses.replace(cfg, batch_uniform_topology=False))):
        w, _, _ = parallel.batched_rollout(w, c, 0, 20,
                                           record=lambda _: None)
        out[name] = (c, w)
    return out


def _ranked_form(static_floor, jointed, walker, form):
    """``(cfg, w)`` of a form of the ranked-table test."""
    if form.startswith("walker"):
        cfg, w = walker
        return dataclasses.replace(cfg, joint_solver=form.split("_")[1]), w
    if form in JOINTED:
        return jointed[form]
    cfg, w = static_floor["per_world" if form == "floor_owners"
                          else "uniform"]
    if "ccd" in form:
        cfg, w = dataclasses.replace(cfg, ccd=True), _bulleted(w)
    if "compact" in form:
        cfg = dataclasses.replace(cfg, batch_solve_capacity=4)
    return cfg, w


RANKED_FORMS = ("walker_colored", "walker_jacobi", "mechanism",
                "rope_bridge", "floor", "floor_ccd", "floor_compact",
                "floor_compact_ccd", "floor_owners")


@pytest.mark.parametrize("form", RANKED_FORMS)
def test_table_of_the_rows_that_may_hold_a_slot_is_bitwise_every_rows(
        static_floor, jointed, walker, form):
    """K4 with a table of only the rows that may hold a slot (K1's row
    rule) against K4 with every row's (``_every_row``), 3 frames each on
    its own state, fresh tables a frame: the states, ``touched``, the
    partners and the counters bitwise equal, on the walker (both joint
    tiers), the mechanism and the rope bridge (its joint list then in
    global memory), and a contact-only floor batch alone, with CCD, with
    ``Cs`` (with and without CCD) and with per-world owners on worlds that
    differ in those rows. A table of those rows never spills to the global
    table (``test_torch_frame2.py``'s ``never_split`` case)."""
    cfg, w = _ranked_form(static_floor, jointed, walker, form)
    W, M = w.bodies.pos.shape[0], w.colliders.m
    few = parallel.frame2_inputs(w, cfg)
    every = _every_row(few)
    assert few.k4.table_rows == few.k4.Rs == few.k4.R < M
    assert every.k4.table_rows == M
    if form == "floor_owners":
        assert few.k4.slot_rows.sum(dim=1).tolist()[:2] == [32.0, 24.0]
    wa = wb = w
    touched = 0.0
    for _ in range(3):
        rows0 = hopper.run_frame2.table_rows
        ra = parallel.frame2_step(
            wa, cfg, inputs=few,
            tables=parallel.frame2_tables(wa, cfg, inputs=few))
        assert hopper.run_frame2.table_rows - rows0 == W * few.k4.Rs
        rb = parallel.frame2_step(
            wb, cfg, inputs=every,
            tables=parallel.frame2_tables(wb, cfg, inputs=every))
        for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
            assert torch.equal(getattr(ra[0].bodies, field),
                               getattr(rb[0].bodies, field)), field
        assert torch.equal(ra[1], rb[1]) and torch.equal(ra[2], rb[2])
        assert {k: int(v) for k, v in ra[4].items()} == {
            k: int(v) for k, v in rb[4].items()}
        touched += float(ra[1].sum())
        wa, wb = ra[0], rb[0]
    assert touched > 0, "no touching contacts: vacuous"


@pytest.mark.parametrize("name", sorted(JOINTED))
def test_frame_kernel_with_joints_and_ccd_matches_twin(jointed, name):
    """K4's joint and CCD instance (``<V, true, true>``), every dynamic
    body a bullet, against its twin: ``touched`` equal, poses to 1e-4 and
    velocities to 1e-3 times the world's fastest body speed (at least 1
    m/s). The mechanism's pendulum blows up (bodies near 90 m/s in the JAX
    package too, ROADMAP.md C), so its bullets clamp, and there a velocity
    is a pose difference over the substep: one float32 rounding of a pose
    (~5e-6 m) is ~1e-3 m/s at h = 1/240 s; ``chip_smoke.agree_worlds``
    holds the full-width jointed frames to the same scale."""
    cfg, w = jointed[name]
    cfg = dataclasses.replace(cfg, ccd=True)
    w = _bulleted(w)
    tables = parallel.frame2_tables(w, cfg,
                                    frames=max(cfg.frames_per_broadphase, 1),
                                    elig=parallel.frame2_elig(w, cfg))
    n0 = hopper.run_frame2.ccd_launches
    wk, tk, *_ = parallel.frame2_step(w, cfg, tables=tables)
    assert hopper.run_frame2.ccd_launches == n0 + 1
    wp, tp, *_ = parallel.frame2_step(w, cfg, tables=tables, plain=True)
    assert torch.equal(tk, tp)
    assert float(tk.sum()) > 0, "no touching contacts: vacuous"
    bk, bp = wk.bodies, wp.bodies
    torch.testing.assert_close(bk.pos, bp.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(bk.angle, bp.angle, rtol=0, atol=1e-4)
    speed = torch.clamp(bp.vel.norm(dim=-1).amax(dim=1), min=1.0)
    for a, b in ((bk.vel.norm(dim=-1), bp.vel.norm(dim=-1)),
                 (bk.vel[..., 0], bp.vel[..., 0]),
                 (bk.vel[..., 1], bp.vel[..., 1]),
                 (bk.ang_vel, bp.ang_vel)):
        err = (a - b).abs().amax(dim=1)
        assert bool((err <= 1e-3 * speed).all()), (err / speed).max()


# ---- the tile engine (K5, K6, K7, K8, K9) -----------------------------------


@pytest.fixture(scope="module")
def tile_layout():
    """``pile(n_bodies=4093, sleep=False)`` (16 tiles) 60 frames in, in tile
    layout, with its K-frame tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starframe_tpu_torch import tiled
    from starframe_tpu_torch.scenes import pile

    sc = pile(n_bodies=4093, sleep=False, device="cuda")
    cfg = sc.config
    w, _ = tiled.tiled_rollout(sc.world, cfg, 60)
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=16, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=8, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap, plain=True)
    return cfg, state, consts, large, edges, g, tables


def _tables_match_twin(args, **kw):
    """K5 against its twin on ``args``: one launch, the integer outputs
    equal, the sweep to 1e-6. Returns the kernel's outputs."""
    n0 = hopper.build_tile_tables.launches
    got = hopper.build_tile_tables(*args, **kw)
    assert hopper.build_tile_tables.launches == n0 + 1
    ref = hopper.build_tile_tables(*args, **kw, plain=True)
    for a, b in zip(got[:6], ref[:6]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[6], ref[6], rtol=0, atol=1e-6)
    return got


@pytest.mark.parametrize("K", [1, 8])
def test_tile_tables_kernel_matches_twin(tile_layout, K):
    cfg, state, consts, large, edges, g, _ = tile_layout
    got = _tables_match_twin(
        (state, consts, large, *edges, g), C=16, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=K, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap)
    assert int(got[3].sum()) > 1000, "few touching candidates: vacuous"


def test_tile_tables_kernel_overflows_every_tier(tile_layout):
    """K5 at C = 32, its widest, with tile 3's rows packed into a 16 x 16
    grid 0.1 m apart (each touches far more than 32 others) and sweeps of
    8 extents (elsewhere a row sees more than 32 swept-only candidates):
    rows past C in the touch tier and in the swept tier."""
    from starframe_tpu_torch import tiled

    cfg, state, consts, large, _, g, _ = tile_layout
    k = torch.arange(256, device="cuda")
    px, py = state["px"].clone(), state["py"].clone()
    px[3] = px[3].mean() + 0.1 * (k % 16)
    py[3] = py[3].mean() + 0.1 * (k // 16)
    dense = dict(state, px=px, py=py)
    edges = tiled._edge_rows(dense, consts, cfg)[:2]
    count, touch, close = _tables_match_twin(
        (dense, consts, large, *edges, g), C=32, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=8, sweep_floor=8.0, sweep_cap=10.0)[2:5]
    assert int((touch > 32).sum()) > 100, "no touch tier past C: vacuous"
    assert int(((close < 32) & (count > 32)).sum()) > 100, (
        "no swept tier past C: vacuous")


def test_tile_tables_kernel_with_sensors_and_layers(tile_layout):
    """K5 with every fifth row a moving sensor that does not respond (a row
    of its own, a candidate of the others) and every third row on layer 3,
    which every seventh row's mask leaves out, so both layer tests cut
    pairs."""
    cfg, state, consts, large, edges, g, _ = tile_layout
    rows = torch.arange(state["px"].numel(), device="cuda").reshape(
        state["px"].shape)
    fifth = rows % 5 == 0
    masked = dict(
        consts, sen=torch.where(fifth, 1.0, consts["sen"]),
        responds=torch.where(fifth, 0.0, consts["responds"]),
        lay=torch.where(rows % 3 == 0, 3, consts["lay"]).to(torch.int32),
        msk=torch.where(rows % 7 == 0, consts["msk"] & ~(1 << 3),
                        consts["msk"]).to(torch.int32))
    kw = dict(C=16, margin=cfg.contact_margin, dt=cfg.dt, sweep_frames=8,
              sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    got = _tables_match_twin((state, masked, large, *edges, g), **kw)
    plain = hopper.build_tile_tables(state, consts, large, *edges, g, **kw)
    assert not torch.equal(got[2], plain[2]), "nothing cut: vacuous"
    sensors = fifth & (consts["mov"] > 0)
    assert int(got[2][sensors].sum()) > 100, "sensor rows empty: vacuous"


@pytest.mark.parametrize("K", [1, 8])
def test_tile_tables_kernel_on_three_tiles(K):
    """K5 on ``pile(n_bodies=765)``, 768 rows in 3 tiles, the fewest the
    tile engine takes (the JAX package's too): every tile's window is the
    whole world, clamped at both ends (tile 0 first in its window, tile 2
    last)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starframe_tpu_torch import tiled
    from starframe_tpu_torch.scenes import pile

    sc = pile(n_bodies=765, sleep=False, device="cuda")
    cfg = sc.config
    w, _ = tiled.tiled_rollout(sc.world, cfg, 30)
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    assert state["px"].shape[0] == 3
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    got = _tables_match_twin(
        (state, consts, large, *edges, w.gravity.contiguous()), C=16,
        margin=cfg.contact_margin, dt=cfg.dt, sweep_frames=K,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    assert bool((got[3] > 0).any(dim=1).all()), "a tile without contacts"


def test_tile_tables_kernel_on_compound_rows(compound_layout):
    """K5 on the compound pile's rows at its C = 24: equal to its twin, and
    no active slot pairs two rows of one body."""
    from starframe_tpu_torch.hopper.tiles import T, WIN, win_start

    c = compound_layout
    cfg, consts = c["cfg"], c["consts"]
    pidx, act = _tables_match_twin(
        (c["state"], consts, c["large"], *c["edges"], c["g"]), C=24,
        margin=cfg.contact_margin, dt=cfg.dt, sweep_frames=8,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)[:2]
    ob = consts["obody"].reshape(-1)
    assert int((ob[1:] == ob[:-1]).sum()) > 500, "few siblings: vacuous"
    row = (win_start(pidx.shape[0], "cuda")[:, None, None] * T
           + torch.clamp(pidx.long(), max=WIN * T - 1))
    partner_ob = torch.where(pidx < WIN * T, ob[row], -1)
    assert int(((act > 0) & (partner_ob == consts["obody"][:, None]))
               .sum()) == 0
    assert int((act > 0).sum()) > 1000, "few slots: vacuous"


@pytest.mark.parametrize("case", ["awake", "waking_dead_tile"])
def test_tile_manifold_kernel_matches_twin(tile_layout, case):
    """Integer outputs equal; the constants, the wake signal and the row
    sums to 1e-6 (the same float32 code: bitwise in practice)."""
    cfg, state, consts, large, _, _, tables = tile_layout
    live = torch.ones(state["px"].shape[0], device="cuda")
    sv = kv = 0.0
    if case != "awake":
        live[2] = 0.0
        sv, kv = 0.2, 0.1
        # every seventh row kinematic, for the kinematic wake rule
        rows = torch.arange(live.numel() * 256, device="cuda").reshape(-1, 256)
        consts = dict(consts, kin=(rows % 7 == 0).float())
    kw = dict(Cs=8, margin=cfg.contact_margin, dt=cfg.dt, sleep_velocity=sv,
              kin_velocity=kv)
    n0 = hopper.tile_manifold.launches
    got = hopper.tile_manifold(state, consts, large, *tables[:2], live, **kw)
    assert hopper.tile_manifold.launches == n0 + 1
    ref = hopper.tile_manifold(state, consts, large, *tables[:2], live, **kw,
                               plain=True)
    for a, b in zip(got[1:4], ref[1:4]):
        assert torch.equal(a, b)
    for a, b in zip(got[:1] + got[4:], ref[:1] + ref[4:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert int(got[3][:, 0].sum()) > 1000, "few active slots: vacuous"
    if case != "awake":
        assert float(got[4].sum()) > 0 and not bool(got[0][2].any())


@pytest.mark.parametrize("Cs", [8, 12, 16])
def test_tile_substep_kernels_match_twins(tile_layout, Cs):
    """One substep's project and apply, each against its twin on the same
    inputs: ``touched`` equal, the rest to 1e-6 (lam, corrections) and
    1e-5 (state; the twin divides by the substep through a host scalar in
    the friction bound, which the card turns into a reciprocal); a rerun
    bitwise equal. ``Cs`` 12 and 16 take the (row, slot) items' rounds of
    8 slots past one, 12 with a partial round."""
    cfg, state, consts, large, _, g, tables = tile_layout
    live = torch.ones(state["px"].shape[0], device="cuda")
    sol, pidx_c = hopper.tile_manifold(
        state, consts, large, *tables[:2], live, Cs=Cs,
        margin=cfg.contact_margin, dt=cfg.dt, plain=True)[:2]
    touched = torch.zeros(pidx_c.shape, device="cuda")
    h = cfg.dt / cfg.substeps
    pkw = dict(h=h, compliance=cfg.contact_compliance)
    n0 = hopper.tile_project.launches
    got = hopper.tile_project(state, consts, large, pidx_c, sol, g, touched,
                              live, **pkw)
    assert hopper.tile_project.launches == n0 + 1
    ref = hopper.tile_project(state, consts, large, pidx_c, sol, g, touched,
                              live, **pkw, plain=True)
    assert torch.equal(got[5], ref[5])
    assert float(got[5].sum()) > 1000, "few touching slots: vacuous"
    for a, b in zip(got[:5], ref[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    akw = dict(h=h, relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    n0 = hopper.tile_apply.launches
    got_s = hopper.tile_apply(state, ref[:4], consts, large, pidx_c, sol,
                              ref[4], g, live, **akw)
    assert hopper.tile_apply.launches == n0 + 1
    ref_s = hopper.tile_apply(state, ref[:4], consts, large, pidx_c, sol,
                              ref[4], g, live, **akw, plain=True)
    for k in got_s:
        torch.testing.assert_close(got_s[k], ref_s[k], rtol=0, atol=1e-5)
    again = hopper.tile_project(state, consts, large, pidx_c, sol, g,
                                touched, live, **pkw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    again_s = hopper.tile_apply(state, ref[:4], consts, large, pidx_c, sol,
                                ref[4], g, live, **akw)
    for k in got_s:
        assert torch.equal(got_s[k], again_s[k]), k


def test_tiled_rollout_is_bitwise_reproducible(tile_layout):
    from starframe_tpu_torch import tiled
    from starframe_tpu_torch.scenes import pile

    sc = pile(n_bodies=4093, sleep=False, device="cuda")
    a, da = tiled.tiled_rollout(sc.world, sc.config, 20)
    b, db = tiled.tiled_rollout(sc.world, sc.config, 20)
    for f in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f))
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}


# ---- K10, the whole frame's substeps -------------------------------------


@pytest.fixture(scope="module")
def frame_inputs():
    """``pile(n_bodies=1021, sleep=False)`` (4 tiles) 30 frames in, in tile
    layout: its K-frame tables' manifolds (16 table and 8 solve slots) with
    tile 1 skipped, and the frame's arguments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starframe_tpu_torch import tiled
    from starframe_tpu_torch.scenes import pile

    sc = pile(n_bodies=1021, sleep=False, device="cuda")
    cfg = sc.config
    w, _ = tiled.tiled_rollout(sc.world, cfg, 30)
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=16, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=8, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap)
    live = torch.ones(state["px"].shape[0], device="cuda")
    live[1] = 0.0
    sol, pidx_c = hopper.tile_manifold(state, consts, large, *tables[:2],
                                       live, Cs=8, margin=cfg.contact_margin,
                                       dt=cfg.dt)[:2]
    kw = dict(h=cfg.dt / cfg.substeps, compliance=cfg.contact_compliance,
              relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
              rest_threshold=cfg.restitution_threshold,
              lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    return (state, consts, large, pidx_c, sol, g, live), kw


@pytest.mark.parametrize("substeps", [2, 10])
def test_tile_frame_kernel_equals_the_substep_pair(frame_inputs, substeps):
    """K10 against K8/K9 launched once a substep: bitwise equal, the
    skipped tile's state passed through."""
    args, kw = frame_inputs
    state, consts, large, pidx_c, sol, g, live = args
    n0 = hopper.tile_frame.launches
    got, touched = hopper.tile_frame(*args, substeps=substeps, **kw)
    assert hopper.tile_frame.launches == n0 + 1
    pk = dict(h=kw["h"], compliance=kw["compliance"])
    ak = {k: v for k, v in kw.items() if k != "compliance"}
    ref, ref_t = state, torch.zeros_like(touched)
    for _ in range(substeps):
        *corr, lam, ref_t = hopper.tile_project(
            ref, consts, large, pidx_c, sol, g, ref_t, live, **pk)
        ref = hopper.tile_apply(ref, corr, consts, large, pidx_c, sol, lam,
                                g, live, **ak)
    assert torch.equal(touched, ref_t)
    assert float(touched.sum()) > 500, "few touching slots: vacuous"
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k][1], state[k][1]), k


def test_tile_frame_kernel_matches_twin(frame_inputs):
    """K10 against its twin (the K8/K9 twins looped): ``touched`` equal,
    the state to 1e-6."""
    args, kw = frame_inputs
    got, touched = hopper.tile_frame(*args, substeps=10, **kw)
    ref, ref_t = hopper.tile_frame(*args, substeps=10, **kw, plain=True)
    assert torch.equal(touched, ref_t)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-6)


def test_tile_frame_refuses_ccd(frame_inputs):
    """K10 no longer refuses CCD: with every row a bullet its CCD form is
    bitwise equal to K7, K8 and K9 launched once a substep (the skipped
    tile's state passed through), counted apart from its plain launches."""
    args, kw = frame_inputs
    state, consts, large, pidx_c, sol, g, live = args
    consts = dict(consts, blt=(consts["invm"] > 0).float())
    args = (state, consts) + args[2:]
    n0, c0 = hopper.tile_frame.launches, hopper.tile_frame.ccd_launches
    got, touched = hopper.tile_frame(*args, substeps=10, ccd=True, **kw)
    assert hopper.tile_frame.ccd_launches == c0 + 1
    assert hopper.tile_frame.launches == n0
    ref, ref_t = hopper.tiles.substep_loop(
        hopper.tile_project, hopper.tile_apply, *args, substeps=10,
        ccd=(hopper.tile_ccd, hopper.owner_min, 0.005), **kw)
    assert torch.equal(touched, ref_t)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k][1], state[k][1]), k
    twin, twin_t = hopper.tile_frame(*args, substeps=10, ccd=True, **kw,
                                     plain=True)
    assert torch.equal(touched, twin_t)
    for k in twin:
        torch.testing.assert_close(got[k], twin[k], rtol=0, atol=1e-6)


def _edge_tiles_dead(args):
    """``args`` with tiles 0 and 3 of 4 skipped and 1 and 2 live: tile 2's
    window reads the dead tile 3's rows (their corrections zero)."""
    live = torch.tensor([0.0, 1.0, 1.0, 0.0], device="cuda")
    return args[:6] + (live,)


@pytest.mark.parametrize("substeps", [2, 10])
def test_tile_frame_kernel_with_dead_tiles_equals_the_substep_pair(
        frame_inputs, substeps):
    """K10 with the first and last tiles skipped bitwise equal to K8/K9
    launched once a substep, the dead tiles' state passed through, a rerun
    bitwise equal."""
    args, kw = frame_inputs
    args = _edge_tiles_dead(args)
    state = args[0]
    got, touched = hopper.tile_frame(*args, substeps=substeps, **kw)
    ref, ref_t = hopper.tiles.substep_loop(
        hopper.tile_project, hopper.tile_apply, *args, substeps=substeps,
        **kw)
    assert torch.equal(touched, ref_t)
    assert float(touched.sum()) > 100, "few touching slots: vacuous"
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        for t in (0, 3):
            assert torch.equal(got[k][t], state[k][t]), (k, t)
    again, again_t = hopper.tile_frame(*args, substeps=substeps, **kw)
    assert torch.equal(touched, again_t)
    for k in got:
        assert torch.equal(got[k], again[k]), k


@pytest.mark.parametrize("substeps", [2, 10])
def test_tile_frame_ccd_kernel_equals_k7_k8_k9(frame_inputs, substeps):
    """K10's CCD form, every row a bullet, tiles 0 and 3 skipped, bitwise
    equal to K7, K8 and K9 launched once a substep."""
    args, kw = frame_inputs
    args = _edge_tiles_dead(args)
    consts = dict(args[1], blt=(args[1]["invm"] > 0).float())
    args = (args[0], consts) + args[2:]
    c0 = hopper.tile_frame.ccd_launches
    got, touched = hopper.tile_frame(*args, substeps=substeps, ccd=True,
                                     **kw)
    assert hopper.tile_frame.ccd_launches == c0 + 1
    ref, ref_t = hopper.tiles.substep_loop(
        hopper.tile_project, hopper.tile_apply, *args, substeps=substeps,
        ccd=(hopper.tile_ccd, hopper.owner_min, 0.005), **kw)
    assert torch.equal(touched, ref_t)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k][0], args[0][k][0]), k


@pytest.fixture(scope="module")
def bullet_tiles():
    """tests/test_ccd.py's tile-engine bullet world (4 tiles) with the
    bullet 0.3 m from the wall at 1000 m/s, in tile layout: the frame's
    solve tables and the arguments of one substep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starframe_tpu_torch import tiled

    b = WorldBuilder()
    b.gravity = (0.0, 0.0)
    wall = b.add_static(pos=(0.0, 0.0))
    b.add_collider(wall, Shape.box(0.1, 2.0))
    bullet = b.add_body(pos=(-0.3, 0.0), vel=(1000.0, 0.0), bullet=True)
    b.add_collider(bullet, Shape.circle(0.05))
    for i in range(1022):
        pad = b.add_body(pos=(1000.0 + 2.0 * (i % 256), 5.0 * (i // 256)))
        b.add_collider(pad, Shape.circle(0.3))
    w, _ = b.build(Capacity(max_bodies=1024, max_colliders=1024,
                            max_pairs=8192, max_joints=0, max_verts=4),
                   device="cuda")
    cfg = SolverConfig(substeps=10, slot_capacity=8, ccd=True,
                       frames_per_broadphase=1)
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tables = hopper.build_tile_tables(state, consts, large, *edges, g, C=8,
                                      margin=cfg.contact_margin, dt=cfg.dt)
    live = torch.ones(state["px"].shape[0], device="cuda")
    sol, pidx_c = hopper.tile_manifold(state, consts, large, *tables[:2],
                                       live, Cs=8, margin=cfg.contact_margin,
                                       dt=cfg.dt)[:2]
    return cfg, (state, consts, large, pidx_c, sol, g, live)


def test_tile_ccd_kernel_matches_twin(bullet_tiles, frame_inputs):
    """K7 against its twin: the bullet world (its row clamped) and the
    pile with every row a bullet and tile 1 skipped, to 1e-6."""
    cfg, args = bullet_tiles
    h = cfg.dt / cfg.substeps
    n0 = hopper.tile_ccd.launches
    got = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop)
    assert hopper.tile_ccd.launches == n0 + 1
    ref = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop, plain=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    assert int((got < 1.0).sum()) == 1, "the bullet did not clamp"
    pargs, kw = frame_inputs
    consts = dict(pargs[1], blt=(pargs[1]["invm"] > 0).float())
    pargs = (pargs[0], consts) + pargs[2:]
    got = hopper.tile_ccd(*pargs, h=kw["h"], ccd_slop=0.005)
    ref = hopper.tile_ccd(*pargs, h=kw["h"], ccd_slop=0.005, plain=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    assert bool((got[1] == 1.0).all())


@pytest.mark.parametrize("Cs", [8, 16])
def test_tile_ccd_kernel_on_partial_bullets(tile_layout, Cs):
    """K7 against its twin, ``f`` equal, with every other dynamic row a
    bullet (the rest take 1), tile 2 skipped and each row's vertical speed
    moved by up to 10 m/s (so that many pairs close fast and clamp), on
    solve tables of Cs = 8 of the C = 16 table slots (one round of 8 slot
    lanes) and of Cs = 16 (two rounds)."""
    cfg, state, consts, large, _, g, tables = tile_layout
    live = torch.ones(state["px"].shape[0], device="cuda")
    live[2] = 0.0
    sol, pidx_c = hopper.tile_manifold(state, consts, large, *tables[:2],
                                       live, Cs=Cs, margin=cfg.contact_margin,
                                       dt=cfg.dt)[:2]
    rows = torch.arange(state["px"].numel(), device="cuda").reshape(
        state["px"].shape)
    blt = ((consts["invm"] > 0) & (rows % 2 == 0)).float()
    vy = state["vy"] + 10.0 * torch.sin(1.7 * rows)
    args = (dict(state, vy=vy), dict(consts, blt=blt), large, pidx_c, sol, g,
            live)
    h = cfg.dt / cfg.substeps
    n0 = hopper.tile_ccd.launches
    got = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop)
    assert hopper.tile_ccd.launches == n0 + 1
    ref = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop, plain=True)
    assert torch.equal(got, ref)
    assert bool((got[blt == 0] == 1.0).all()) and bool((got[2] == 1.0).all())
    assert int((got < 1.0).sum()) > 100, "few rows clamp: vacuous"


def test_tile_substep_ccd_kernels_match_twins(bullet_tiles):
    """K8's and K9's CCD forms on K7's factors against their twins:
    ``touched`` equal, the rest to 1e-6 and the state to 1e-5 (as the
    non-CCD pair), each counted apart from the plain launches."""
    cfg, args = bullet_tiles
    state, consts, large, pidx_c, sol, g, live = args
    h = cfg.dt / cfg.substeps
    f = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop)
    touched = torch.zeros(pidx_c.shape, device="cuda")
    pkw = dict(h=h, compliance=cfg.contact_compliance, f=f)
    n0, c0 = hopper.tile_project.launches, hopper.tile_project.ccd_launches
    got = hopper.tile_project(state, consts, large, pidx_c, sol, g, touched,
                              live, **pkw)
    assert hopper.tile_project.ccd_launches == c0 + 1
    assert hopper.tile_project.launches == n0
    ref = hopper.tile_project(state, consts, large, pidx_c, sol, g, touched,
                              live, **pkw, plain=True)
    assert torch.equal(got[5], ref[5])
    for a, b in zip(got[:5], ref[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    akw = dict(h=h, relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
               f=f)
    c0 = hopper.tile_apply.ccd_launches
    got_s = hopper.tile_apply(state, ref[:4], consts, large, pidx_c, sol,
                              ref[4], g, live, **akw)
    assert hopper.tile_apply.ccd_launches == c0 + 1
    ref_s = hopper.tile_apply(state, ref[:4], consts, large, pidx_c, sol,
                              ref[4], g, live, **akw, plain=True)
    for k in got_s:
        torch.testing.assert_close(got_s[k], ref_s[k], rtol=0, atol=1e-5)
    # the clamp held the bullet short of its full substep advance
    row = consts["blt"] > 0
    full = state["px"][row] + state["vx"][row] * h
    assert float(got_s["px"][row]) < float(full)


# ---- K6 at its edges -------------------------------------------------------


def _manifold_matches_twin(args, **kw):
    """K6 on ``args`` against its twin: integer outputs equal, the rest to
    1e-6 (the same float32 code: bitwise in practice), and a rerun bitwise
    equal. Returns the kernel's outputs."""
    got = hopper.tile_manifold(*args, **kw)
    ref = hopper.tile_manifold(*args, **kw, plain=True)
    for n in (1, 2, 3) + ((7,) if len(got) > 7 else ()):
        assert torch.equal(got[n], ref[n]), n
    for n in (0, 4, 5, 6):
        torch.testing.assert_close(got[n], ref[n], rtol=0, atol=1e-6)
    again = hopper.tile_manifold(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("keys", [False, True])
def test_tile_manifold_kernel_without_compaction(tile_layout, keys):
    """K6 at Cs = C = 16, where every table slot computes and is written
    (its own solve slot), empty slots' normals and anchors included."""
    cfg, state, consts, large, _, _, tables = tile_layout
    live = torch.ones(state["px"].shape[0], device="cuda")
    live[2] = 0.0
    kw = dict(Cs=16, margin=cfg.contact_margin, dt=cfg.dt)
    if keys:
        kw.update(event_ids=(consts["obody"], large["cols"]),
                  n_colliders=4093 + 3)
    got = _manifold_matches_twin((state, consts, large, *tables[:2], live),
                                 **kw)
    src = torch.arange(16, device="cuda", dtype=torch.int32)[None, :, None]
    assert torch.equal(got[2][live > 0], src.expand_as(got[2])[live > 0])
    assert torch.equal(got[1][live > 0], tables[0][live > 0])
    empty = (tables[1] == 0) & (live > 0)[:, None, None]
    assert bool(empty.any()), "no empty slot: vacuous"
    # an empty slot still gets its manifold's normal, not zeros
    assert bool((got[0][:, 1][empty] != 0).any())


def _pad_vertex_planes(consts, large, Vk):
    """The tables' vertex planes padded to ``Vk`` with copies of v0 (each
    collider's ``nv`` unchanged)."""
    V = consts["vlx"].shape[1]
    Nt = consts["vlx"].shape[0]
    c = {k: torch.cat([consts[k], consts[k][:, :1].expand(Nt, Vk - V, 256)],
                      1) for k in ("vlx", "vly")}
    lg = {k: torch.cat([large[k], large[k][:1].expand(Vk - V, -1)], 0)
          for k in ("vlx", "vly")}
    return dict(consts, **c), dict(large, **lg)


@pytest.mark.parametrize("Cs", [8, 16])
@pytest.mark.parametrize("keys", [False, True])
def test_tile_manifold_kernel_at_eight_vertex_planes(tile_layout, keys, Cs):
    """K6's 8-plane instance, on the pile's hexagon tables padded to 8
    planes with copies of v0, against its twin at Cs < C and Cs = C, and
    bitwise equal to the 6-plane instance on the unpadded tables."""
    cfg, state, consts, large, _, _, tables = tile_layout
    assert consts["vlx"].shape[1] == 6
    live = torch.ones(state["px"].shape[0], device="cuda")
    live[2] = 0.0
    kw = dict(Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt,
              sleep_velocity=0.2)
    if keys:
        kw.update(event_ids=(consts["obody"], large["cols"]),
                  n_colliders=4093 + 3)
    c8, l8 = _pad_vertex_planes(consts, large, 8)
    got = _manifold_matches_twin((state, c8, l8, *tables[:2], live), **kw)
    six = hopper.tile_manifold(state, consts, large, *tables[:2], live, **kw)
    for a, b in zip(got, six):
        assert torch.equal(a, b)
    assert int(got[3][:, 0].sum()) > 1000, "few active slots: vacuous"


def test_tile_manifold_kernel_at_24_table_slots(tile_layout):
    """K6 with 24 table slots compacted to 8 (the compound pile's widths):
    16 rows a block, two rounds of its 16 slot lanes and 47,680 bytes of
    shared memory."""
    cfg, state, consts, large, edges, g, _ = tile_layout
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=24, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=8, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap)
    live = torch.ones(state["px"].shape[0], device="cuda")
    for sv in (0.0, 0.2):
        got = _manifold_matches_twin(
            (state, consts, large, *tables[:2], live), Cs=8,
            margin=cfg.contact_margin, dt=cfg.dt, sleep_velocity=sv)
        assert int(got[3][:, 0].sum()) > 1000, "few active slots: vacuous"


@pytest.mark.parametrize("Cs", [8, 16])
def test_tile_manifold_kernel_on_rows_without_candidates(tile_layout, Cs):
    """K6 where every third row's table is empty (act and pidx 0): those
    rows' solve slots and counts are zero, compacted or not."""
    cfg, state, consts, large, _, _, tables = tile_layout
    pidx, act = tables[0].clone(), tables[1].clone()
    rows = torch.arange(256, device="cuda") % 3 == 0
    pidx[:, :, rows] = 0
    act[:, :, rows] = 0.0
    live = torch.ones(state["px"].shape[0], device="cuda")
    got = _manifold_matches_twin((state, consts, large, pidx, act, live),
                                 Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt)
    assert not bool(got[3][:, :, rows].any())
    if Cs < 16:
        assert not bool(got[0][:, :, :, rows].any())
        assert not bool(got[1][:, :, rows].any())
    assert int(got[3][:, 0].sum()) > 500, "few active slots: vacuous"


# ---- events and compound rows --------------------------------------------


def test_tile_manifold_keys_match_twin(tile_layout):
    """K6 with event keys, compacted (Cs = 8) and not (Cs = 16): ``keyc``
    equal to the twin's, the other outputs those of the launch without
    keys, counted apart."""
    cfg, state, consts, large, _, _, tables = tile_layout
    Nt = state["px"].shape[0]
    live = torch.ones(Nt, device="cuda")
    live[2] = 0.0
    # the pile's rows: owner body = canonical collider (one a body)
    ids = (consts["obody"], large["cols"])
    M = 4093 + 3
    for Cs in (8, 16):
        kw = dict(Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt)
        n0, k0 = (hopper.tile_manifold.launches,
                  hopper.tile_manifold.keys_launches)
        got = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                   **kw, event_ids=ids, n_colliders=M)
        assert hopper.tile_manifold.keys_launches == k0 + 1
        assert hopper.tile_manifold.launches == n0
        ref = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                   **kw, event_ids=ids, n_colliders=M,
                                   plain=True)
        assert torch.equal(got[7], ref[7])
        assert int((got[7] > 0).sum()) > 1000, "few keys: vacuous"
        assert not bool(got[7][2].any())
        bare = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                    **kw)
        for a, b in zip(got[:7], bare):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def compound_layout():
    """``pile_compound(n_bodies=2000)`` (16 tiles of collider rows) 60
    frames in, in tile layout, with one substep's inputs: the K-frame
    tables' manifolds and the project phase's sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from starframe_tpu_torch import tiled
    from starframe_tpu_torch.scenes import pile_compound

    sc = pile_compound(n_bodies=2000, device="cuda")
    cfg = sc.config
    w, d = tiled.tiled_rollout(sc.world, cfg, 60)
    assert int(d["owner_overflow"]) == 0
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=24, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=8, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap)
    live = torch.ones(state["px"].shape[0], device="cuda")
    live[1] = 0.0
    sol, pidx_c = hopper.tile_manifold(state, consts, large, *tables[:2],
                                       live, Cs=tiled._solve_cap(cfg),
                                       margin=cfg.contact_margin,
                                       dt=cfg.dt)[:2]
    h = cfg.dt / cfg.substeps
    *corr, lam, _ = hopper.tile_project(
        state, consts, large, pidx_c, sol, g, torch.zeros_like(sol[:, 0]),
        live, h=h, compliance=cfg.contact_compliance)
    return dict(sc=sc, cfg=cfg, state=state, consts=consts, large=large,
                edges=edges, g=g, live=live, sol=sol, pidx_c=pidx_c,
                corr=corr, lam=lam, h=h, ob=consts["obody"].reshape(-1))


def test_owner_kernels_equal_twins_bitwise(compound_layout):
    """``owner_sum`` (K8's four sums) and ``owner_velocity`` bitwise equal
    to their twins, which add in the JAX rolls' order."""
    c = compound_layout
    kc = c["cfg"].max_colliders_per_body
    n0 = hopper.owner_sum.launches
    got = hopper.owner_sum(c["corr"], c["ob"], kc)
    assert hopper.owner_sum.launches == n0 + 1
    ref = hopper.owner_sum(c["corr"], c["ob"], kc, plain=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert not torch.equal(got[3], c["corr"][3]), "no sibling sum: vacuous"
    accv = torch.randn((4,) + c["state"]["px"].shape, device="cuda")
    kw = dict(h=c["h"], lin_damp=0.3, ang_damp=0.2)
    n0 = hopper.owner_velocity.launches
    got = hopper.owner_velocity(c["state"], accv, c["ob"], kc, **kw)
    assert hopper.owner_velocity.launches == n0 + 1
    ref = hopper.owner_velocity(c["state"], accv, c["ob"], kc, **kw,
                                plain=True)
    for k in ("vx", "vy", "om"):
        assert torch.equal(got[k], ref[k]), k


def test_owner_min_kernel_equals_twin_bitwise(compound_layout):
    """``owner_min`` bitwise equal to its twin (the JAX rolls with
    ``minimum`` and +inf), sibling rows holding their body's minimum."""
    c = compound_layout
    kc = c["cfg"].max_colliders_per_body
    x = torch.rand(c["state"]["px"].shape, device="cuda")
    n0 = hopper.owner_min.launches
    got = hopper.owner_min([x], c["ob"], kc)[0]
    assert hopper.owner_min.launches == n0 + 1
    ref = hopper.owner_min([x], c["ob"], kc, plain=True)[0]
    assert torch.equal(got, ref)
    assert not torch.equal(got, x), "no sibling minimum: vacuous"


def test_tile_apply_compound_matches_twin(compound_layout):
    """K9's compound form against its twin on owner-summed sums: the state
    and the raw velocity sums to 1e-6, counted apart from K9's launches;
    a skipped tile's sums zero."""
    c = compound_layout
    cfg = c["cfg"]
    corr = hopper.owner_sum(c["corr"], c["ob"], cfg.max_colliders_per_body)
    akw = dict(h=c["h"], relaxation=cfg.relaxation,
               max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    args = (c["state"], corr, c["consts"], c["large"], c["pidx_c"], c["sol"],
            c["lam"], c["g"], c["live"])
    n0, k0 = hopper.tile_apply.launches, hopper.tile_apply.compound_launches
    got, accv = hopper.tile_apply(*args, **akw, compound=True)
    assert hopper.tile_apply.compound_launches == k0 + 1
    assert hopper.tile_apply.launches == n0
    ref, ref_accv = hopper.tile_apply(*args, **akw, compound=True,
                                      plain=True)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-6)
    torch.testing.assert_close(accv, ref_accv, rtol=0, atol=1e-6)
    assert float(accv[3].sum()) > 100, "few velocity rows: vacuous"
    assert not bool(accv[:, 1].any())


@pytest.mark.parametrize("ccd", [False, True])
def test_compound_frame_equals_the_substep_kernels(compound_layout, ccd):
    """The compound frame (``tile_frame`` with ``owner``) against the
    per-substep kernels (K8, ``owner_sum``, K9's compound form and
    ``owner_velocity``; with ``ccd`` every dynamic row a bullet, K7 and
    ``owner_min`` first): bitwise equal in every state field and
    ``touched``, the skipped tile's state passed through, counted apart
    from K10's launches; a rerun bitwise equal."""
    c = compound_layout
    cfg = c["cfg"]
    consts = c["consts"]
    if ccd:
        consts = dict(consts, blt=(consts["invm"] > 0).float())
    args = (c["state"], consts, c["large"], c["pidx_c"], c["sol"], c["g"],
            c["live"])
    kw = dict(substeps=cfg.substeps, h=c["h"],
              compliance=cfg.contact_compliance, relaxation=cfg.relaxation,
              max_dpos=cfg.max_dpos_eff,
              rest_threshold=cfg.restitution_threshold,
              lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    kc = cfg.max_colliders_per_body
    fkw = dict(ccd=True, ccd_slop=cfg.ccd_slop) if ccd else {}
    counters = ("launches", "ccd_launches", "compound_launches",
                "compound_ccd_launches")
    n0 = {k: getattr(hopper.tile_frame, k) for k in counters}
    got, touched = hopper.tile_frame(*args, **kw, **fkw, owner=(c["ob"], kc))
    mine = "compound_ccd_launches" if ccd else "compound_launches"
    assert {k: getattr(hopper.tile_frame, k) - n0[k] for k in counters} == {
        k: int(k == mine) for k in counters}
    toi = (hopper.tile_ccd, hopper.owner_min, cfg.ccd_slop) if ccd else None
    ref, ref_t = hopper.tiles.substep_loop(
        hopper.tile_project, hopper.tile_apply, *args, **kw, ccd=toi,
        owner=(hopper.owner_sum, hopper.owner_velocity, c["ob"], kc))
    assert torch.equal(touched, ref_t)
    assert float(touched.sum()) > 500, "few touching slots: vacuous"
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k][1], c["state"][k][1]), k
    again, again_t = hopper.tile_frame(*args, **kw, **fkw,
                                       owner=(c["ob"], kc))
    assert torch.equal(touched, again_t)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def test_compound_rollout_is_bitwise_reproducible(compound_layout):
    from starframe_tpu_torch import tiled

    sc = compound_layout["sc"]
    a, da = tiled.tiled_rollout(sc.world, sc.config, 10)
    b, db = tiled.tiled_rollout(sc.world, sc.config, 10)
    for f in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f))
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}
