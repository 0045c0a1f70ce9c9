"""Gymnasium's BipedalWalker-v3 as a batch of the port's worlds
(``portbench/scenes/bipedal_walker.py``), on the CPU: each world's bodies,
colliders and joints, the hull's mass, the joint colours the reference is
given, and the port's ``batched_rollout`` over one-frame env steps with the
walker's motor actions (``portbench/control/walker_motors.py``) against the
benchmark's plain reference, within the cell's limits
(``portbench/limits/bipedal_walker.random_actions.json``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BENCH = Path(__file__).resolve().parents[1] / "portbench"
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import cells, check, window  # noqa: E402
from reference import world as ref_world  # noqa: E402

CELL = "bipedal_walker.random_actions"
SEED = 6700417
EDGES = 199
# the source's HULL_POLY in px, and its SCALE
HULL_POLY = [(-30, 9), (6, 9), (34, 1), (34, -8), (-30, -8)]
SCALE = 30.0


@pytest.fixture(scope="module")
def cell():
    c = cells.resolve(CELL)
    c.config["scene_args"]["n_worlds"] = 2
    return c


@pytest.fixture(scope="module")
def world(cell):
    return cell.scene.program(cell.config["scene_args"], SEED, "cpu")


def test_each_world_has_the_walkers_parts(cell, world):
    b, c, j = world.bodies, world.colliders, world.joints
    assert cell.config["scene_args"]["n_edges"] == EDGES
    static = (b.inv_mass == 0) & (b.inv_inertia == 0)
    assert static.sum(1).tolist() == [EDGES] * 2
    assert (~static).sum(1).tolist() == [5] * 2
    assert c.m == EDGES + 5 and j.j == 12
    assert (j.jtype != 0).all()
    # the edges are segments on layer 0 hitting everything; the parts are
    # on layer 5 and hit layer 0 alone
    assert (c.nverts[:, :EDGES] == 2).all()
    assert (c.layer[:, EDGES:] == 5).all() and (c.mask[:, EDGES:] == 1).all()
    assert (c.layer[:, :EDGES] == 0).all() and (c.mask[:, :EDGES] == -1).all()
    # each world its own terrain, past the flat start pad
    assert not torch.equal(c.verts[0, :EDGES], c.verts[1, :EDGES])
    assert torch.equal(c.verts[0, :20], c.verts[1, :20])
    desc = cell.scene.describe(cell.config["scene_args"], SEED)
    assert desc["body_dynamic"].sum() == 5
    assert len(desc["joints"]["type"]) == 12
    ends = torch.as_tensor(desc["col_verts"][:, :EDGES, :2])
    assert torch.equal(c.verts[:, :EDGES, :2], ends)


def test_hull_mass_is_five_times_its_area(cell, world):
    v = np.array(HULL_POLY, np.float64) / SCALE
    q = np.roll(v, -1, axis=0)
    area = -0.5 * (v[:, 0] * q[:, 1] - v[:, 1] * q[:, 0]).sum()  # clockwise
    hull = EDGES
    mass = 1.0 / world.bodies.inv_mass[:, hull].double()
    np.testing.assert_allclose(mass.numpy(), 5.0 * area, rtol=1e-6)
    geom, _ = ref_world.build(cell.scene.describe(
        cell.config["scene_args"], SEED), "cpu")
    ref_mass = 1.0 / geom["invm"].reshape(2, -1)[:, hull].double()
    np.testing.assert_allclose(ref_mass.numpy(), 5.0 * area, rtol=1e-6)


def test_reference_takes_the_programs_joint_colours(cell, world):
    desc = cell.scene.describe(cell.config["scene_args"], SEED)
    assert world.joints.color[0].tolist() == desc["joints"]["color"].tolist()
    assert int(world.joints.color.max()) < cell.config["solver"][
        "max_joint_colors"]


def test_control_drives_hips_at_4_and_knees_at_6(cell, world):
    acted = cell.control.apply(world, SEED, 3)
    j = acted.joints
    motors = [k for k in range(12) if int(world.joints.jtype[0, k]) == 4]
    assert motors == [2, 5, 8, 11]
    speed = j.motor_speed[:, motors].abs()
    assert torch.equal(speed, torch.tensor([[4.0, 6.0, 4.0, 6.0]] * 2))
    assert bool((j.motor_max[:, motors] <= 80.0).all())
    # the other rows keep the scene's parameters
    rest = [k for k in range(12) if k not in motors]
    assert torch.equal(j.motor_max[:, rest], world.joints.motor_max[:, rest])


def test_rollout_matches_the_reference(cell):
    """One-frame env steps with fresh actions; the last three, after the
    feet have landed, are held to the reference."""
    cfg = cells.solver_config(cell.config)
    args = cell.config["scene_args"]
    world = cell.scene.program(args, SEED, "cpu")
    samples = []
    for k in range(18):
        world = window.act(cell, world, SEED, k)
        inp = check.world_state(world)
        world, diag = cell.entry.call(world, cfg, 1)
        hard, finite = window.read_call(world, diag, cell.entry.HARD)
        assert finite and hard["joint_overflow"] == 0
        if k >= 15:
            samples.append(dict(pos=k, out=check.world_state(world),
                                hard=hard, **{"in": inp}))
    rcfg = check.reference_config(cell.config["solver"],
                                  cell.config["entry"])
    rcfg["gravity"] = tuple(cell.config["gravity"])
    geom, _ = ref_world.build(cell.scene.describe(args, SEED), "cpu")
    refs, first = check.reference_outputs(geom, rcfg, samples, 1)
    assert max(c["active"] for c in first) > 0  # the feet touch
    values = check.compare(samples, refs, [s["out"] for s in samples],
                           geom["invm"] > 0)
    values["frames_gap"] = check.frames_gap(samples, 1)
    values["counter_misses"] = check.counter_misses(
        samples, first, cell.entry.implied, cell.config["solver"])
    values["flagged_unchecked"] = 0
    correct, rows = check.verdict(values, cell.limits)
    assert correct, rows


def test_twin_counts_the_joint_list(cell, world, monkeypatch):
    """K3's counters ``build_joint_slots.live_slots`` / ``slot_items``
    over a traced 3-frame rollout of the 2-world walker batch: one build a
    call, whose live slots are the joint list K4 walks every frame (each
    body's joint slots with ``jact != 0``: the hull's two hips and each
    thigh's hip and knee, 3 rows each, and each shin's knee: 24 a world),
    and W x JC x N slot items; a contact-only rollout adds to neither."""
    from starframe_tpu_torch import hopper, parallel

    cfg = cells.solver_config(cell.config)
    monkeypatch.setattr(hopper.build_joint_slots, "live_slots", None)
    monkeypatch.setattr(hopper.build_joint_slots, "slot_items", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        parallel.batched_rollout(world, cfg, 0, 3, record=lambda _: None)
    W, N, JC = world.bodies.pos.shape[0], world.bodies.n, 6
    assert cfg.joint_slot_capacity == JC
    jact, count = (parallel.frame2_joint_slots(world, cfg)[k] for k in (2, 3))
    live = int(hopper.build_joint_slots.live_slots.sum())
    assert live == int((jact != 0).sum()) == int(
        torch.clamp(count, max=JC).sum()) == 24 * W
    assert hopper.build_joint_slots.slot_items == W * JC * N
    from starframe_tpu_torch.scenes import batched_worlds

    sc = batched_worlds(n_worlds=1, n_bodies=16, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        parallel.batched_rollout(sc.world, sc.config, 0, 2,
                                 record=lambda _: None)
    assert int(hopper.build_joint_slots.live_slots.sum()) == live
    assert hopper.build_joint_slots.slot_items == W * JC * N
