"""``correct`` on the cell ``bipedal_walker.random_actions`` on the CPU at 4
worlds with all 199 terrain edges, in episodes of 6 one-frame calls from
frame 20, where the feet have landed: a sound run passes; the program's
call with the knee motors driven at the hip's 4 rad/s, with the walker's
parts back on layer 0 with mask -1, with every world on world 0's terrain,
or with the control's actions dropped fails, and so does the reference in
bfloat16 in the program's place. The cell's three new per-layer metrics
read hand-worked counts, a synthetic trace and known counters, and read
nothing where the program has no such span or counter.

The source's first 21 terrain points are its flat start pad, the same in
every world, and the walker spawns over it; so the terrain fault is
planted with the walker spawned over the rough terrain past the pad (in
the program and the reference alike), where a sound run passes too."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from harness import cells, check, peaks, roofline, trace
from reference import frame as ref_frame
from reference import world as ref_world
from test_correct import SEED, run_small
from test_trace import ev

CELL = "bipedal_walker.random_actions"
# a spawn over rough terrain: 60 points in, past the 21 of the start pad
ROUGH_X = 60


def small(rough: bool = False):
    cell = cells.resolve(CELL)
    cell.config["scene_args"]["n_worlds"] = 4
    cell.traffic.update(start_frame=20, episode_frames=6, check_calls=4)
    if rough:
        scene = cell.scene
        scene.INIT_X = ROUGH_X * scene.TERRAIN_STEP
        cell.name += ".rough"  # its own settled start
    return cell


def run_walker(monkeypatch, call=None, hook=None, rough=False):
    return run_small(small(rough), call=call, hook=hook,
                     monkeypatch=monkeypatch, seconds=6.0)


@pytest.mark.parametrize("rough", [False, True], ids=["pad", "rough"])
def test_sound_run_is_correct(monkeypatch, rough):
    res = run_walker(monkeypatch, rough=rough)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["samples"][0] >= 2


def _with_joints(world, **fields):
    return dataclasses.replace(world, joints=dataclasses.replace(
        world.joints, **fields))


def knee_at_hip_speed(real):
    """The knees' target speed 4 x sign(a), the hips', in place of 6."""
    knees = [m for m, hip in zip(small().control.MOTORS,
                                 small().scene.ACTION_HIP) if not hip]

    def call(world, cfg, n):
        speed = world.joints.motor_speed.clone()
        speed[..., knees] *= 4.0 / 6.0
        return real(_with_joints(world, motor_speed=speed), cfg, n)
    return call


def one_layer(real):
    def call(world, cfg, n):
        c = world.colliders
        c = dataclasses.replace(c, layer=torch.zeros_like(c.layer),
                                mask=torch.full_like(c.mask, -1))
        return real(dataclasses.replace(world, colliders=c), cfg, n)
    return call


def control_dropped(real):
    """The scene's own motor parameters in place of the call's actions."""
    cell = small()
    scene = cell.scene.program(cell.config["scene_args"], SEED % (1 << 63),
                               "cpu").joints

    def call(world, cfg, n):
        return real(_with_joints(world, motor_speed=scene.motor_speed,
                                 motor_max=scene.motor_max), cfg, n)
    return call


def same_terrain(real):
    """World 0's terrain edges in every world."""
    T = small().config["scene_args"]["n_edges"]

    def call(world, cfg, n):
        c = world.colliders
        verts = c.verts.clone()
        verts[:, :T] = verts[:1, :T]
        return real(dataclasses.replace(world, colliders=dataclasses.replace(
            c, verts=verts)), cfg, n)
    return call


@pytest.mark.parametrize("fault, rough", [
    (knee_at_hip_speed, False), (one_layer, False), (control_dropped, False),
    (same_terrain, True)])
def test_fault_is_not_correct(fault, rough, monkeypatch):
    res = run_walker(monkeypatch, call=fault(small().entry.call),
                     rough=rough)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(monkeypatch):
    """The reference in bfloat16 in the program's place fails a limit."""
    cell = small()

    def control(samples):
        rcfg = check.reference_config(cell.config["solver"],
                                      cell.config["entry"])
        rcfg["gravity"] = tuple(cell.config["gravity"])
        geom, _ = ref_world.build(cell.scene.describe(
            cell.config["scene_args"], SEED % (1 << 63)), "cpu")
        low, _ = check.reference_outputs(
            geom, rcfg, samples, cell.traffic["frames_per_call"],
            dtype=torch.bfloat16)
        for s, out in zip(samples, low):
            s["out"] = dict({k: v.float() if v.is_floating_point() else v
                             for k, v in out.items()},
                            steps=s["out"]["steps"])

    res = run_walker(monkeypatch, hook=control)
    assert not res["correct"], res["checks"]


def test_reference_counts_joint_rows():
    """``joints`` counts the rows solved a frame (12 a world),
    ``max_joint_rows`` the most on one body (the hull's two hips, or a
    thigh's hip and knee: 6), which the configuration's 6 slots hold."""
    cell = small()
    geom, st = ref_world.build(cell.scene.describe(
        cell.config["scene_args"], SEED % (1 << 63)), "cpu")
    rcfg = check.reference_config(cell.config["solver"], cell.config["entry"])
    rcfg["gravity"] = tuple(cell.config["gravity"])
    stats = {}
    ref_frame.rollout(geom, st, rcfg, 2, stats)
    assert stats["frames"] == 2
    assert stats["joints"] == 2 * 4 * 12
    assert stats["max_joint_rows"] == 6
    assert cell.entry.implied(stats, cell.config["solver"]) == []
    tight = dict(cell.config["solver"], joint_slot_capacity=5)
    assert cell.entry.implied(stats, tight) == ["joint_overflow"]


def test_k3_counts_its_bytes():
    """Each call: 3 words a joint read; 3 x JC + 1 words a body written."""
    c = SimpleNamespace(
        counts=dict(calls=400), trace=dict(episodes=2),
        cell=SimpleNamespace(config={"solver": {"joint_slot_capacity": 6}}),
        shapes=dict(bodies=204 * 3, joints=12 * 3))
    flops, nbytes = cells.roofline_count("k3").work(c)
    assert flops == 0.0
    assert nbytes == 2 * 4 * 400 * (3 * 36 + 19 * 612)
    kern = ("void joint_slot_kernel(JointSlotArgs)", "kernel", 0.0, 1e3)
    c.trace.update(dev=[kern], window_s=1.0)
    assert roofline.share(c, "k3") == pytest.approx(
        100 * nbytes / peaks.PEAK_BYTES_S / 1e-3)


def _joint_trace(with_joints: bool):
    """One call (10-90) in a window 0-100: set-up 12-20 holding a joints
    span 14-18, a frame 60-80 holding one 62-66; the device busy 15-17 and
    70-95."""
    events = [
        ev("portbench.call", "user_annotation", 5.0, 90.0),
        ev("starframe.rollout", "user_annotation", 10.0, 80.0),
        ev("starframe.setup", "user_annotation", 12.0, 8.0),
        ev("starframe.frame", "user_annotation", 60.0, 20.0),
        ev("void joint_slot_kernel(JointSlotArgs)", "kernel", 15.0, 2.0),
        ev("void frame2_kernel<8, true, false>(Frame2Args)", "kernel", 70.0,
           25.0)]
    if with_joints:
        events += [ev("starframe.joints", "user_annotation", 14.0, 4.0),
                   ev("starframe.joints", "user_annotation", 62.0, 4.0)]
    dev = trace.device_events(events, 0.0, 100.0)
    return dict(dev=dev, host=trace.host_events(events), t0_us=0.0,
                t1_us=100.0, window_s=100e-6, busy_s=trace.busy_us(dev) * 1e-6,
                frames=1)


def test_joints_idle_share_reads_its_span():
    read = cells.metric_reader("joints_idle_share.batched")
    # idle 14-15 and 17-18 in the set-up's span, 62-66 in the frame's
    assert read(SimpleNamespace(trace=_joint_trace(True))) == pytest.approx(
        6.0)
    setup = cells.metric_reader("setup_idle_share.batched")
    assert setup(SimpleNamespace(trace=_joint_trace(True))) == (
        pytest.approx(2.0 + 2.0))
    # no such span (a joint-free batch, or a program without it): nothing
    assert read(SimpleNamespace(trace=_joint_trace(False))) is None
    assert read(SimpleNamespace(trace=None)) is None


@pytest.fixture
def joint_slot_counters(monkeypatch):
    """``hopper.build_joint_slots``' counters, restored after the test."""
    from starframe_tpu_torch import hopper

    monkeypatch.setattr(hopper.build_joint_slots, "live_slots", None)
    monkeypatch.setattr(hopper.build_joint_slots, "slot_items", 0)
    return hopper.build_joint_slots


def test_live_joint_slot_share(joint_slot_counters, monkeypatch):
    read = cells.metric_reader("k4_live_joint_slot_share")
    assert read(SimpleNamespace(trace=None)) is None
    build = joint_slot_counters
    build.live_slots = torch.tensor([24 * 4096], dtype=torch.int64)
    build.slot_items = 6 * 204 * 4096
    assert read(SimpleNamespace(trace=None)) == pytest.approx(
        100 * 24 / 1224)
    monkeypatch.delattr(build, "live_slots")
    monkeypatch.delattr(build, "slot_items")
    assert read(SimpleNamespace(trace=None)) is None
