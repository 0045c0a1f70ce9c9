"""The port's ``starframe.*`` spans (``starframe_tpu_torch/spans.py``):
with no profiler recording, ``span`` enters no ``record_function``; under
``torch.profiler`` each rollout records its layers' spans, as many as its
table schedule and guard make, each nested in the call's one
``starframe.rollout``, and ``starframe.joints`` only on a jointed batch;
the joint-slot counter counts only under a trace; and the final state is
bitwise the same with the profiler on and off."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel, spans, tiled  # noqa: E402

from _torch_parity import build_tiled  # noqa: E402

BODY_FIELDS = ("pos", "angle", "vel", "ang_vel", "prev_pos", "prev_angle",
               "sleep_count")


def traced(run):
    """``(run(), {name: [(start, end, thread)]})`` of the ``starframe.*``
    spans ``run`` records under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    got = {}
    for e in prof.events():
        if e.name.startswith("starframe."):
            got.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end, e.thread))
    return out, got


def counts(got) -> dict:
    return {name[len("starframe."):]: len(v) for name, v in got.items()}


def assert_nested(got):
    """One root; every other span inside it, on its thread."""
    (root,) = got["starframe.rollout"]
    for name, spans_ in got.items():
        for s, e, thread in spans_:
            assert root[0] <= s <= e <= root[1], name
            assert thread == root[2], name


def assert_same_bodies(a, b):
    for f in BODY_FIELDS:
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f


@pytest.fixture(scope="module")
def batch():
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=2,
                                  seed=1, device="cpu")
    return sc.world, sc.config


def batched(world, cfg, K, frames=4):
    cfg = dataclasses.replace(cfg, frames_per_broadphase=K)
    return parallel.batched_rollout(world, cfg, 0, frames,
                                    record=lambda _: None, plain=True)


def test_no_profiler_no_record_function(batch, monkeypatch):
    assert spans.span("starframe.rollout") is spans.NULL

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    world, cfg = batch
    batched(world, cfg, 4, frames=2)


def test_span_records_under_the_profiler():
    def one():
        with spans.span("starframe.x"):
            torch.ones(2).add_(1)

    _, got = traced(one)
    assert counts(got) == {"x": 1}


@pytest.mark.parametrize("K, want", [
    # the build before the loop leaves age 1: frames 1-3 read the guard,
    # frame 4 rebuilds on schedule
    (4, dict(rollout=1, setup=1, tables=2, guard=3, frame=4)),
    (1, dict(rollout=1, setup=1, tables=4, frame=4)),
])
def test_batched_rollout_spans(batch, K, want):
    world, cfg = batch
    (final, _, diag), got = traced(lambda: batched(world, cfg, K))
    assert int(diag["forced_rebuilds"]) == 0
    assert counts(got) == want
    assert_nested(got)
    assert_same_bodies(final, batched(world, cfg, K)[0])


@pytest.fixture(scope="module")
def jointed():
    sc = st.scenes.batchify(st.scenes.mechanism(substeps=2, device="cpu"), 2,
                            seed=3)
    return sc.world, sc.config


def test_joints_span_only_on_a_jointed_batch(batch, jointed):
    _, plain = traced(lambda: batched(*batch, 4))
    assert "starframe.joints" not in plain
    world, cfg = jointed
    (final, _, _), got = traced(lambda: batched(world, cfg, 4))
    # K3 once, inside the set-up; the joint preparation once a frame,
    # inside each frame
    assert counts(got)["joints"] == 1 + 4
    assert_nested(got)
    (setup,) = got["starframe.setup"]
    frames = got["starframe.frame"]
    for s, e, _ in got["starframe.joints"]:
        outer = [setup] + frames
        assert sum(a <= s <= e <= b for a, b, _ in outer) == 1
    assert_same_bodies(final, batched(world, cfg, 4)[0])


def test_joint_slot_counter_counts_only_under_a_trace(jointed, monkeypatch):
    world, cfg = jointed
    build = hopper.build_joint_slots
    monkeypatch.setattr(build, "live_slots", None)
    monkeypatch.setattr(build, "slot_items", 0)
    batched(world, cfg, 4, frames=2)
    assert build.live_slots is None and build.slot_items == 0
    traced(lambda: batched(world, cfg, 4, frames=2))
    count = parallel.frame2_joint_slots(world, cfg, plain=True)[3]
    JC = cfg.joint_slot_capacity
    # one build a call: each body's joints up to JC, over W x JC x N items
    assert int(build.live_slots) == int(torch.clamp(count, max=JC).sum())
    assert build.slot_items == count.numel() * JC
    assert 0 < int(build.live_slots) < build.slot_items


@pytest.fixture(scope="module")
def tiles():
    tb, cap = build_tiled(st.WorldBuilder, st.Shape)
    world, _ = tb.build(st.Capacity(**cap), device="cpu")
    cfg = st.SolverConfig(substeps=2, slot_capacity=16, tile_solve_capacity=8,
                          broadphase="grid", grid_cell_capacity=10,
                          frames_per_broadphase=4)
    return world, cfg


def test_tiled_rollout_spans(tiles):
    world, cfg = tiles
    frames = 3
    (final, diag), got = traced(lambda: tiled.tiled_rollout(world, cfg,
                                                            frames))
    n = counts(got)
    # setup: the layout's entry and its first edges; one guard read and one
    # frame a frame (everything is awake); the build before the loop and
    # one for each re-sort or forced rebuild
    extra = int(diag["forced_resorts"]) + int(diag["forced_rebuilds"])
    assert n["rollout"] == 1 and n["setup"] == 2 and n["exit"] == 1
    assert n["guard"] == n["frame"] == frames
    assert n["tables"] == 1 + extra
    assert n.get("sort", 0) == int(diag["forced_resorts"])
    assert_nested(got)
    assert_same_bodies(final, tiled.tiled_rollout(world, cfg, frames)[0])


def test_tiled_rollout_k1_reads_no_guard(tiles):
    world, cfg = tiles
    cfg = dataclasses.replace(cfg, frames_per_broadphase=1)
    _, got = traced(lambda: tiled.tiled_rollout(world, cfg, 2))
    n = counts(got)
    assert "guard" not in n
    assert n["sort"] == n["tables"] - 1 == n["frame"] == 2
