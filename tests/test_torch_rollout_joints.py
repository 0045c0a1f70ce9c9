"""The jointed slice end to end: the port's ``batched_rollout`` (through the
twins) against the JAX package's ``batched_rollout(..., interpret=True)``
on ``batchify(mechanism(substeps=4), 2)`` and
``batchify(rope_bridge(substeps=4), 2)`` for 4 frames, the batch carried
across as numpy (the two packages draw ``batchify``'s noise differently).
Every counter equal, positions to 2e-3 (tests/test_frame2.py:344), and a
physical check each: the wheel turns the motor's way, the rope's pinned
ends stay on their anchors."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import io as tio, parallel  # noqa: E402

from _torch_parity import numpy_to_jax  # noqa: E402

N_FRAMES = 4


@pytest.mark.parametrize("name", ["mechanism", "rope_bridge"])
def test_jointed_rollout_matches_jax(name):
    base = getattr(st.scenes, name)(substeps=4, device="cpu")
    sc = st.scenes.batchify(base, 2, seed=3)
    like = sf.scenes.batchify(getattr(sf.scenes, name)(substeps=4), 2).world
    arrays = tio.world_to_numpy(sc.world)
    cfg = sc.config
    jcfg = sf.SolverConfig(**dataclasses.asdict(cfg))
    jf, jtraj, jd = sf.parallel.batched_rollout(
        numpy_to_jax(arrays, like), jcfg, 0, N_FRAMES, interpret=True)
    tf, ttraj, td = st.batched_rollout(tio.world_from_numpy(arrays, "cpu"), cfg, 0,
                                       N_FRAMES)

    assert sorted(jd) == sorted(td)
    assert {k: int(v) for k, v in jd.items()} == {
        k: int(v) for k, v in td.items()}
    np.testing.assert_allclose(np.asarray(jf.bodies.pos),
                               tf.bodies.pos.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(jtraj[0]), ttraj[0].numpy(),
                               rtol=0, atol=2e-3)

    b = tf.bodies
    if name == "mechanism":
        # the motor drives the wheel at +2 rad/s against its static hub
        w = base.wheel
        assert float(b.angle[:, w].min()) > 0.05
        assert float(b.ang_vel[:, w].min()) > 1.0
        np.testing.assert_allclose(b.pos[:, w].numpy(),
                                   [[0.0, 2.0]] * b.pos.shape[0], rtol=0,
                                   atol=1e-2)
    else:
        # the end particles are pinned to the pillars' faces
        ends = (base.rope.particles[0], base.rope.particles[-1])
        for p, x in zip(ends, (-8.0, 8.0)):
            gap = (b.pos[:, p] - torch.tensor([x, 4.0])).norm(dim=-1)
            assert float(gap.max()) < 1e-2, (p, gap)
        assert float(b.pos[:, base.rope.particles[20], 1].max()) < 4.0


def test_batched_step_reports_joint_overflow():
    """Two joint slots per body: the rope's middle particle holds three
    joints (two stretch, one pin of the hanging rope), so one joint per
    world goes unsolved and the hard counter says so."""
    sc = st.scenes.batchify(
        st.scenes.rope_bridge(substeps=2, device="cpu"), 2)
    cfg = dataclasses.replace(sc.config, joint_slot_capacity=2)
    _, diag = st.batched_step(sc.world, cfg, 0, with_diag=True)
    _, _, rdiag = st.batched_rollout(sc.world, cfg, 0, 2)
    assert int(diag["joint_overflow"]) == int(rdiag["joint_overflow"]) == 2
    _, diag = st.batched_step(sc.world, sc.config, 0, with_diag=True)
    assert int(diag["joint_overflow"]) == 0


def test_joint_count_past_the_bound_raises():
    """The kernels keep a world's joints in shared memory: past
    parallel.MAX_JOINTS the batch needs the XLA tier (ROADMAP.md A3)."""
    sc = st.scenes.batchify(
        st.scenes.mechanism(substeps=2, device="cpu"), 1)
    extra = parallel.MAX_JOINTS + 1 - sc.world.joints.j
    big = st.expand_capacity(parallel.map_world(lambda x: x[0], sc.world),
                             extra_joints=extra)
    worlds = st.replicate_world(big, 1)
    assert worlds.joints.j == parallel.MAX_JOINTS + 1
    assert not parallel.frame2_shapes_ok(worlds, sc.config)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        parallel.frame2_step(worlds, sc.config)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        st.batched_rollout(worlds, sc.config, 0, 1)
    # at the bound itself the batch runs
    ok = st.replicate_world(st.expand_capacity(
        parallel.map_world(lambda x: x[0], sc.world), extra_joints=extra - 1),
        1)
    assert parallel.frame2_shapes_ok(ok, sc.config)
