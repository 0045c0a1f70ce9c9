"""The port's state, builder and snapshots against the JAX package: the
same builder calls give the same arrays (every field equal), snapshots
cross between the packages in both directions, and importing the port
leaves jax unimported."""

import dataclasses
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402
from starframe_tpu.config import Capacity  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402
from starframe_tpu.state import expand_capacity as j_expand  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402

from _torch_parity import (  # noqa: E402
    build,
    build_pile,
    jax_to_numpy,
    numpy_to_jax,
)


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layered,sensor", [(False, None), (True, 3)])
def test_builder_reproduces_jax_arrays(layered, sensor):
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    jw, _ = build_pile(JBuilder, JShape, seed=4, sensor_idx=sensor,
                       layered=layered).build(cap)
    tw, _ = build_pile(st.WorldBuilder, st.Shape, seed=4, sensor_idx=sensor,
                       layered=layered).build(cap, device="cpu")
    _assert_same(jax_to_numpy(jw), tio.world_to_numpy(tw))


def test_builder_auto_capacity_and_kinds_match():
    def describe(builder_cls, shape_cls):
        b = builder_cls(gravity=(0.5, -3.0))
        k = b.add_body(pos=(1.0, 2.0), body_type="kinematic", vel=(1.0, 0))
        b.add_collider(k, shape_cls.capsule(0.5, 0.1), offset=(0.2, 0.1),
                       offset_angle=0.3)
        d = b.add_body(pos=(0.0, 3.0), angle=0.4, bullet=True)
        b.add_collider(d, shape_cls.hexagon(0.5, radius=0.05), density=2.0)
        b.add_collider(d, shape_cls.circle(0.2), offset=(0.6, 0.0))
        p = b.add_particle(pos=(3.0, 3.0), mass=0.5)
        b.add_collider(p, shape_cls.circle(0.1), mask=0)
        return build(b, reserve_bodies=2, reserve_colliders=3)

    jw, jcap = describe(JBuilder, JShape)
    tw, tcap = describe(st.WorldBuilder, st.Shape)
    assert dataclasses.asdict(jcap) == dataclasses.asdict(tcap)
    _assert_same(jax_to_numpy(jw), tio.world_to_numpy(tw))
    _assert_same(jax_to_numpy(j_expand(jw, 3, 5)),
                 tio.world_to_numpy(st.expand_capacity(tw, 3, 5)))


def test_builder_with_joints_raises():
    """A joint with a missing anchor is refused when it is added (as the
    JAX builder refuses it: NaN anchors would poison the solve); a jointed
    world past the kernels' joint bound is refused when it is stepped,
    naming the XLA tier it would need (ROADMAP.md A3)."""
    b = st.WorldBuilder()
    a = b.add_body(pos=(0.0, 0.0))
    b.add_collider(a, st.Shape.circle(0.2))
    c = b.add_body(pos=(1.0, 0.0))
    b.add_collider(c, st.Shape.circle(0.2))
    with pytest.raises(ValueError, match="anchors must not be None"):
        b.pin_joint(a, c, anchor_a=(0.0, 0.0))
    b.distance_joint(a, c, rest=1.0)
    world, cap = b.build(reserve_joints=st.parallel.MAX_JOINTS,
                         device="cpu")
    assert cap.max_joints == world.joints.j == st.parallel.MAX_JOINTS + 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        st.batched_step(st.replicate_world(world, 1), st.SolverConfig(), 0)


def test_snapshots_cross_between_packages(tmp_path):
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    jw, _ = build_pile(JBuilder, JShape, seed=1).build(cap)
    jb = sf.parallel.replicate_world(jw, 3)
    # JAX writes, the port reads
    sf.io.save(str(tmp_path / "j.npz"), jb)
    tw = tio.load_npz(str(tmp_path / "j.npz"), "cpu")
    _assert_same(jax_to_numpy(jb), tio.world_to_numpy(tw))
    assert tw.bodies.pos.shape == (3, 128, 2)
    assert tw.bodies.n == 128 and tw.colliders.m == 128
    # the port's arrays, written as a snapshot, load in JAX
    np.savez(str(tmp_path / "t.npz"), **tio.world_to_numpy(tw))
    back = sf.io.load(str(tmp_path / "t.npz"), jb)
    _assert_same(jax_to_numpy(jb), jax_to_numpy(back))
    # in-memory round trip through both packages
    _assert_same(jax_to_numpy(numpy_to_jax(tio.world_to_numpy(tw), jb)),
                 tio.world_to_numpy(tio.world_from_numpy(
                     tio.world_to_numpy(tw), "cpu")))


def test_replicate_world_matches_jax():
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    jw, _ = build_pile(JBuilder, JShape, seed=2).build(cap)
    tw, _ = build_pile(st.WorldBuilder, st.Shape, seed=2).build(
        cap, device="cpu")
    tb = st.replicate_world(tw, 4)
    _assert_same(jax_to_numpy(sf.parallel.replicate_world(jw, 4)),
                 tio.world_to_numpy(tb))
    assert all(t.is_contiguous() for t in (tb.bodies.pos, tb.colliders.verts))


def test_batched_scene_matches_jax_apart_from_noise():
    """Same scene as sf.scenes.batched_worlds; only the per-world velocity
    noise (numpy here, jax.random there) differs, and it stays on dynamic
    bodies at the same scale."""
    js = sf.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3)
    ts = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                device="cpu")
    asdict = dataclasses.asdict
    assert asdict(js.config) == asdict(ts.config)
    assert asdict(js.capacity) == asdict(ts.capacity)
    a, b = jax_to_numpy(js.world), tio.world_to_numpy(ts.world)
    for k in a:
        if k != "bodies/vel":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dyn = a["bodies/inv_mass"] > 0
    assert np.all(b["bodies/vel"][~dyn] == 0.0)
    assert 0.05 < b["bodies/vel"][dyn].std() < 0.2
    again = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                   device="cpu")
    assert torch.equal(again.world.bodies.vel, ts.world.bodies.vel)


def test_import_leaves_jax_out():
    code = ("import sys, starframe_tpu_torch, starframe_tpu_torch.hopper; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('starframe_tpu.') or "
            "m == 'starframe_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)
