"""Sleep on the batched path (``cfg.sleep_velocity > 0``): the joint
closures of ``starframe_tpu_torch/step.py`` against the JAX package's, and
the frozen frame, the counters and the wake of ``parallel.frame2_step``
against ``starframe_tpu/parallel.py``'s ``frame2_step(..., interpret=True)``
on the same arrays and slot tables.

Two repairs of the reference are pinned here side by side with it
(ROADMAP.md C): its batched counter never rises (``parallel.py:368-402``
computes ``slow`` and reads it nowhere), where the port counts as the XLA
tier does (``step.py:329-332``); and it wakes a sleeper on dynamic
partners only, where the port also wakes one on a touching kinematic
partner at ``sleep_velocity`` or faster (the port's tile engine's rule).
Poses and velocities to the frame kernel's bounds (2e-4, 5e-4 in angle,
2e-2).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from starframe_tpu import parallel as jpar  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402
from starframe_tpu.step import (  # noqa: E402
    _joint_slow_closure,
    _joint_wake_closure,
)

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch.step import (  # noqa: E402
    joint_slow_closure,
    joint_wake_closure,
)

from _torch_parity import (  # noqa: E402
    build,
    build_pile,
    jax_to_numpy,
    numpy_to_jax,
    to_jax_tables,
)

CAP = dict(max_bodies=128, max_colliders=128, max_pairs=1024, max_joints=0,
           max_verts=4)
# one config for every JAX frame here (one interpret-mode compile)
CFG = dict(substeps=4, slot_capacity=8, sleep_velocity=0.1, sleep_frames=10)
TOLS = (("bodies/pos", 2e-4), ("bodies/angle", 5e-4), ("bodies/vel", 2e-2),
        ("bodies/ang_vel", 2e-2))


@pytest.mark.parametrize("seed", range(4))
def test_joint_closures_match_jax(seed):
    """Both closures on random joint graphs (chains and repeats included,
    some joints inactive), three worlds at once, equal to the reference's
    world by world."""
    rng = np.random.default_rng(seed)
    W, N, J = 3, 40, 30
    ja = rng.integers(0, N, (W, J)).astype(np.int32)
    jb = rng.integers(0, N, (W, J)).astype(np.int32)
    act = rng.random((W, J)) < 0.8
    flags = rng.random((W, N)) < 0.6
    t = [torch.as_tensor(x) for x in (flags, ja, jb, act)]
    slow = joint_slow_closure(*t)
    wake = joint_wake_closure(~t[0], *t[1:])
    for w in range(W):
        joints = SimpleNamespace(body_a=jnp.asarray(ja[w]),
                                 body_b=jnp.asarray(jb[w]),
                                 active=jnp.asarray(act[w]))
        np.testing.assert_array_equal(
            np.asarray(_joint_slow_closure(jnp.asarray(flags[w]), joints)),
            slow[w].numpy())
        np.testing.assert_array_equal(
            np.asarray(_joint_wake_closure(jnp.asarray(~flags[w]), joints)),
            wake[w].numpy())


def _set_bodies(w, **fields):
    return dataclasses.replace(w, bodies=dataclasses.replace(w.bodies,
                                                             **fields))


def _both(builder_fn):
    """The same 2-world batch through both builders: ``(JAX, port)``."""
    jb, tb = builder_fn(JBuilder, JShape), builder_fn(st.WorldBuilder, st.Shape)
    jw, _ = build(jb, JCapacity(**CAP))
    tw, _ = build(tb, st.Capacity(**CAP))
    return jpar.replicate_world(jw, 2), parallel.replicate_world(tw, 2)


def _frames(jw, tw, n):
    """``n`` frames of each package from the same arrays, the slot tables
    built from the port's state: per frame ``(JAX world, port world)``."""
    jcfg, cfg = JConfig(**CFG), st.SolverConfig(**CFG)
    jw = numpy_to_jax(tio.world_to_numpy(tw), jw)
    out = []
    for _ in range(n):
        tables = parallel.frame2_tables(tw, cfg)
        jw = jpar.frame2_step(jw, jcfg, interpret=True,
                              tables=to_jax_tables(tables))[0]
        tw = parallel.frame2_step(tw, cfg, tables=tables)[0]
        out.append((jw, tw))
    return out


def _presleep(tw, sleepers, sleep_frames):
    b = tw.bodies
    count = torch.where(sleepers, sleep_frames, b.sleep_count)
    return _set_bodies(
        tw, sleep_count=count.to(b.sleep_count.dtype),
        vel=torch.where(sleepers[..., None], 0.0, b.vel),
        ang_vel=torch.where(sleepers, 0.0, b.ang_vel))


@pytest.fixture(scope="module")
def preslept():
    """tests/test_sleep_tiers.py:130-165's scene (test_frame2.py's
    ``_scene``, seed 11), 12 frames into the port's twin without sleep;
    then its lowest layer put to sleep and one body above them thrown down
    at 8 m/s; 2 frames of each package."""
    jw, tw = _both(lambda b, s: build_pile(b, s, seed=11))
    awake = st.SolverConfig(**dict(CFG, sleep_velocity=0.0))
    tw, _, _ = parallel.batched_rollout(tw, awake, 0, 12,
                                        record=lambda _: None)
    b = tw.bodies
    sleepers = (b.inv_mass > 0) & (b.pos[..., 1] < 0.8)
    tw = _presleep(tw, sleepers, CFG["sleep_frames"])
    # the impactor: the body right above the third sleeper
    target = int(torch.nonzero(sleepers[0])[2])
    above = (~sleepers[0]) & (b.inv_mass[0] > 0)
    d = (b.pos[0] - b.pos[0, target]).norm(dim=-1)
    hit = int(torch.argmin(torch.where(above, d, 1e9)))
    pos = b.pos.clone()
    pos[:, hit] = b.pos[:, target] + torch.tensor([0.0, 1.0])
    vel = tw.bodies.vel.clone()
    vel[:, hit] = torch.tensor([0.0, -8.0])
    tw = _set_bodies(tw, pos=pos, vel=vel)
    return tw, sleepers, target, _frames(jw, tw, 2)


@pytest.mark.parametrize("frame", range(2))
def test_preslept_frame_matches_jax(preslept, frame):
    """The frozen frame: poses and velocities as the reference's, the same
    sleepers woken, and every sleeper the reference kept asleep bitwise
    where it was (as in the reference)."""
    start, sleepers, target, frames = preslept
    jw, tw = frames[frame]
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k, tol in TOLS:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)
    sf = CFG["sleep_frames"]
    j_awake = a["bodies/sleep_count"] < sf
    t_awake = b["bodies/sleep_count"] < sf
    np.testing.assert_array_equal(j_awake[sleepers.numpy()],
                                  t_awake[sleepers.numpy()])
    if frame == 1:
        assert t_awake[0, target], "the struck sleeper did not wake"
    kept = sleepers.numpy() & ~t_awake
    assert kept.sum() > 10, "no sleeper stayed asleep: vacuous"
    np.testing.assert_array_equal(b["bodies/pos"][kept],
                                  start.bodies.pos.numpy()[kept])
    np.testing.assert_array_equal(a["bodies/pos"][kept],
                                  start.bodies.pos.numpy()[kept])


def resting(builder_cls, shape_cls, platform=None):
    """A ground, eight circles resting on it apart and static pads; with
    ``platform`` the speed of a kinematic platform carrying a box instead."""
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(60.0, 0.5), friction=0.5)
    if platform is None:
        for i in range(8):
            c = b.add_body(pos=(-14.0 + 4.0 * i, 0.45))
            b.add_collider(c, shape_cls.circle(0.45), friction=0.5)
        n = 9
    else:
        p = b.add_body(pos=(-10.0, 0.25), vel=(platform, 0.0),
                       body_type="kinematic")
        b.add_collider(p, shape_cls.box(1.0, 0.25), friction=0.5)
        box = b.add_body(pos=(-10.0, 0.75))
        b.add_collider(box, shape_cls.box(0.25, 0.25), friction=0.5)
        n = 3
    for i in range(128 - n):
        pad = b.add_static(pos=(100.0 + 2.0 * i, 50.0))
        b.add_collider(pad, shape_cls.circle(0.3))
    return b


def test_batch_counts_up_to_sleep():
    """The pin of the batched counter (ROADMAP.md C): resting circles are
    slow every frame; the port's counter follows the XLA tier's rule
    ``where(slow, c + 1, 0)`` and the batch is asleep, velocities zero,
    at frame ``sleep_frames``. The reference's ``frame2_step`` leaves
    every counter at 0."""
    jw, tw = _both(resting)
    frames = _frames(jw, tw, 2)
    dyn = (tw.bodies.inv_mass > 0).numpy()
    for f, (j, t) in enumerate(frames):
        assert (np.asarray(j.bodies.sleep_count) == 0).all()
        assert (t.bodies.sleep_count.numpy()[dyn] == f + 1).all()
    cfg = st.SolverConfig(**CFG)
    w = frames[-1][1]
    for f in range(2, CFG["sleep_frames"]):
        prev = w.bodies.sleep_count
        w = parallel.frame2_step(w, cfg)[0]
        b = w.bodies
        slow = (b.vel.norm(dim=-1) ** 2 + b.ang_vel ** 2
                < cfg.sleep_velocity ** 2)
        assert torch.equal(b.sleep_count, torch.where(slow, prev + 1, 0))
    asleep = parallel._asleep(w.bodies, cfg)
    assert bool(asleep[torch.as_tensor(dyn)].all())
    assert float(w.bodies.vel.abs().max()) == 0.0
    again = parallel.frame2_step(w, cfg)[0]
    assert torch.equal(again.bodies.pos, w.bodies.pos)


@pytest.mark.parametrize("speed", [0.15, 0.05])
def test_kinematic_platform_wakes_a_sleeper(speed):
    """A sleeping box on a kinematic platform: at 0.15 m/s (sleep velocity
    0.1) the port wakes it, counter reset, and it rides along (20 frames
    on); at 0.05 it stays asleep, bitwise where it was. The reference wakes on dynamic partners only: its box
    stays asleep at either speed."""
    jw, tw = _both(lambda b, s: resting(b, s, platform=speed))
    box = 2
    sleepers = torch.zeros(tw.bodies.inv_mass.shape, dtype=torch.bool)
    sleepers[:, box] = True
    tw = _presleep(tw, sleepers, CFG["sleep_frames"])
    frames = _frames(jw, tw, 2)
    j, t = frames[-1]
    sf = CFG["sleep_frames"]
    assert (np.asarray(j.bodies.sleep_count)[:, box] >= sf).all()
    woke = t.bodies.sleep_count[:, box] < sf
    assert bool(woke.all()) == (speed >= 0.1) and bool(woke.any()) == (
        speed >= 0.1)
    # the port's box, 20 frames on: dragged along by friction, or frozen
    w, _, _ = parallel.batched_rollout(t, st.SolverConfig(**CFG), 0, 20,
                                       record=lambda _: None)
    moved = w.bodies.pos[:, box, 0] - tw.bodies.pos[:, box, 0]
    if speed >= 0.1:
        assert bool((moved > 0.5 * speed * 20 / 60).all()), moved
    else:
        assert bool((moved == 0).all()), moved
