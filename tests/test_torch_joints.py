"""The port's joints against the JAX package: the builder's joint arrays and
colours, the slot-form joint math (``kernels.solve_joints_b`` and
``velocity_joints_b``), and the joint-slot twin (``hopper.build_joint_slots``)
against ``pallas/slots.py``'s ``build_joint_slots`` in interpret mode.
Arrays and slot tables equal; the joint math to 1e-5."""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402
from starframe_tpu import kernels as jk  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.native import greedy_color as j_greedy_color  # noqa: E402
from starframe_tpu.pallas.slots import build_joint_slots as j_joint_slots  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, kernels as tk, parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch.config import Capacity  # noqa: E402
from starframe_tpu_torch.native import greedy_color  # noqa: E402

from _torch_parity import build, build_jointed, jax_to_numpy  # noqa: E402


def _jointed(pkg, cap_cls):
    b, cap = build_jointed(pkg.WorldBuilder, pkg.Shape)
    return build(b, cap_cls(**cap))[0]


SCENES = {
    "mechanism": (lambda: sf.scenes.mechanism(substeps=4).world,
                  lambda: st.scenes.mechanism(substeps=4,
                                                  device="cpu").world),
    "rope_bridge": (lambda: sf.scenes.rope_bridge(substeps=4).world,
                    lambda: st.scenes.rope_bridge(substeps=4,
                                                      device="cpu").world),
    "jointed": (lambda: _jointed(sf, JCapacity),
                lambda: _jointed(st, Capacity)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builder_joint_arrays_match_jax(name):
    make_j, make_t = SCENES[name]
    a, b = jax_to_numpy(make_j()), tio.world_to_numpy(make_t())
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["joints/jtype"].size > 0 and b["joints/color"].max() > 0


@pytest.mark.parametrize("name", ["mechanism", "rope_bridge"])
def test_tightened_colors_match_jax(name):
    js = getattr(sf.scenes, name)(substeps=4)
    ts = getattr(st.scenes, name)(substeps=4, device="cpu")
    assert dataclasses.asdict(js.config) == dataclasses.asdict(ts.config)
    assert ts.config.max_joint_colors == {"mechanism": 2,
                                          "rope_bridge": 3}[name]
    assert dataclasses.asdict(js.capacity) == dataclasses.asdict(ts.capacity)
    if name == "mechanism":
        assert ts.wheel == js.wheel
    else:
        for rope in ("rope", "hang"):
            assert (dataclasses.astuple(getattr(ts, rope))
                    == dataclasses.astuple(getattr(js, rope)))


@pytest.mark.parametrize("seed", range(4))
def test_greedy_color_matches_native(seed):
    rng = np.random.default_rng(seed)
    n, nb = 300, 60
    ba = rng.integers(-1, nb + 2, n)  # out-of-range ends are never tracked
    bb = rng.integers(0, nb, n)
    active = rng.random(n) > 0.1
    static = rng.random(nb) < 0.2
    got = greedy_color(ba, bb, active=active, body_is_static=static,
                       n_bodies=nb)
    ref = j_greedy_color(ba, bb, active=active, body_is_static=static,
                         n_bodies=nb)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] > 2
    # no two same-colour active joints share a tracked body
    colors = got[0]
    for c in range(got[1]):
        ends = [b for i in np.flatnonzero(active & (colors == c))
                for b in {int(ba[i]), int(bb[i])}
                if 0 <= b < nb and not static[b]]
        assert len(ends) == len(set(ends))


# ---------------------------------------------------------------------------
# the slot-form joint math on seeded random slots
# ---------------------------------------------------------------------------

S_PER_TYPE = 96  # per joint type and side


def _joint_inputs(seed):
    """Random slots of all five joint types, each on the A side and
    canonicalised from the B side, relative angles around +-pi, rope
    particles (zero inverse inertia) and unlimited motors (3.4e38)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    n = S_PER_TYPE * 5
    jtype = np.repeat(np.arange(1, 6), S_PER_TYPE).astype(np.int32)

    def u(lo, hi, size=n):
        return rng.uniform(lo, hi, size).astype(f)

    own_a = np.tile(np.arange(S_PER_TYPE) % 2 == 0, 5)
    ax, ay, bx, by = u(-1, 1), u(-1, 1), u(-1, 1), u(-1, 1)
    rest, ms = u(-3, 3), u(-4, 4)
    lo = u(-1.5, 0)
    hi = lo + u(0, 1.5)
    # the canonical (own = A) view of each slot, as frame2.py builds it
    rng_type = jtype == 3
    jd = dict(
        jtype=jtype,
        oax=np.where(own_a, ax, bx), oay=np.where(own_a, ay, by),
        pax=np.where(own_a, bx, ax), pay=np.where(own_a, by, ay),
        rest=np.where(own_a, rest, -rest),
        lo=np.where(own_a | ~rng_type, lo, -hi),
        hi=np.where(own_a | ~rng_type, hi, -lo),
        compliance=np.where(u(0, 1) < 0.5, 0.0, u(0, 1e-6)).astype(f),
        damping=np.where(u(0, 1) < 0.5, 0.0, u(0, 2)).astype(f),
        motor_speed=np.where(own_a, ms, -ms),
        motor_max=np.where(u(0, 1) < 0.5, 3.4e38, u(0, 100)).astype(f),
        im_o=np.where(u(0, 1) < 0.2, 0.0, u(0.1, 2)).astype(f),
        im_p=np.where(u(0, 1) < 0.3, 0.0, u(0.1, 2)).astype(f),
        ii_o=np.where(u(0, 1) < 0.3, 0.0, u(0.1, 5)).astype(f),
        ii_p=np.where(u(0, 1) < 0.3, 0.0, u(0.1, 5)).astype(f),
        active=(u(0, 1) < 0.9).astype(f),
    )
    an_o = u(-3.2, 3.2)
    # relative angles within 1e-3 of +-pi for a third of the slots, where
    # the wrap's floor flips
    near = u(0, 1) < 0.33
    an_p = np.where(near, an_o + jd["rest"] + np.where(u(0, 1) < 0.5, 1, -1)
                    * (np.float32(np.pi) + u(-1e-3, 1e-3)), u(-6, 6)).astype(f)
    pose = [u(-2, 2), u(-2, 2), None, None, u(-2, 2), u(-2, 2), None, None]
    pose[2], pose[3] = np.cos(an_o).astype(f), np.sin(an_o).astype(f)
    pose[6], pose[7] = np.cos(an_p).astype(f), np.sin(an_p).astype(f)
    vel = [u(-3, 3) for _ in range(6)]
    return jd, pose, vel, an_o, an_p


@pytest.mark.parametrize("seed", [0, 1])
def test_joint_math_matches_jax(seed):
    jd, pose, vel, an_o, an_p = _joint_inputs(seed)
    h = 1 / 60 / 4
    j_jd = SimpleNamespace(**{k: jnp.asarray(v) for k, v in jd.items()})
    t_jd = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in jd.items()})
    j_pose = jk.PairPose(*[jnp.asarray(x) for x in pose])
    t_pose = tk.PairPose(*[torch.as_tensor(x) for x in pose])
    ref = jk.solve_joints_b(j_pose, jnp.asarray(an_o), jnp.asarray(an_p),
                            j_jd, h)
    got = tk.solve_joints_b(t_pose, torch.as_tensor(an_o),
                            torch.as_tensor(an_p), t_jd, h)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())
    # every type and the angular rows did something
    for t in range(1, 6):
        rows = jd["jtype"] == t
        if t != 4:
            assert got[3].numpy()[rows].sum() > S_PER_TYPE / 2, t
    ref_v = jk.velocity_joints_b(j_pose, jk.PairVel(*map(jnp.asarray, vel)),
                                 j_jd, h)
    got_v = tk.velocity_joints_b(t_pose,
                                 tk.PairVel(*map(torch.as_tensor, vel)),
                                 t_jd, h)
    np.testing.assert_allclose(np.asarray(ref_v), got_v.numpy(), rtol=0,
                               atol=1e-5)
    motors = jd["jtype"] == 4
    assert np.abs(got_v[2].numpy()[motors]).max() > 0.1
    assert got_v[3].numpy()[~motors].sum() > 0  # damped joints


def test_wrap_pi_matches_jax():
    x = np.concatenate([
        np.float32(np.pi) * np.arange(-6, 7, dtype=np.float32),
        np.nextafter(np.float32(np.pi), np.float32(0)) * np.array(
            [-3, -1, 1, 3], np.float32),
        np.random.default_rng(0).uniform(-20, 20, 2000).astype(np.float32)])
    np.testing.assert_array_equal(np.asarray(jk._wrap_pi(jnp.asarray(x))),
                                  tk._wrap_pi(torch.as_tensor(x)).numpy())


# ---------------------------------------------------------------------------
# K3: the joint-slot twin against pallas/slots.py build_joint_slots
# ---------------------------------------------------------------------------


def _jax_joint_slots(world, JC):
    """The JAX package's call: the joint axis padded to a multiple of 128
    (parallel.py:305-314), Pallas in interpret mode."""
    j = world.joints
    J = j.j
    Jp = -(-J // 128) * 128

    def padj(x):
        return jnp.asarray(np.pad(x.numpy(), ((0, 0), (0, Jp - J))))

    return j_joint_slots(padj(j.body_a), padj(j.body_b),
                         padj((j.jtype != 0).to(torch.float32)),
                         n_bodies=world.bodies.n, JC=JC, interpret=True)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_joint_slot_twin_matches_pallas(name):
    world = st.replicate_world(SCENES[name][1](), 2)
    cfg = st.SolverConfig()
    got = parallel.frame2_joint_slots(world, cfg)
    assert hopper.build_joint_slots.launches == 0  # CPU took the twin
    ref = _jax_joint_slots(world, cfg.joint_slot_capacity)
    for field, a, b in zip(("jslot", "jside", "jact", "count"), ref, got):
        assert b.dtype == (torch.int32 if field in ("jslot", "count")
                           else torch.float32)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=field)
    assert int(got[3].max()) >= 2 and float(got[1].sum()) > 0
    assert int(parallel.frame2_inputs(world, cfg).joint_overflow) == 0


def test_joint_slot_overflow_matches_pallas():
    """JC = 2 on the rope bridge: the middle particle, which also holds the
    hanging rope, carries 3 joints."""
    world = st.replicate_world(
        st.scenes.rope_bridge(substeps=4, device="cpu").world, 2)
    cfg = st.SolverConfig(joint_slot_capacity=2)
    got = parallel.frame2_joint_slots(world, cfg)
    ref = _jax_joint_slots(world, 2)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    overflow = parallel.frame2_inputs(world, cfg).joint_overflow
    j_overflow = int(jnp.sum(jnp.maximum(ref[3] - 2, 0)))
    assert int(overflow) == j_overflow > 0
    assert int(got[3].max()) == 3
