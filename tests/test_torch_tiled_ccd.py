"""Continuous collision on the tile engine, and two repairs of the port's
sleep: K7's twin (``hopper.tile_ccd``) against the JAX package's
``_ccd_kernel`` in interpret mode, 3-frame ``tiled_rollout``s against the
JAX one (its per-substep kernels, as ``fuse=False`` runs them here), the
owner minimum against ``_owner_min3``, K10's CCD twin against K7 + K8 +
K9's, and the bullet checks of tests/test_ccd.py on the port's tile
engine; then the kinematic wake and the awake-set event contract.

The scene is tests/test_ccd.py's tile-engine world (a thin wall, a 0.05 m
bullet and 1022 far-away pads: 1024 bodies, 4 tiles), built by both
packages' builders; the compound world gives the bullet a second circle
(1025 rows, 5 tiles). Tolerances: K7's factors to 1e-6 with the same rows
clamped; the rollouts' poses to 5e-4 and velocities to 3e-2 (the tile
engine's own tolerance against the XLA tier, tests/test_tiles.py) with
every counter equal; the owner minimum and K10 against K7 + K8 + K9
bitwise; the behaviour checks at test_ccd.py's bounds.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.pallas import tiles as jpt  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402
from test_ccd import KCFG, WALL_FACE  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import events, hopper  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402
from starframe_tpu_torch.state import BODY_BULLET  # noqa: E402

from _torch_parity import (  # noqa: E402
    STATE_KEYS,
    build,
    build_tiled,
    jax_tile_manifold,
    jax_to_numpy,
    sol_from_jax,
)

CFG = st.SolverConfig(**dataclasses.asdict(
    dataclasses.replace(KCFG, frames_per_broadphase=1)))
GRAVITY = (0.0, 0.0)
COUNTERS = ("slot_overflow", "solve_overflow", "solve_dropped",
            "margin_dropped", "spec_dropped", "window_overflow",
            "joint_shard_overflow", "forced_resorts", "forced_rebuilds",
            "compacted_rows", "large_overflow")


def bullet_tiles(builder_cls, shape_cls, capacity_cls, speed=200.0, x0=-3.0,
                 restitution=0.0, target="static", two_colliders=False,
                 bullet=True, n=1024):
    """tests/test_ccd.py's tile-engine bullet world through either
    package's builder (``x0`` the bullet's start; ``two_colliders``: a
    second circle beside the first)."""
    wb = builder_cls()
    wb.gravity = GRAVITY
    wall = wb.add_body(pos=(0.0, 0.0), body_type=target)
    wb.add_collider(wall, shape_cls.box(0.1, 2.0), restitution=restitution)
    b = wb.add_body(pos=(x0, 0.0), vel=(speed, 0.0), bullet=bullet)
    offsets = ((0.0, -0.03), (0.0, 0.03)) if two_colliders else ((0.0, 0.0),)
    for off in offsets:
        wb.add_collider(b, shape_cls.circle(0.05), offset=off,
                        restitution=restitution)
    for i in range(n - 2):
        pad = wb.add_body(pos=(1000.0 + 2.0 * (i % 256), 5.0 * (i // 256)))
        wb.add_collider(pad, shape_cls.circle(0.3))
    cap = capacity_cls(max_bodies=n, max_colliders=n - 1 + len(offsets),
                       max_pairs=8 * n, max_joints=0, max_verts=4)
    return build(wb, cap)[0]


def _port(**kw):
    return bullet_tiles(st.WorldBuilder, st.Shape, st.Capacity, **kw)


def _jax(**kw):
    return bullet_tiles(JBuilder, JShape, JCapacity, **kw)


# ---- K7 against the JAX kernel ----------------------------------------------


def _jax_ccd(state, kc, large, pidx_c, cc, c2, tile_live, *, h, ccd_slop):
    """``pallas/tiles.py``'s ``_ccd_kernel`` as ``run_tiled_frame``'s
    substep launches it, in interpret mode, on a JAX tile layout."""
    Nt, Cs = pidx_c.shape[:2]

    def wrows(x):
        return [x, x, x]

    specs = (sum([list(jpt._window_specs(Nt)) for _ in range(6)], [])
             + [jpt._own_spec()] * 2 + [jpt._bcast((1, jpt.L))] * 3
             + [jpt._own3(Cs), jpt._own3(Cs * jpt.KC),
                jpt._own3(Cs * jpt.K2), jpt._bcast((1, 2)), jpt._own_spec()])
    args = (sum([wrows(state[k]) for k in STATE_KEYS], [])
            + [kc["dynb"], kc["blt"]]
            + [large[k] for k in ("px", "py", "an")]
            + [pidx_c, cc, c2, jnp.asarray([GRAVITY], jnp.float32),
               tile_live])
    kernel = functools.partial(jpt._ccd_kernel, C=Cs, h=h, ccd_slop=ccd_slop,
                               n_tiles=Nt)
    return pl.pallas_call(
        kernel, grid=(Nt,), in_specs=specs, out_specs=(jpt._own_spec(),),
        out_shape=(jax.ShapeDtypeStruct((Nt, 1, jpt.T), jnp.float32),),
        interpret=True)(*args)[0]


@jax.jit
def _jax_frame_start_ccd(state, kc, large, pidx, act, tile_live):
    """The JAX manifold kernel (Cs = 8) and then K7 on its solve tables:
    ``(cc, c2, pidx_c, f)``."""
    cc, c2, pidx_c = jax_tile_manifold(
        state, kc, large, pidx, act, tile_live, Cs=8, V=4,
        margin=CFG.contact_margin, dt=CFG.dt, sleep_velocity=0.0)[:3]
    f = _jax_ccd(state, kc, large, pidx_c, cc, c2, tile_live,
                 h=CFG.dt / CFG.substeps, ccd_slop=CFG.ccd_slop)
    return cc, c2, pidx_c, f


@pytest.mark.parametrize("speed", [200.0, 1000.0])
def test_tile_ccd_twin_matches_jax(speed):
    """The bullet 0.3 m from the wall, so the first substep already
    clamps: the JAX frame-start manifolds of the port's tables (equal to
    the JAX tables, tests/test_torch_tiles.py) feed both K7s."""
    jw, tw = _jax(speed=speed, x0=-0.3), _port(speed=speed, x0=-0.3)
    jcfg = JConfig(**dataclasses.asdict(CFG))
    js, jc, jl, _, _ = jt._enter_tiles(jw, jcfg)
    jel, jeh, _ = jt._edge_rows(js, jc, jcfg)
    ts, tc, tl, _, _ = tt._enter_tiles(tw, CFG)
    np.testing.assert_array_equal(np.asarray(jc["blt"]).reshape(-1),
                                  tc["blt"].reshape(-1).numpy())
    assert float(tc["blt"].sum()) == 1.0
    tel, teh, _ = tt._edge_rows(ts, tc, CFG)
    g = torch.tensor(GRAVITY)
    pidx, act = hopper.build_tile_tables(ts, tc, tl, tel, teh, g, C=8,
                                         margin=CFG.contact_margin,
                                         dt=CFG.dt)[:2]
    Nt = pidx.shape[0]
    jlive = jnp.ones((Nt, 1, jpt.T), jnp.float32)
    kc = dict(jc, edge_lo=jel, edge_hi=jeh)
    jstate = {k: js[k] for k in STATE_KEYS}
    cc, c2, jpidx_c, jf = _jax_frame_start_ccd(
        jstate, kc, jl, jnp.asarray(pidx.numpy()), jnp.asarray(act.numpy()),
        jlive)
    jf = np.asarray(jf)[:, 0]
    f = hopper.tile_ccd(ts, tc, tl, torch.as_tensor(np.array(jpidx_c)),
                        torch.as_tensor(sol_from_jax(cc, c2, 8)), g,
                        torch.ones(Nt), h=CFG.dt / CFG.substeps,
                        ccd_slop=CFG.ccd_slop)
    assert hopper.tile_ccd.launches == 0  # CPU tensors take the twin
    np.testing.assert_array_equal(jf < 1.0, f.numpy() < 1.0)
    np.testing.assert_allclose(jf, f.numpy(), rtol=0, atol=1e-6)
    clamped = f[tc["blt"] > 0]
    assert clamped.numel() == 1 and 0.0 < float(clamped) < 1.0, clamped
    assert bool((f[tc["blt"] == 0] == 1.0).all())


# ---- rollouts against the JAX tile engine -------------------------------------


@pytest.fixture(scope="module")
def jax_rollouts():
    """Three frames of each world through the JAX tile engine in interpret
    mode (its per-substep kernels): ``{world: (final, diag)}``."""
    jcfg = JConfig(**dataclasses.asdict(CFG))
    out = {}
    for name, kw in ROLLOUT_WORLDS.items():
        run = jax.jit(lambda w: jt.tiled_rollout(w, jcfg, 3, interpret=True))
        out[name] = run(_jax(**kw))
    return out


ROLLOUT_WORLDS = {"single": dict(), "compound": dict(two_colliders=True)}


@pytest.mark.parametrize("world", sorted(ROLLOUT_WORLDS))
def test_tiled_rollout_ccd_matches_jax(jax_rollouts, world):
    jf, jd = jax_rollouts[world]
    tw = _port(**ROLLOUT_WORLDS[world])
    launches = hopper.tile_ccd.launches
    tf, td = st.tiled_rollout(tw, CFG, 3, fuse=False)
    assert hopper.tile_ccd.launches == launches
    a, b = jax_to_numpy(jf), tio.world_to_numpy(tf)
    for k in ("bodies/pos", "bodies/angle", "bodies/prev_pos",
              "bodies/prev_angle"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
    for k in ("bodies/vel", "bodies/ang_vel"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-2, err_msg=k)
    keys = COUNTERS + (("owner_overflow",) if world == "compound" else ())
    assert {k: int(jd[k]) for k in keys} == {k: int(td[k]) for k in keys}
    x = float(b["bodies/pos"][1, 0])
    assert x < 0.0, x  # the bullet hit the wall within the three frames
    assert abs(float(b["bodies/vel"][1, 0])) < 200.0


def test_owner_min_twin_matches_jax():
    """``hopper.owner_min``'s twin bitwise against ``_owner_min3`` on the
    compound world's owner column and seeded values, ``+inf`` included."""
    _, consts, _, _, _ = tt._enter_tiles(_port(two_colliders=True), CFG)
    ob = consts["obody"].reshape(-1)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, ob.shape[0]).astype(np.float32)
    x[rng.integers(0, x.size, 16)] = np.inf
    shape = consts["obody"].shape
    ref = np.asarray(jpt._owner_min3(jnp.asarray(x.reshape(shape)),
                                     jnp.asarray(ob.numpy()), 2))
    got = hopper.owner_min([torch.as_tensor(x.reshape(shape))], ob, 2)[0]
    np.testing.assert_array_equal(ref, got.numpy())
    # the bullet's two rows share their body's minimum
    rows = torch.nonzero(consts["blt"].reshape(-1) > 0)[:, 0]
    assert rows.numel() == 2
    assert float(got.reshape(-1)[rows[0]]) == float(got.reshape(-1)[rows[1]])


@pytest.mark.parametrize("world", sorted(ROLLOUT_WORLDS))
def test_tile_frame_ccd_twin_matches_substep_twins(world):
    """K10's CCD form (its twin: ``fuse=True``) against K7, K8 and K9
    launched once a substep (their twins: ``fuse=False``), bitwise: a
    compound world runs K7 + ``owner_min`` + K8 + K9 either way."""
    tw = _port(x0=-0.3, **ROLLOUT_WORLDS[world])
    a, da = st.tiled_rollout(tw, CFG, 2, fuse=True)
    b, db = st.tiled_rollout(tw, CFG, 2, fuse=False)
    for field in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, field),
                           getattr(b.bodies, field)), field
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}
    assert float(a.bodies.pos[1, 0]) < WALL_FACE + 0.01


# ---- test_ccd.py's checks on the port's tile engine --------------------------


@pytest.mark.parametrize("speed", [200.0, 1000.0])
def test_tiled_bullet_never_tunnels(speed):
    out, diag = st.tiled_rollout(_port(speed=speed), CFG, 12)
    assert int(diag["slot_overflow"]) == 0
    x = float(out.bodies.pos[1, 0])
    assert WALL_FACE - 0.06 < x <= WALL_FACE + 0.01, x


def test_tiled_bullet_restitution_sees_true_approach_speed():
    out, _ = st.tiled_rollout(_port(speed=1000.0, restitution=0.9), CFG, 10)
    vx = float(out.bodies.vel[1, 0])
    assert -950.0 < vx < -820.0, vx


def test_tiled_bullet_into_dynamic_target_transfers_momentum():
    out, _ = st.tiled_rollout(_port(speed=500.0, target="dynamic"), CFG, 30)
    assert float(out.bodies.pos[1, 0]) < float(out.bodies.pos[0, 0])
    assert float(out.bodies.vel[0, 0]) > 0.1


@pytest.mark.parametrize("fuse", [True, False])
def test_tiled_ccd_inert_for_unflagged_scenes(fuse):
    """No body flagged: on the falling 4-tile scene of tests/test_tiles.py
    ``ccd=True`` leaves the rollout bitwise that of ``ccd=False``."""
    b, cap = build_tiled(st.WorldBuilder, st.Shape)
    w = build(b, st.Capacity(**cap))[0]
    assert not bool(((w.bodies.flags & BODY_BULLET) != 0).any())
    cfg = st.SolverConfig(substeps=4, slot_capacity=16, tile_solve_capacity=8,
                          ccd=True)
    on, don = st.tiled_rollout(w, cfg, 3, fuse=fuse)
    off, doff = st.tiled_rollout(w, dataclasses.replace(cfg, ccd=False), 3,
                                 fuse=fuse)
    for field in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(on.bodies, field),
                           getattr(off.bodies, field)), field
    assert {k: int(v) for k, v in don.items()} == {
        k: int(v) for k, v in doff.items()}


def test_ccd_gates():
    """CCD runs on the tile engine through the normal gate; per-substep
    manifolds keep a world off it, as in the JAX package."""
    w = _port()
    assert st.use_tiled(w, CFG)
    assert not st.use_tiled(w, dataclasses.replace(
        CFG, manifold_refresh="substep"))


# ---- the repairs of ROADMAP.md C ---------------------------------------------


def _sleeping_world(bodies, sleeping):
    """A ground, the given ``(pos, vel, kind, half extents)`` boxes and 1021
    - len(bodies) pads in the air, at least 4 tiles; the boxes named in
    ``sleeping`` and every pad asleep (counters at ``sleep_frames``)."""
    b = st.WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, st.Shape.box(400.0, 0.5), friction=0.5)
    ids = []
    for pos, vel, kind, half in bodies:
        body = b.add_body(pos=pos, vel=vel, body_type=kind)
        b.add_collider(body, st.Shape.box(*half), friction=0.5)
        ids.append(body)
    n_pads = 1024 - 1 - len(bodies)
    for i in range(n_pads):
        pad = b.add_body(pos=(-60.0 + 0.5 * (i % 240), 20.0 + (i // 240)))
        b.add_collider(pad, st.Shape.circle(0.2))
    w, _ = build(b, st.Capacity(max_bodies=1024, max_colliders=1024,
                                max_pairs=8192, max_joints=0, max_verts=4))
    cfg = st.SolverConfig(substeps=2, sleep_velocity=0.1)
    asleep = torch.zeros(w.bodies.n, dtype=torch.bool)
    asleep[1 + len(bodies):] = True
    asleep[[ids[k] for k in sleeping]] = True
    counts = torch.where(asleep, cfg.sleep_frames, w.bodies.sleep_count)
    w = dataclasses.replace(w, bodies=dataclasses.replace(
        w.bodies, sleep_count=counts.to(w.bodies.sleep_count.dtype)))
    return w, cfg, ids


@pytest.mark.parametrize("platform_speed", [0.15, 0.05])
def test_kinematic_platform_wakes_a_sleeper(platform_speed):
    """A kinematic platform under a sleeping box wakes it when it moves at
    ``sleep_velocity`` (0.1) or faster, without ``wake_velocity_factor``:
    at 0.15 the box wakes (its counter resets) and rides along; at 0.05 it
    stays asleep. The JAX package wakes sleepers on dynamic partners only
    (``pallas/tiles.py:626-638``), so there the box never wakes."""
    w, cfg, (plat, box) = _sleeping_world(
        [((-80.0, 0.25), (platform_speed, 0.0), "kinematic", (1.0, 0.25)),
         ((-80.0, 0.75), (0.0, 0.0), "dynamic", (0.25, 0.25))], [1])
    assert w.colliders.m >= 4 * 256
    out, diag = st.tiled_rollout(w, cfg, 3)
    assert int(diag["slot_overflow"]) == 0
    count = int(out.bodies.sleep_count[box])
    if platform_speed >= cfg.sleep_velocity:
        assert count < cfg.sleep_frames, count
        assert float(out.bodies.pos[box, 0]) > -80.0  # carried by friction
    else:
        assert count >= cfg.sleep_frames, count
        assert float(out.bodies.pos[box, 0]) == -80.0
    # the pads far away sleep on either way
    assert bool((out.bodies.sleep_count[3:] >= cfg.sleep_frames).all())


def test_events_under_sleep_cover_the_awake_set():
    """With sleep on, ``with_events`` reports the awake set: a touching
    pair whose rows both sleep gives -1, an awake touching pair its key."""
    w, cfg, (a1, a2, b1, b2) = _sleeping_world(
        [((-100.0, 0.5), (0.0, 0.0), "dynamic", (0.5, 0.5)),
         ((-100.0, 1.5), (0.0, 0.0), "dynamic", (0.5, 0.5)),
         ((100.0, 0.5), (0.0, 0.0), "dynamic", (0.5, 0.5)),
         ((100.0, 1.5), (0.0, 0.0), "dynamic", (0.5, 0.5))], [0, 1])
    _, _, keys = st.tiled_rollout(w, cfg, 1, with_events=True)
    pairs = events.keys_to_set(keys, w.colliders.m)
    # collider k belongs to body k here (one collider a body)
    assert (b1, b2) in pairs and (0, b1) in pairs
    assert (a1, a2) not in pairs and (0, a1) not in pairs
