"""The tile engine with sleep: the port's ``tiled_step``, ``tiled_rollout``
(awake-prefix compaction, the all-asleep frame skip), its keep set and its
whole-frame kernel's plain twin, held against the JAX package
(``interpret=True``) on the 1024-body sleep scene of
tests/test_sleep_tiers.py (4 tiles: a sleeping row on the ground and an
awake row falling above its left third), built by the JAX package and
carried across as numpy.

Tolerances: poses 5e-4 and velocities 3e-2 (the tile engine's own
tolerance against the XLA tier, tests/test_sleep_tiers.py), every counter
and every sleep counter equal, sleepers no awake body reaches bit-frozen;
the keep set's boxes to 1e-6, its ``kept`` flags and permutation equal; the
whole-frame twin's ``touched`` equal and its state to 1e-5 against the
JAX megakernel on the same solve tables.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.pallas import tiles as jpt  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402

from _torch_parity import (  # noqa: E402
    STATE_KEYS,
    jax_tile_manifold,
    jax_to_numpy,
    numpy_to_jax,
    sol_from_jax,
)
from test_sleep_tiers import _cfg, _presleep, _sleep_scene  # noqa: E402

COUNTERS = ("slot_overflow", "solve_overflow", "solve_dropped",
            "margin_dropped", "spec_dropped", "window_overflow",
            "joint_shard_overflow", "forced_resorts", "forced_rebuilds",
            "compacted_rows", "large_overflow")


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(jworld):
    return tio.world_from_numpy(jax_to_numpy(jworld), device="cpu")


def _port_cfg(jcfg):
    return st.SolverConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def asleep_half():
    """The sleep scene with its ground row put to sleep: ``(world, cfg,
    sleepers)``, in the JAX package."""
    world, _, sleepers = _sleep_scene()
    cfg = _cfg()
    return _presleep(world, sleepers, cfg.sleep_frames), cfg, sleepers


@pytest.fixture(scope="module")
def impact(asleep_half):
    """The fast impactor of test_tiled_rollout_sleepers_frozen_and_wake
    (8 m/s onto the sleeper a quarter along the row), K = 4, compaction on:
    both packages' 8-frame rollouts from the same world."""
    world, cfg, sleepers = asleep_half
    cfg = dataclasses.replace(cfg, frames_per_broadphase=4)
    b = world.bodies
    target = sleepers[len(sleepers) // 4]
    tpos = np.asarray(b.pos)[target]
    pos = b.pos.at[sleepers[-1] + 1].set(jnp.asarray([float(tpos[0]), 1.4]))
    vel = b.vel.at[sleepers[-1] + 1].set(jnp.asarray([0.0, -8.0]))
    world = dataclasses.replace(
        world, bodies=dataclasses.replace(b, pos=pos, vel=vel))
    jf, jd = jax.jit(lambda w: jt.tiled_rollout(w, cfg, 8,
                                                interpret=True))(world)
    syncs = tt.host_syncs
    tf, td = st.tiled_rollout(_port(world), _port_cfg(cfg), 8)
    return dict(world=world, cfg=cfg, sleepers=sleepers, target=target,
                jf=jf, jd=jd, tf=tf, td=td, syncs=tt.host_syncs - syncs)


@pytest.fixture(scope="module")
def resting_row():
    """A row of 1023 circles resting on the ground, each overlapping its
    neighbours by 2 cm (4 tiles, every body touching the ground and two
    others), the right 60% asleep: ``(world, cfg)`` in the JAX package, K
    = 4."""
    b = JBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, JShape.box(700.0, 0.5), friction=0.5)
    for i in range(1023):
        body = b.add_body(pos=(-450.0 + 0.88 * i, 0.45))
        b.add_collider(body, JShape.circle(0.45), friction=0.5)
    world, _ = b.build(JCapacity(max_bodies=1024, max_colliders=1024,
                                 max_pairs=8192, max_joints=0, max_verts=4))
    cfg = _cfg(frames_per_broadphase=4)
    return _presleep(world, np.arange(410, 1024), cfg.sleep_frames), cfg


def _assert_bodies_close(jw, tw):
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k in ("bodies/pos", "bodies/angle", "bodies/prev_pos",
              "bodies/prev_angle"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
    for k in ("bodies/vel", "bodies/ang_vel"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-2, err_msg=k)
    for k in ("bodies/sleep_count", "step_count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_frozen(world, tw, rows):
    for k in ("pos", "angle", "vel", "ang_vel"):
        np.testing.assert_array_equal(
            getattr(tw.bodies, k).numpy()[rows],
            np.asarray(getattr(world.bodies, k))[rows], err_msg=k)


def test_tiled_step_with_sleepers_matches_jax(asleep_half):
    """Two ``tiled_step`` frames: sleepers frozen for the frame, the sleep
    counters counted the same way, the falling row integrated."""
    world, cfg, sleepers = asleep_half
    jw, tw = world, _port(world)
    for _ in range(2):
        jw, _ = jt.tiled_step(jw, cfg, interpret=True)
        tw, _ = st.tiled_step(tw, _port_cfg(cfg))
    _assert_bodies_close(jw, tw)
    _assert_frozen(world, tw, sleepers)
    falling = tw.bodies.pos.numpy()[sleepers[-1] + 1:, 1]
    assert (falling < np.asarray(world.bodies.pos)[sleepers[-1] + 1:, 1]).all()


def test_tiled_rollout_impactor_matches_jax(impact):
    """Eight frames with compaction on: every counter equal (the partition,
    the forced re-sorts and rebuilds among them), the struck sleeper woken
    the same way, sleepers far from it bit-frozen, one host sync a frame."""
    jd, td = impact["jd"], impact["td"]
    assert sorted(td) == sorted(COUNTERS)
    assert {k: int(jd[k]) for k in COUNTERS} == {
        k: int(td[k]) for k in COUNTERS}
    assert int(td["compacted_rows"]) > 0
    assert impact["syncs"] == 8
    _assert_bodies_close(impact["jf"], impact["tf"])
    sc = impact["tf"].bodies.sleep_count.numpy()
    assert sc[impact["target"]] < impact["cfg"].sleep_frames
    sleepers = impact["sleepers"]
    far = sleepers[3 * len(sleepers) // 4:]
    _assert_frozen(impact["world"], impact["tf"], far)
    assert (sc[far] >= impact["cfg"].sleep_frames).all()


def test_compaction_k2_matches_jax(asleep_half):
    """tests/test_awake_compaction.py's compacted run (K = 2, 6 frames):
    the same rows compacted and the same sleep counters."""
    world, cfg, _ = asleep_half
    cfg = dataclasses.replace(cfg, frames_per_broadphase=2)
    jf, jd = jax.jit(lambda w: jt.tiled_rollout(w, cfg, 6,
                                                interpret=True))(world)
    tf, td = st.tiled_rollout(_port(world), _port_cfg(cfg), 6)
    assert int(td["compacted_rows"]) > 0
    assert {k: int(jd[k]) for k in COUNTERS} == {
        k: int(td[k]) for k in COUNTERS}
    _assert_bodies_close(jf, tf)


def test_keep_set_matches_jax(impact):
    """``_keep_boxes``, ``_keep_hop`` and ``_partition_perm`` on the
    impactor's sorted layout: the impactor's box reaches the sleepers
    under it, and the hops spread along the resting row."""
    world, cfg = impact["world"], impact["cfg"]
    tcfg = _port_cfg(cfg)
    js, jc, _, _, _ = jt._enter_tiles(world, cfg)
    ts, tc, _, _, _ = tt._enter_tiles(_port(world), tcfg)
    Nt = ts["px"].shape[0]
    jboxes, jmova, jawake = jt._keep_boxes(js, jc, cfg,
                                           jnp.asarray([0.0, -9.81]))
    tboxes, tmova, tawake = tt._keep_boxes(ts, tc, tcfg,
                                           torch.tensor([0.0, -9.81]))
    for a, b in zip(jboxes, tboxes):
        np.testing.assert_allclose(_n(a), _n(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_n(jmova), _n(tmova))
    np.testing.assert_array_equal(_n(jawake), _n(tawake))
    jkey = jnp.where((jc["act"].reshape(-1) > 0) & (jc["mov"].reshape(-1) > 0),
                     js["px"].reshape(-1), jnp.where(
                         jc["act"].reshape(-1) > 0, jt._BIG, 2 * jt._BIG))
    tkey = tt._sort_key(tc["act"].reshape(-1), tc["mov"].reshape(-1),
                        ts["px"].reshape(-1))
    jperm, tperm = jnp.argsort(jkey), torch.argsort(tkey, stable=True)
    np.testing.assert_array_equal(_n(jperm), _n(tperm))
    hop_j = jt._keep_hop(tuple(b[jperm] for b in jboxes), jawake[jperm], Nt,
                         256)
    hop_t = tt._keep_hop(tuple(b[tperm] for b in tboxes), tawake[tperm], Nt)
    np.testing.assert_array_equal(_n(hop_j), _n(hop_t))
    jp, jkept = jt._partition_perm(
        jkey[jperm], tuple(b[jperm] for b in jboxes), jmova[jperm],
        jawake[jperm], Nt, 256)
    tp, tkept = tt._partition_perm(
        tkey[tperm], tuple(b[tperm] for b in tboxes), tmova[tperm],
        tawake[tperm], Nt)
    np.testing.assert_array_equal(_n(jkept), _n(tkept))
    np.testing.assert_array_equal(_n(jp), _n(tp))
    # the keep set holds sleepers (reached by the impactor and the hops)
    # and leaves most of the resting row out
    n_awake, n_kept = int(tawake.sum()), int((tkept & tmova[tperm]).sum())
    assert n_awake < n_kept < int(tmova.sum()) - 256


def test_all_asleep_world_launches_nothing(asleep_half, monkeypatch):
    """Every dynamic body asleep: no frame runs (the kernels are not even
    called), the state is bit-identical and the step count advances."""
    world, cfg, _ = asleep_half
    dyn = np.flatnonzero(np.asarray(world.bodies.inv_mass) > 0)
    tw = _port(_presleep(world, dyn, cfg.sleep_frames))
    frames = []
    monkeypatch.setattr(tt, "run_tiled_frame",
                        lambda *a, **k: frames.append(1))
    syncs = tt.host_syncs
    tf, td = st.tiled_rollout(tw, _port_cfg(cfg), 4)
    assert not frames
    assert tt.host_syncs - syncs == 4  # the one read a frame says so
    for k in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(tf.bodies, k), getattr(tw.bodies, k)), k
    assert int(tf.step_count) == int(tw.step_count) + 4
    assert int(td["slot_overflow"]) == int(td["window_overflow"]) == 0


def _partitioned(jworld, cfg):
    """Both packages' layouts of ``jworld`` after the compacting re-sort,
    with the K-frame tables built on it (the port's twin; equal to the JAX
    package's, tests/test_torch_tiles.py), and the live prefix in tiles."""
    tcfg = _port_cfg(cfg)
    g = torch.tensor([0.0, -9.81])
    ts, tc, tl, tbid, _ = tt._enter_tiles(_port(jworld), tcfg)
    ts, tc, tbid = tt._compact_resort(ts, tc, tbid, tcfg, g, "px")
    Nt = ts["px"].shape[0]
    el, eh, _ = tt._edge_rows(ts, tc, tcfg)
    tables = hopper.build_tile_tables(
        ts, tc, tl, el, eh, g, C=tt._table_cap(tcfg),
        margin=cfg.contact_margin, dt=cfg.dt,
        sweep_frames=cfg.frames_per_broadphase,
        sweep_slack=cfg.broadphase_speed_slack,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)[:2]
    js, jc, jl, _, _ = jt._enter_tiles(jworld, cfg)
    js = {k: jnp.asarray(_n(v).reshape(Nt, 1, 256)) for k, v in ts.items()}
    jc = dict({k: jnp.asarray(_n(v).reshape(jc[k].shape))
               for k, v in tc.items()}, blt=jnp.zeros_like(jc["blt"]))
    live_rows = int((tc["kept"] * tc["mov"] * tc["act"]).sum())
    return (dict(state=js, consts=jc, large=jl, tables=tuple(
                jnp.asarray(_n(x)) for x in tables)),
            dict(state=ts, consts=tc, large=tl, body_id=tbid, tables=tables,
                 cfg=tcfg),
            -(-live_rows // 256))


def test_partitioned_frame_keys_match_full_grid(resting_row):
    """The fault the port does not inherit (ROADMAP.md C): on a partitioned
    layout whose live prefix ends before the last tile, the JAX package's
    compiled path runs the frame on a smaller grid, whose last tile reads
    its build-time partner indices against a shifted window. The port runs
    every frame on the full grid: its touching pair keys equal the JAX
    package's full-grid frame (interpret mode, no grid buckets)."""
    jworld, cfg = resting_row
    j, t, n_live = _partitioned(jworld, cfg)
    Nt = t["state"]["px"].shape[0]
    assert n_live < Nt, "the live prefix fills the grid: vacuous"
    gj = jnp.asarray([0.0, -9.81])
    jstate, _, jdiag = jt._run_frame(j["state"], j["consts"], j["large"], cfg,
                                     gj, interpret=True, tables=j["tables"],
                                     n_live_t=jnp.int32(n_live))
    tstate, _, frame = tt._run_frame(t["state"], t["consts"], t["large"],
                                     t["cfg"], torch.tensor([0.0, -9.81]),
                                     tables=t["tables"])
    M = jworld.colliders.m
    jkeys = jt.touch_keys(jdiag["touched"], jdiag["pidx"],
                          jnp.asarray(_n(t["body_id"])), j["large"]["cols"], M)
    tkeys = tt.touch_keys(frame[0], frame[6], t["body_id"],
                          t["large"]["cols"], M)
    np.testing.assert_array_equal(_n(jkeys), _n(tkeys))
    assert int((tkeys >= 0).sum()) > 50, "few touches: vacuous"
    assert int((tkeys[n_live - 1] >= 0).sum()) > 0, "no touch at the edge"
    for k in STATE_KEYS:
        atol = 5e-4 if k in ("px", "py", "an") else 3e-2
        np.testing.assert_allclose(_n(jstate[k]).reshape(Nt, -1),
                                   _n(tstate[k]), rtol=0, atol=atol)


def test_whole_frame_twin_matches_jax_megakernel(resting_row):
    """K10's plain twin (the K8/K9 twins looped over the substeps) against
    the JAX package's megakernel itself (``_run_mega``, what
    ``run_tiled_frame(..., fuse=True)`` runs, in interpret mode), 2
    substeps, tile 1 skipped, both on the JAX manifold kernel's solve
    tables, so that only the substeps' math is compared."""
    jworld, cfg = resting_row
    j, t, _ = _partitioned(jworld, cfg)
    Nt, Cs = t["state"]["px"].shape[0], tt._solve_cap(t["cfg"])
    live = np.ones(Nt, np.float32)
    live[1] = 0.0
    jlive = jnp.broadcast_to(jnp.asarray(live)[:, None, None], (Nt, 1, 256))
    mani = jax_tile_manifold(j["state"], j["consts"], j["large"],
                             *j["tables"], jlive, Cs=Cs, V=4,
                             margin=cfg.contact_margin, dt=cfg.dt,
                             sleep_velocity=0.0)
    h = cfg.dt / 2
    kw = dict(substeps=2, h=h, compliance=cfg.contact_compliance,
              relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
              rest_threshold=cfg.restitution_threshold,
              lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    jstate, jtouched = jpt._run_mega(
        j["state"], j["consts"], j["large"], mani[2], mani[0], mani[1],
        jnp.asarray([[0.0, -9.81]]), jlive, C=Cs, ccd=False,
        ccd_slop=cfg.ccd_slop, interpret=True, params=None, **kw)
    tstate, ttouched = hopper.tile_frame(
        t["state"], t["consts"], t["large"], torch.as_tensor(np.array(mani[2])),
        torch.as_tensor(sol_from_jax(mani[0], mani[1], Cs)),
        torch.tensor([0.0, -9.81]), torch.as_tensor(live), **kw)
    np.testing.assert_array_equal(_n(jtouched), _n(ttouched))
    assert _n(ttouched).sum() > 50, "few touching slots: vacuous"
    assert not _n(ttouched)[1].any()
    for k in STATE_KEYS:
        np.testing.assert_allclose(_n(jstate[k]).reshape(Nt, -1),
                                   _n(tstate[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
        assert torch.equal(tstate[k][1], t["state"][k][1]), k
