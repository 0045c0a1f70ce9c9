"""Compound bodies on the port's tile engine, held against the JAX package
(``interpret=True``) on the compound scene of tests/test_tiled_compound.py
(515 two-collider dumbbells and L-shapes, 1033 collider rows in 5 tiles),
built by both packages' builders: the builder and ``scenes.pile_compound``,
the owner-grouped layout, the owner reductions, K9's compound form, one
``tiled_step``, a 3-frame ``tiled_rollout`` without and with CCD (every
dynamic body a bullet), fused (the compound frame's twin) and not, the
fused frame's dispatch, and the gates (with sleep:
tests/test_torch_tiled_compound_paths.py).

The scene starts in the air, so the frames compared run from its state 20
frames into a port rollout (2 substeps, K = 2), carried across as numpy,
where bodies rest on the ground and on each other.

Tolerances: arrays, layouts, integer outputs, counters and sleep counters
equal; the owner reductions bitwise; poses 1e-4 and velocities 3e-2 (the
tile engine's own tolerance against the XLA tier, tests/test_tiled_compound
.py); one apply substep's state and velocity sums 1e-5 (float32 rounding
of ``cos``/``sin`` in the two packages, on the same solve tables).
"""

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402
from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.pallas import tiles as jpt  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402
from starframe_tpu_torch.hopper import tiles as ht  # noqa: E402
from starframe_tpu_torch.state import BODY_BULLET  # noqa: E402

from _torch_parity import (  # noqa: E402
    STATE_KEYS,
    build_compound,
    compound_resting,
    jax_tile_apply,
    jax_to_numpy,
    numpy_to_jax,
    sol_to_jax,
)
from test_tiled_compound import _cfg, _compound_scene  # noqa: E402

COUNTERS = ("slot_overflow", "solve_overflow", "solve_dropped",
            "margin_dropped", "spec_dropped", "window_overflow",
            "joint_shard_overflow", "forced_resorts", "forced_rebuilds",
            "compacted_rows", "large_overflow", "owner_overflow")


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(jworld):
    return tio.world_from_numpy(jax_to_numpy(jworld), device="cpu")


def _port_cfg(jcfg):
    return st.SolverConfig(**dataclasses.asdict(jcfg))


def _assert_bodies_close(jw, tw):
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k in ("bodies/pos", "bodies/angle", "bodies/prev_pos",
              "bodies/prev_angle"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("bodies/vel", "bodies/ang_vel"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-2, err_msg=k)
    for k in ("bodies/sleep_count", "step_count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def resting():
    """The compound scene 20 frames in: ``(JAX world, port world, JAX
    config)``."""
    return compound_resting()


def test_compound_builders_match_jax():
    """The compound scene and ``scenes.pile_compound`` hold the same arrays
    in both packages (same draws, offsets baked into the vertices), and
    the pile's config and capacity are the JAX package's."""
    jw, _ = _compound_scene()
    tb, cap = build_compound(st.WorldBuilder, st.Shape)
    tw, _ = tb.build(st.Capacity(**cap), device="cpu")
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    js = sf.scenes.pile_compound(n_bodies=300)
    ts = st.scenes.pile_compound(n_bodies=300, device="cpu")
    a, b = jax_to_numpy(js.world), tio.world_to_numpy(ts.world)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ts.world.colliders.m == 3 + 2 * 300
    assert dataclasses.asdict(js.capacity) == dataclasses.asdict(ts.capacity)
    assert dataclasses.asdict(js.config) == dataclasses.asdict(ts.config)
    assert ts.config.slot_capacity == 24 and ts.config.sleep_velocity > 0


@pytest.fixture(scope="module")
def layouts(resting):
    """Both packages' tile layouts of the resting world."""
    jw, tw, cfg = resting
    js, jc, jl, jbid, _ = jt._enter_tiles(jw, cfg)
    ts, tc, tl, tbid, _ = tt._enter_tiles(tw, _port_cfg(cfg))
    return (dict(state=js, consts=jc, large=jl, body_id=jbid),
            dict(state=ts, consts=tc, large=tl, body_id=tbid,
                 cfg=_port_cfg(cfg)))


def test_enter_tiles_groups_siblings_like_jax(layouts):
    """The owner-grouped sort: the same rows in the same order (``body_id``,
    ``obody``, state, consts); every body's rows contiguous, bit-identical
    in state; and a re-sort keeps the blocks (stable sort, equal keys)."""
    j, t = layouts
    Nt = t["state"]["px"].shape[0]
    assert Nt == 5
    np.testing.assert_array_equal(_n(j["body_id"]), _n(t["body_id"]))
    for k in STATE_KEYS:
        np.testing.assert_array_equal(_n(j["state"][k]).reshape(Nt, -1),
                                      _n(t["state"][k]), err_msg=k)
    for k, v in t["consts"].items():
        np.testing.assert_array_equal(_n(j["consts"][k]).reshape(v.shape),
                                      _n(v), err_msg=k)
    resorted = tt._resort(t["state"], t["consts"], t["body_id"])[1]
    for consts in (t["consts"], resorted):
        o = consts["obody"].reshape(-1).numpy()
        starts = np.flatnonzero(np.r_[True, o[1:] != o[:-1]])
        assert len(np.unique(o)) == len(starts), "a sibling block split"
    ob = t["consts"]["obody"].reshape(-1)
    same = ob[1:] == ob[:-1]
    assert int(same.sum()) == 515, "not two rows a dynamic body"
    for k in STATE_KEYS:
        x = t["state"][k].reshape(-1)
        assert torch.equal(x[1:][same], x[:-1][same]), k


OPS = {"sum": (torch.add, 0.0, jnp.add, jnp.float32(0)),
       "max": (torch.maximum, float("-inf"), jnp.maximum,
               jnp.float32(-jnp.inf)),
       "or": (torch.logical_or, False, jnp.logical_or, jnp.bool_(False))}


@pytest.mark.parametrize("kc", [2, 4])
@pytest.mark.parametrize("op", sorted(OPS))
def test_owner_reduce_matches_jax_bitwise(op, kc):
    """``owner_reduce`` against ``_owner_shift_reduce`` on 2048 rows of
    seeded random values in blocks of 1 to ``kc`` rows, with blocks at both
    ends (the rolls wrap around them, and distinct owners there must not
    merge): bitwise equal; and ``owner_sum``'s twin is the ``sum`` case."""
    rng = np.random.default_rng(kc)
    sizes = rng.integers(1, kc + 1, size=2048)
    ob = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)[:2048]
    vals = rng.normal(size=2048).astype(np.float32) * 10 ** rng.integers(
        -3, 3, size=2048).astype(np.float32)
    if op == "or":
        vals = vals > 1.0
    top, tneutral, jop, jneutral = OPS[op]
    got = ht.owner_reduce(torch.as_tensor(vals), torch.as_tensor(ob), kc, top,
                          tneutral)
    ref = jpt._owner_shift_reduce(jnp.asarray(vals), jnp.asarray(ob), kc, jop,
                                  jneutral)
    np.testing.assert_array_equal(_n(ref), _n(got))
    assert ob[0] != ob[-1]
    if op == "sum":
        (s,) = hopper.owner_sum([torch.as_tensor(vals)], torch.as_tensor(ob),
                                kc)
        np.testing.assert_array_equal(_n(ref), _n(s))
        assert not np.array_equal(_n(ref), vals), "no block summed: vacuous"


def test_apply_compound_twin_matches_jax(layouts):
    """K9's compound form (``tile_apply(..., compound=True)``'s twin)
    against ``_apply_kernel(compound=True)`` in interpret mode, on the same
    solve tables (the port's manifold twin's, equal to the JAX kernel's,
    tests/test_torch_tiles.py) and one substep's owner-summed project sums:
    the state before the velocity pass and the raw velocity sums; and
    ``owner_velocity``'s twin is ``run_tiled_frame``'s tail."""
    j, t = layouts
    cfg = t["cfg"]
    Nt, C, Cs = 5, tt._table_cap(cfg), tt._solve_cap(cfg)
    g = torch.tensor([0.0, -9.81])
    el, eh, _ = tt._edge_rows(t["state"], t["consts"], cfg)
    pidx, act = hopper.build_tile_tables(
        t["state"], t["consts"], t["large"], el, eh, g, C=C,
        margin=cfg.contact_margin, dt=cfg.dt)[:2]
    live = torch.ones(Nt)
    sol, pidx_c = hopper.tile_manifold(
        t["state"], t["consts"], t["large"], pidx, act, live, Cs=Cs,
        margin=cfg.contact_margin, dt=cfg.dt)[:2]
    jlive = jnp.ones((Nt, 1, 256), jnp.float32)
    cc, c2 = sol_to_jax(sol, pidx_c)
    h = cfg.dt / cfg.substeps
    *corr, lam, _ = hopper.tile_project(
        t["state"], t["consts"], t["large"], pidx_c, sol, g,
        torch.zeros(pidx_c.shape), live, h=h,
        compliance=cfg.contact_compliance)
    ob = t["consts"]["obody"].reshape(-1)
    corr = hopper.owner_sum(corr, ob, cfg.max_colliders_per_body)
    akw = dict(h=h, relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    new, accv = hopper.tile_apply(t["state"], corr, t["consts"], t["large"],
                                  pidx_c, sol, lam, g, live, **akw,
                                  compound=True)
    jout = jax_tile_apply(
        j["state"], [jnp.asarray(_n(c)).reshape(Nt, 1, 256) for c in corr],
        j["consts"], j["large"], jnp.asarray(_n(pidx_c)), cc, c2,
        jnp.asarray(_n(lam)).reshape(Nt, 2 * Cs, 256), jlive, **akw,
        compound=True)
    for k, jv in zip(STATE_KEYS, jout[:6]):
        np.testing.assert_allclose(_n(jv).reshape(Nt, -1), _n(new[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(_n(jout[6]).transpose(1, 0, 2), _n(accv),
                               rtol=0, atol=1e-5)
    assert torch.equal(torch.as_tensor(_n(jout[6])[:, 3].copy()), accv[3])
    assert int((_n(accv)[3] > 0).sum()) > 100, "few velocity rows: vacuous"
    # the frame's velocity tail: owner sums, normalised, then damping
    av = jpt._owner_shift_reduce(
        jout[6].transpose(0, 2, 1).reshape(-1, 4), jnp.asarray(_n(ob)),
        cfg.max_colliders_per_body, jnp.add, jnp.float32(0))
    ref = _n(jout[3]).reshape(-1) + _n(av[:, 0] / jnp.maximum(av[:, 3], 1.0))
    got = hopper.owner_velocity(
        dict(new, vx=torch.as_tensor(_n(jout[3]).reshape(Nt, -1).copy())),
        torch.as_tensor(_n(jout[6]).transpose(1, 0, 2).copy()), ob,
        cfg.max_colliders_per_body, h=h, lin_damp=0.0, ang_damp=0.0)
    np.testing.assert_array_equal(ref, _n(got["vx"]).reshape(-1))


@pytest.fixture(scope="module")
def stepped(resting):
    """One ``tiled_step`` of both packages from the resting world."""
    jw, tw, cfg = resting
    jf, jd = jax.jit(lambda w: jt.tiled_step(w, cfg, interpret=True))(jw)
    tf, td = st.tiled_step(tw, _port_cfg(cfg))
    return jf, jd, tf, td


def test_tiled_step_matches_jax(stepped):
    jf, jd, tf, td = stepped
    _assert_bodies_close(jf, tf)
    for k in ("slot_overflow", "solve_overflow", "solve_dropped",
              "margin_dropped", "spec_dropped", "window_overflow",
              "large_overflow", "owner_overflow"):
        assert int(jd[k]) == int(td[k]), k
    assert int(td["owner_overflow"]) == 0
    np.testing.assert_array_equal(np.asarray(jd["touch_keys"]),
                                  td["touch_keys"].numpy())
    assert int((td["touch_keys"] >= 0).sum()) > 100, "few touches: vacuous"


def test_sibling_rows_stay_identical(resting):
    """Three frames in tile layout (``_rollout_core``, sleep on): every
    sibling row of a body holds the same state and sleep counter, bit for
    bit, at the end (the owner sums are the same on every row, and the
    wake signal is owner-maxed)."""
    _, tw, cfg = resting
    cfg = _port_cfg(dataclasses.replace(cfg, sleep_velocity=0.5,
                                        sleep_frames=2))
    state, consts, large, body_id, _ = tt._enter_tiles(tw, cfg)
    state, consts, *_ = tt._rollout_core(
        state, consts, large, body_id, tw.gravity, cfg=cfg, n_frames=3,
        fuse=True, plain=False, compound=True)
    ob = consts["obody"].reshape(-1)
    same = ob[1:] == ob[:-1]
    assert int(same.sum()) == 515
    for x in [state[k] for k in STATE_KEYS] + [consts["sleep"]]:
        x = x.reshape(-1)
        assert torch.equal(x[1:][same], x[:-1][same])
    assert int((consts["sleep"] > 0).sum()) > 100, "nothing slow: vacuous"


def _with_ccd(resting):
    """The resting world with every dynamic body a bullet and ``ccd`` on,
    in both packages."""
    jw, tw, cfg = resting
    arrays = tio.world_to_numpy(tw)
    dyn = arrays["bodies/inv_mass"] > 0
    arrays["bodies/flags"] = np.where(dyn, arrays["bodies/flags"]
                                      | BODY_BULLET, arrays["bodies/flags"])
    return (numpy_to_jax(arrays, jw), tio.world_from_numpy(arrays,
                                                           device="cpu"),
            dataclasses.replace(cfg, ccd=True))


@pytest.mark.parametrize("ccd", [False, True])
def test_tiled_rollout_matches_jax(resting, ccd):
    """Three frames kept in tile layout (K = 2: a scheduled re-sort), every
    counter equal, ``owner_overflow`` among them; with ``ccd`` every
    dynamic body a bullet (the owner minimum of the TOI factors). Both the
    fused frame (the compound frame's twin, the default) and ``fuse=False``
    (the per-substep loop) hold, and are bitwise equal."""
    jw, tw, cfg = _with_ccd(resting) if ccd else resting
    jf, jd = jax.jit(lambda w: jt.tiled_rollout(w, cfg, 3,
                                                interpret=True))(jw)
    runs = [st.tiled_rollout(tw, _port_cfg(cfg), 3, fuse=fuse)
            for fuse in (True, False)]
    for tf, td in runs:
        assert sorted(td) == sorted(COUNTERS)
        assert {k: int(jd[k]) for k in COUNTERS} == {
            k: int(td[k]) for k in COUNTERS}
        _assert_bodies_close(jf, tf)
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(runs[0][0].bodies, field),
                           getattr(runs[1][0].bodies, field)), field


@pytest.mark.parametrize("ccd", [False, True])
def test_run_tiled_frame_fuses_compound_rows(resting, ccd, monkeypatch):
    """``run_tiled_frame(compound=True)``: fused (the default), the substeps
    go to one ``tile_frame`` call with the owner column (the compound
    frame; its twin here), and every output is bitwise the per-substep
    loop's (``fuse=False``)."""
    jw, tw, cfg = _with_ccd(resting) if ccd else resting
    cfg = _port_cfg(cfg)
    state, consts, large, _, _ = tt._enter_tiles(tw, cfg)
    g = tw.gravity.contiguous()
    seen = []
    frame = ht.tile_frame

    def spy(*args, **kw):
        seen.append(kw)
        return frame(*args, **kw)

    monkeypatch.setattr(ht, "tile_frame", spy)
    fused = tt._run_frame(state, consts, large, cfg, g, compound=True)
    assert len(seen) == 1 and seen[0]["ccd"] == ccd
    ob, kc = seen[0]["owner"]
    assert torch.equal(ob, consts["obody"].reshape(-1))
    assert kc == cfg.max_colliders_per_body
    loop = tt._run_frame(state, consts, large, cfg, g, fuse=False,
                         compound=True)
    assert len(seen) == 1
    for k in STATE_KEYS:
        assert torch.equal(fused[0][k], loop[0][k]), k
    outs = [(x, y) for x, y in zip(fused[2], loop[2]) if x is not None]
    for x, y in outs:
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert float(fused[2][0].sum()) > 100, "few touching slots: vacuous"


def _gate_world(kind):
    """The JAX test's compound scene with one change, in both packages:
    ``compound_joint`` a joint, ``wide_body`` body 10 with 5 colliders (past
    the owner span 4), ``no_collider_body`` a moving body with none."""
    worlds = []
    for builder_cls, shape_cls, cap_cls, kw in (
            (JBuilder, JShape, JCapacity, {}),
            (st.WorldBuilder, st.Shape, st.Capacity, dict(device="cpu"))):
        b, cap = build_compound(builder_cls, shape_cls)
        if kind == "compound_joint":
            b.distance_joint(10, 11)
            cap["max_joints"] = 1
        elif kind == "wide_body":
            for k in range(3):
                b.add_collider(10, shape_cls.circle(0.1),
                               offset=(0.1 * k, 0.3))
            cap["max_colliders"] += 3
        else:
            b.add_body(pos=(0.0, 30.0), mass=1.0, inertia=0.1)
            cap["max_bodies"] += 1
        worlds.append(b.build(cap_cls(**cap), **kw)[0])
    return worlds


@pytest.mark.parametrize("kind", ["compound_joint", "wide_body",
                                  "no_collider_body"])
def test_compound_gates_match_jax(kind, monkeypatch):
    """``use_tiled`` keeps the same compound worlds off the tile engine as
    the JAX package (its gate asked as on a TPU), and ``owner_overflow``
    counts the same violations."""
    jw, tw = _gate_world(kind)
    jcfg = _cfg()
    jbase = _compound_scene()[0]
    tbase = _port(jbase)
    tpu = SimpleNamespace(platform="tpu", device_kind="TPU v5e")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [tpu])
    verdicts = (jt.use_tiled(jbase, jcfg), jt.use_tiled(jw, jcfg))
    monkeypatch.undo()
    assert verdicts == (True, False)
    assert st.use_tiled(tbase, _port_cfg(jcfg))
    assert not st.use_tiled(tw, _port_cfg(jcfg))
    if kind != "compound_joint":
        got = int(tt._owner_width_overflow(tw, _port_cfg(jcfg)))
        assert got == int(jt._owner_width_overflow(jw, jcfg)) > 0
    narrow = _cfg(max_colliders_per_body=1)
    assert not st.use_tiled(tw, _port_cfg(narrow))
    assert int(tt._owner_width_overflow(tw, _port_cfg(narrow))) == int(
        jt._owner_width_overflow(jw, narrow)) > 0
