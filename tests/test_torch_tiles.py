"""The port's tile-engine kernels against the JAX package: the pile scene,
the tile layout, and the plain twins of the tile tables (K5), the frame
manifolds (K6) and the per-substep project/apply pair (K8/K9), each held
against ``pallas/tiles.py`` in interpret mode on the same 4-tile world,
carried across as numpy. The world is the 1024-collider scene of
tests/test_tiles.py and ``scenes.pile(n_bodies=1021, sleep=False)``, each
30 frames into a port rollout (bodies on the ground and on each other),
with 16 table slots and 8 solve slots, so the solve slots are compacted.

Tolerances: the pile's arrays and config, the layout, the large set and
every integer output (partner slots, counts, window flags, compacted
slots, their sources and active counts) are equal; the sweep budget to
1e-6; the manifold's masks and pair constants equal, its normals,
anchors and separations to 1e-4 (float32 conditioning, not the port: an
anchor is a world point minus a body position, 1 ulp of a 190 m coordinate
is 1.5e-5, and a normal divides such differences by gaps of a few cm; the
two packages round them at different places); one frame's poses to 5e-4
and velocities to 3e-2, the
tile engine's own tolerance against the XLA tier (tests/test_tiles.py),
and ``touched`` equal.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402
from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.pallas import tiles as jpt  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402
from starframe_tpu_torch.hopper import tiles as ht  # noqa: E402

from _torch_parity import (  # noqa: E402
    build_tiled,
    jax_tile_manifold,
    jax_to_numpy,
    numpy_to_jax,
    sol_from_jax,
)

CFG = dict(substeps=4, iterations=1, manifold_refresh="frame",
           slot_capacity=16, tile_solve_capacity=8, broadphase="grid",
           grid_cell_capacity=10, frames_per_broadphase=4)
STATE = ("px", "py", "an", "vx", "vy", "om")


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=["scene", "pile"])
def worlds(request):
    """A 4-tile world 30 frames in (bottom rows landed, bodies on each
    other), in both packages, and its config: the scene of
    tests/test_tiles.py or ``scenes.pile(n_bodies=1021, sleep=False)`` at 4
    substeps and K = 4, both built by either package's builder."""
    if request.param == "scene":
        jb, cap = build_tiled(JBuilder, JShape)
        jw, _ = jb.build(JCapacity(**cap))
        tb, _ = build_tiled(st.WorldBuilder, st.Shape)
        tw, _ = tb.build(st.Capacity(**cap), device="cpu")
        cfg = st.SolverConfig(**CFG)
    else:
        jw = sf.scenes.pile(n_bodies=1021, sleep=False).world
        ts = st.scenes.pile(n_bodies=1021, sleep=False, device="cpu")
        tw = ts.world
        cfg = dataclasses.replace(ts.config, substeps=4,
                                  frames_per_broadphase=4)
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tw, _ = st.tiled_rollout(tw, cfg, 30)
    return numpy_to_jax(tio.world_to_numpy(tw), jw), tw, cfg


@pytest.fixture(scope="module")
def layouts(worlds):
    """Both packages' tile layouts of the same world, with their edges."""
    jw, tw, cfg = worlds
    jcfg = JConfig(**dataclasses.asdict(cfg))
    js, jc, jl, jbid, jlo = jt._enter_tiles(jw, jcfg)
    jel, jeh, jstale = jt._edge_rows(js, jc, jcfg)
    ts, tc, tl, tbid, tlo = tt._enter_tiles(tw, cfg)
    tel, teh, tstale = tt._edge_rows(ts, tc, cfg)
    return (dict(state=js, consts=jc, large=jl, body_id=jbid, lovf=jlo,
                 edges=(jel, jeh), stale=jstale, cfg=jcfg),
            dict(state=ts, consts=tc, large=tl, body_id=tbid, lovf=tlo,
                 edges=(tel, teh), stale=tstale, cfg=cfg))


def test_pile_scene_matches_jax():
    """``scenes.pile`` draws the same bodies from the same seed, and the
    builder sizes the same capacities and grid fan-out."""
    js = sf.scenes.pile(n_bodies=1021, sleep=False)
    ts = st.scenes.pile(n_bodies=1021, sleep=False, device="cpu")
    a, b = jax_to_numpy(js.world), tio.world_to_numpy(ts.world)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert dataclasses.asdict(js.capacity) == dataclasses.asdict(ts.capacity)
    assert ts.capacity.max_verts == 6
    assert dataclasses.asdict(js.config) == dataclasses.asdict(ts.config)
    assert ts.config.sleep_velocity == 0.0
    jb, _ = build_tiled(JBuilder, JShape)
    tb, _ = build_tiled(st.WorldBuilder, st.Shape)
    for x, y in zip(jb._collider_extents(), tb._collider_extents()):
        np.testing.assert_array_equal(x, y)
    assert jb.suggest_grid_cell_capacity() == tb.suggest_grid_cell_capacity()


def test_enter_tiles_matches_jax(layouts):
    j, t = layouts
    Nt = t["state"]["px"].shape[0]
    assert Nt == 4
    for k in STATE:
        np.testing.assert_array_equal(_n(j["state"][k]).reshape(Nt, -1),
                                      _n(t["state"][k]), err_msg=k)
    for k, v in t["consts"].items():
        np.testing.assert_array_equal(_n(j["consts"][k]).reshape(v.shape),
                                      _n(v), err_msg=k)
    for k, v in t["large"].items():
        np.testing.assert_array_equal(_n(j["large"][k]).reshape(v.shape),
                                      _n(v), err_msg=f"large {k}")
    np.testing.assert_array_equal(_n(j["body_id"]), _n(t["body_id"]))
    assert int(j["lovf"]) == int(t["lovf"]) == 0
    for x, y in zip(j["edges"], t["edges"]):
        np.testing.assert_array_equal(_n(x)[:, 0, 0], _n(y))
    assert bool(j["stale"]) == bool(t["stale"])


def _jax_tables(j, K):
    cfg = j["cfg"]
    kc = dict(j["consts"], edge_lo=j["edges"][0], edge_hi=j["edges"][1])
    return jpt.build_tile_tables(
        {k: j["state"][k] for k in STATE}, kc, j["large"],
        jnp.asarray([[0.0, -9.81]], jnp.float32), C=16, V=6,
        margin=cfg.contact_margin, dt=cfg.dt, sweep_frames=K,
        sweep_slack=cfg.broadphase_speed_slack,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap,
        interpret=True)


def _port_tables(t, K):
    cfg = t["cfg"]
    return hopper.build_tile_tables(
        t["state"], t["consts"], t["large"], *t["edges"],
        torch.tensor([0.0, -9.81]), C=16, margin=cfg.contact_margin,
        dt=cfg.dt, sweep_frames=K, sweep_slack=cfg.broadphase_speed_slack,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)


@pytest.mark.parametrize("K", [1, 4])
def test_tile_tables_twin_matches_jax(layouts, K):
    j, t = layouts
    jout = _jax_tables(j, K)
    tout = _port_tables(t, K)
    names = ("pidx", "act", "count", "count_touch", "count_close", "winover")
    for name, a, b in zip(names, jout[:6], tout[:6]):
        np.testing.assert_array_equal(_n(a).reshape(b.shape), _n(b),
                                      err_msg=name)
    np.testing.assert_allclose(_n(jout[6]).reshape(tout[6].shape),
                               _n(tout[6]), rtol=0, atol=1e-6)
    assert int(tout[3].sum()) > 100, "few touching candidates: vacuous"
    if K > 1:  # K-frame sweeps fill more than half the slots
        assert int((tout[2] > 8).sum()) > 0, "no row past 8 slots: vacuous"


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_tile_tables_refuse_under_three_tiles(layouts, n_tiles):
    """A tile's window is three tiles, and the JAX package's tile layout
    refuses fewer: so do the port's tables, before the kernel or its twin
    would read past the last row."""
    _, t = layouts
    cut = {k: {n: v[:n_tiles] for n, v in t[k].items()}
           for k in ("state", "consts")}
    cfg = t["cfg"]
    with pytest.raises(ValueError, match="3 tiles"):
        hopper.build_tile_tables(
            cut["state"], cut["consts"], t["large"],
            *(e[:n_tiles] for e in t["edges"]), torch.tensor([0.0, -9.81]),
            C=16, margin=cfg.contact_margin, dt=cfg.dt)


@functools.partial(jax.jit, static_argnames=("sleep_velocity",))
def _jax_manifold(state, kc, large, pidx, act, tile_live, sleep_velocity):
    """``pallas/tiles.py``'s manifold kernel as ``run_tiled_frame`` calls
    it (C = 16, Cs = 8, interpret mode)."""
    return jax_tile_manifold(state, kc, large, pidx, act, tile_live, Cs=8,
                             V=6, margin=0.05, dt=1 / 60,
                             sleep_velocity=sleep_velocity)


@pytest.mark.parametrize("case", ["awake", "waking_dead_tile"])
def test_tile_manifold_twin_matches_jax(layouts, case):
    """``awake``: every tile live, no wake signal (the pile's path);
    ``waking_dead_tile``: a wake speed, and tile 1 skipped."""
    j, t = layouts
    jtab = _jax_tables(j, 4)
    sv = 0.0 if case == "awake" else 0.2
    live = np.ones(4, np.float32)
    if case != "awake":
        live[1] = 0.0
    kc = dict(j["consts"], edge_lo=j["edges"][0], edge_hi=j["edges"][1])
    jout = _jax_manifold(
        {k: j["state"][k] for k in STATE}, kc, j["large"], jtab[0], jtab[1],
        jnp.broadcast_to(jnp.asarray(live)[:, None, None], (4, 1, 256)), sv)
    sol, pidx_c, src, nact, wake, pen, npts = hopper.tile_manifold(
        t["state"], t["consts"], t["large"], _t(jtab[0]), _t(jtab[1]),
        torch.as_tensor(live), Cs=8, margin=0.05, dt=1 / 60,
        sleep_velocity=sv)
    jsol = sol_from_jax(jout[0], jout[1], 8)
    np.testing.assert_array_equal(_n(jout[2]), _n(pidx_c))
    np.testing.assert_array_equal(_n(jout[3]), _n(src))
    np.testing.assert_array_equal(_n(jout[4]), _n(nact))
    exact = [ht.SOL[k] for k in ("act", "fric", "rest", "imb", "iib",
                                 "pdyn", "sm0", "sm1", "pm0", "pm1")]
    geom = [f for f in range(ht.SOL_FIELDS) if f not in exact]
    np.testing.assert_array_equal(jsol[:, exact], _n(sol)[:, exact])
    np.testing.assert_allclose(jsol[:, geom], _n(sol)[:, geom], rtol=0,
                               atol=1e-4)
    for name, a, b in (("wake", jout[5], wake), ("pen", jout[6], pen),
                       ("npts", jout[7], npts)):
        np.testing.assert_allclose(_n(a)[:, 0], _n(b), rtol=0, atol=1e-5,
                                   err_msg=name)
    n_act = _n(nact)[:, 0]
    # the solve slots hold the active manifolds closest first, not in
    # table order
    assert (_n(src) != np.arange(8)[None, :, None])[
        (_n(sol)[:, ht.SOL["pm0"]] > 0)].any(), "compaction kept table order"
    if case == "awake":
        assert not _n(wake).any()
    else:
        assert _n(wake).sum() > 0, "nothing woke: vacuous"
        assert not _n(sol)[1].any() and not n_act[1].any()


def test_tile_frame_twin_matches_jax(layouts):
    """One frame (4 substeps) of the project/apply twins on the K = 4
    tables: the JAX ``run_tiled_frame(fuse=False, interpret=True)``."""
    j, t = layouts
    cfg = t["cfg"]
    jtab = _jax_tables(j, 4)
    h = cfg.dt / cfg.substeps
    kw = dict(C=16, Cs=8, substeps=cfg.substeps, h=h, dt=cfg.dt,
              margin=cfg.contact_margin, compliance=cfg.contact_compliance,
              relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
              rest_threshold=cfg.restitution_threshold,
              lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    kc = dict(j["consts"], edge_lo=j["edges"][0], edge_hi=j["edges"][1],
              tile_live=jnp.ones((4, 1, 256), jnp.float32))
    jout = jpt.run_tiled_frame(
        {k: j["state"][k] for k in STATE}, kc, j["large"],
        jnp.asarray([[0.0, -9.81]], jnp.float32), jtab[:2], V=6, fuse=False,
        interpret=True, **kw)
    tkc = dict(t["consts"], edge_lo=t["edges"][0], edge_hi=t["edges"][1],
               tile_live=torch.ones(4))
    tout = hopper.run_tiled_frame(
        t["state"], tkc, t["large"], torch.tensor([0.0, -9.81]),
        (_t(jtab[0]), _t(jtab[1])), **kw)
    for k in STATE:
        atol = 5e-4 if k in ("px", "py", "an") else 3e-2
        np.testing.assert_allclose(_n(jout[0][k]).reshape(4, -1),
                                   _n(tout[0][k]), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(_n(jout[1]), _n(tout[1]))  # touched
    assert _n(tout[1]).sum() > 100, "few touching slots: vacuous"
    # the frame's integer outputs: compacted slots, sources, active counts
    for a, b in zip(jout[7:], tout[7:]):
        if _n(b).dtype.kind == "i":
            np.testing.assert_array_equal(_n(a).reshape(b.shape), _n(b))
