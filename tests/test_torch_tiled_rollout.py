"""The tile engine's main path end to end: the port's ``tiled_step`` and
``tiled_rollout`` (through the twins) against the JAX package's
(``interpret=True``) on the 4-tile scene of tests/test_tiles.py, 20 frames
into a port rollout and carried across as numpy; the gates of the branches
the port does not run yet (compound worlds and events now run: their
cases pin that); and the entry points' device default (the card, never a
quiet CPU fallback).

Tolerances: poses 5e-4 and velocities 3e-2 (the tile engine's own
tolerance against the XLA tier, tests/test_tiles.py); every counter equal;
the touching pair keys equal. The settling pile (tests/test_torch_tiles.py
holds its kernels) is not used here: its first frames resolve spawn
overlaps, where the JAX package's own tile and XLA tiers land 124 of 1024
bodies apart by more than these tolerances after two frames (the port and
the JAX tile engine: 3).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402
from starframe_tpu.tiled import tiled_rollout as j_rollout  # noqa: E402
from starframe_tpu.tiled import tiled_step as j_step  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402

from _torch_parity import build_tiled, jax_to_numpy, numpy_to_jax  # noqa: E402

COUNTERS = ("slot_overflow", "solve_overflow", "solve_dropped",
            "margin_dropped", "spec_dropped", "window_overflow",
            "joint_shard_overflow", "forced_resorts", "forced_rebuilds",
            "compacted_rows", "large_overflow")


@pytest.fixture(scope="module")
def start():
    """The scene of tests/test_tiles.py 20 frames in (4 tiles, 4 substeps,
    16 table and 8 solve slots, K = 4), both packages' worlds and the
    config."""
    jb, cap = build_tiled(JBuilder, JShape)
    jw, _ = jb.build(JCapacity(**cap))
    tb, _ = build_tiled(st.WorldBuilder, st.Shape)
    tw, _ = tb.build(st.Capacity(**cap), device="cpu")
    cfg = st.SolverConfig(substeps=4, slot_capacity=16, tile_solve_capacity=8,
                          broadphase="grid", grid_cell_capacity=10,
                          frames_per_broadphase=4)
    tw, _ = st.tiled_rollout(tw, cfg, 20)
    return numpy_to_jax(tio.world_to_numpy(tw), jw), tw, cfg


def _assert_bodies_close(jw, tw):
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k in ("bodies/pos", "bodies/angle", "bodies/prev_pos",
              "bodies/prev_angle"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
    for k in ("bodies/vel", "bodies/ang_vel"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-2, err_msg=k)
    for k in ("bodies/sleep_count", "step_count"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tiled_step_matches_jax(start):
    jw, tw, cfg = start
    jcfg = JConfig(**dataclasses.asdict(cfg))
    for _ in range(2):
        jw, jd = j_step(jw, jcfg, interpret=True)
        tw, td = st.tiled_step(tw, cfg)
    _assert_bodies_close(jw, tw)
    for k in ("slot_overflow", "solve_overflow", "solve_dropped",
              "margin_dropped", "spec_dropped", "window_overflow",
              "large_overflow"):
        assert int(jd[k]) == int(td[k]), k
    np.testing.assert_array_equal(np.asarray(jd["touch_keys"]),
                                  td["touch_keys"].numpy())
    assert int((td["touch_keys"] >= 0).sum()) > 100, "few touches: vacuous"
    np.testing.assert_allclose(float(jd["max_penetration"]),
                               float(td["max_penetration"]), atol=1e-4)


def test_tiled_rollout_matches_jax(start):
    """Three frames kept in tile layout, K = 4: the initial build, guarded
    frames, and the same counters."""
    jw, tw, cfg = start
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jf, jd = jax.jit(lambda w: j_rollout(w, jcfg, 3, interpret=True))(jw)
    syncs = tt.host_syncs
    tf, td = st.tiled_rollout(tw, cfg, 3)
    assert tt.host_syncs - syncs == 3  # one guard read per frame (K > 1)
    _assert_bodies_close(jf, tf)
    assert sorted(td) == sorted(COUNTERS)
    assert {k: int(jd[k]) for k in COUNTERS} == {
        k: int(td[k]) for k in COUNTERS}
    assert int(td["slot_overflow"]) == int(td["solve_overflow"]) == 0


def test_tiled_rollout_k1_resorts_every_frame_without_syncs(start):
    """K = 1: tables and sort every frame, no guard to read."""
    _, tw, cfg = start
    cfg = dataclasses.replace(cfg, frames_per_broadphase=1)
    syncs = tt.host_syncs
    _, d = st.tiled_rollout(tw, cfg, 2)
    assert tt.host_syncs == syncs
    assert int(d["forced_rebuilds"]) == int(d["forced_resorts"]) == 0


def _tiled_world(joint=False, compound=False):
    b, cap = build_tiled(st.WorldBuilder, st.Shape)
    if joint:
        b.distance_joint(10, 11)
        cap = dict(cap, max_joints=1)
    if compound:
        b.add_collider(10, st.Shape.circle(0.2), offset=(0.3, 0.0))
        cap = dict(cap, max_colliders=cap["max_colliders"] + 1)
    return b.build(st.Capacity(**cap), device="cpu")[0]


GATES = {
    "joints": (lambda: _tiled_world(joint=True), {}, {}),
    "sharded": (lambda: _tiled_world(), {}, dict(shard_axis="tiles")),
}


def _compound_joint_kept_off():
    """A compound world with a joint stays off the tile engine, as in the
    JAX package (its joint pass addresses bodies by row); run there
    anyway, its joints raise."""
    world = _tiled_world(joint=True, compound=True)
    assert not st.use_tiled(world, st.SolverConfig())
    assert st.use_tiled(_tiled_world(compound=True), st.SolverConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4.5"):
        st.tiled_rollout(world, st.SolverConfig(), 1)


def _events_return_keys():
    """``with_events`` no longer raises: the rollout returns a key table a
    frame, beside the counters."""
    world = _tiled_world()
    cfg = st.SolverConfig(substeps=2)
    final, diag, keys = st.tiled_rollout(world, cfg, 1, with_events=True)
    assert keys.shape == (1, 4, 8, 256) and keys.dtype == torch.int32
    assert int(final.step_count) == int(world.step_count) + 1
    assert int(diag["slot_overflow"]) == 0


def _ccd_runs():
    """``cfg.ccd`` no longer raises: the tile engine takes the world
    (tests/test_torch_tiled_ccd.py holds it against the JAX package)."""
    world = _tiled_world()
    cfg = st.SolverConfig(substeps=2, ccd=True)
    assert st.use_tiled(world, cfg)
    final, diag = st.tiled_rollout(world, cfg, 1)
    assert int(final.step_count) == int(world.step_count) + 1
    assert int(diag["slot_overflow"]) == 0


PORTED = {"ccd": _ccd_runs, "compound": _compound_joint_kept_off,
          "events": _events_return_keys}


@pytest.mark.parametrize("branch", sorted(GATES) + sorted(PORTED))
def test_unported_branches_raise(branch):
    if branch in PORTED:
        PORTED[branch]()
        return
    make, cfg_kw, gate_kw = GATES[branch]
    world, cfg = make(), st.SolverConfig(**cfg_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        st.use_tiled(world, cfg, **gate_kw)
    if not gate_kw:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
            st.tiled_rollout(world, cfg, 1)
        with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
            st.tiled_step(world, cfg)


def test_use_tiled_keeps_other_worlds_off_the_tile_engine():
    world = _tiled_world()
    assert st.use_tiled(world, st.SolverConfig())
    for kw in (dict(use_pallas=False), dict(iterations=2),
               dict(manifold_refresh="substep")):
        assert not st.use_tiled(world, st.SolverConfig(**kw))
    small = st.scenes.pile(n_bodies=500, sleep=False, device="cpu")
    assert not st.use_tiled(small.world, small.config)


ENTRY_POINTS = {
    "pile": lambda: st.scenes.pile(n_bodies=40, sleep=False).world,
    "batched_worlds": lambda: st.scenes.batched_worlds(
        n_worlds=1, n_bodies=256, substeps=2).world,
    "mechanism": lambda: st.scenes.mechanism().world,
    "rope_bridge": lambda: st.scenes.rope_bridge().world,
    "builder": lambda: build_tiled(st.WorldBuilder, st.Shape, n=64)[0].build(
        st.Capacity(max_bodies=64, max_colliders=64, max_pairs=512,
                    max_joints=0, max_verts=6))[0],
    "empty_world": lambda: st.state.empty_world(st.Capacity()),
    "world_from_numpy": lambda: tio.world_from_numpy(tio.world_to_numpy(
        st.state.empty_world(st.Capacity(), device="cpu"))),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS) + ["load_npz"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """Without ``device``, a world is built on the card; without a card
    that default raises (there is no quiet CPU fallback)."""
    if name == "load_npz":
        w = st.state.empty_world(st.Capacity(), device="cpu")
        np.savez(tmp_path / "w.npz", **tio.world_to_numpy(w))

        def make():
            return tio.load_npz(str(tmp_path / "w.npz"))
    else:
        make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().bodies.pos.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
