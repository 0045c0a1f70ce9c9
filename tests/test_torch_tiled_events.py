"""Contact events on the port's tile engine, held against the JAX package:
``events.py``'s key functions, and K6's event keys (``with_keys``: the
plain twin against ``_manifold_kernel`` in interpret mode) on
``scenes.pile(n_bodies=1021, sleep=False)`` (4 tiles) 20 frames into a port
rollout (2 substeps, K = 4), carried across as numpy; and the int32 guard
on the keys. The rollout with events: tests/test_torch_tiled_events_rollout
.py.

Tolerances: masks, sets and keys equal.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import events as jev  # noqa: E402
from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import events as tev  # noqa: E402
from starframe_tpu_torch import hopper  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402
from starframe_tpu_torch.hopper import tiles as ht  # noqa: E402

from _torch_parity import events_pile, jax_tile_manifold  # noqa: E402

def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys(rng, shape, M, fill=0.5):
    """Seeded random key tables: canonical keys of random pairs, ``-1`` in
    about ``fill`` of the slots."""
    a = rng.integers(0, M, size=shape)
    b = rng.integers(0, M, size=shape)
    k = np.minimum(a, b) * M + np.maximum(a, b)
    return np.where(rng.random(shape) < fill, -1, k).astype(np.int32)


def test_event_functions_match_jax():
    """``key_event_masks`` and ``keys_to_set`` on two frames' key tables
    that share about half their pairs, and ``touching_keys_from_slots`` /
    ``slot_touch_set`` on a random slot table: equal to the JAX package's."""
    rng = np.random.default_rng(0)
    M = 300
    prev = _keys(rng, (4, 8, 256), M)
    cur = np.where(rng.random(prev.shape) < 0.5, prev,
                   _keys(rng, prev.shape, M))
    js, je = jev.key_event_masks(jnp.asarray(prev), jnp.asarray(cur))
    ts, te = tev.key_event_masks(torch.as_tensor(prev), torch.as_tensor(cur))
    np.testing.assert_array_equal(_n(js), _n(ts))
    np.testing.assert_array_equal(_n(je), _n(te))
    assert 0 < int(ts.sum()) < int((cur >= 0).sum()), "vacuous"
    assert jev.keys_to_set(cur, M) == tev.keys_to_set(torch.as_tensor(cur), M)
    touched = (rng.random((8, M)) < 0.3).astype(np.float32)
    partner = rng.integers(0, M, size=(8, M)).astype(np.int32)
    np.testing.assert_array_equal(
        _n(jev.touching_keys_from_slots(jnp.asarray(touched),
                                        jnp.asarray(partner), M)),
        _n(tev.touching_keys_from_slots(torch.as_tensor(touched),
                                        torch.as_tensor(partner), M)))
    assert jev.slot_touch_set(touched, partner, M) == tev.slot_touch_set(
        torch.as_tensor(touched), torch.as_tensor(partner), M)


def test_event_key_guard():
    """Keys ``min * M + max`` fit int32 up to M = 46340 colliders: the
    guard passes a tiny world's and that bound, and refuses one more (the
    JAX package's keys wrap silently there)."""
    world = st.scenes.pile(n_bodies=40, sleep=False, device="cpu").world
    ht.check_event_keys(world.colliders.m)
    ht.check_event_keys(46340)
    with pytest.raises(ValueError, match="overflow int32"):
        ht.check_event_keys(46341)


@pytest.fixture(scope="module")
def pile():
    """``pile(n_bodies=1021, sleep=False)`` 20 frames in."""
    return events_pile()


@functools.partial(jax.jit, static_argnames=("Cs", "n_colliders"))
def _jax_manifold(state, kc, large, pidx, act, tile_live, event_ids, *, Cs,
                  n_colliders):
    """``_manifold_kernel(with_keys=True)`` as ``run_tiled_frame`` calls it
    on the pile (C = 16, V = 6, interpret mode)."""
    return jax_tile_manifold(state, kc, large, pidx, act, tile_live, Cs=Cs,
                             V=6, margin=0.05, dt=1 / 60, sleep_velocity=0.0,
                             event_ids=event_ids, n_colliders=n_colliders)


@pytest.mark.parametrize("Cs", [8, 16])
def test_manifold_keys_twin_matches_jax(pile, Cs):
    """K6's twin with ``event_ids`` against ``_manifold_kernel(with_keys=
    True)`` on the same layout and tables, compacted (``Cs = 8 < C = 16``)
    and not (``Cs = C``: the raw key of every table slot): ``keyc`` equal,
    and the other outputs as without keys."""
    jw, tw, cfg = pile
    js, jc, jl, _, _ = jt._enter_tiles(jw, JConfig(**dataclasses.asdict(cfg)))
    ts, tc, tl, tbid, _ = tt._enter_tiles(tw, cfg)
    Nt = ts["px"].shape[0]
    el, eh, _ = tt._edge_rows(ts, tc, cfg)
    g = torch.tensor([0.0, -9.81])
    pidx, act = hopper.build_tile_tables(
        ts, tc, tl, el, eh, g, C=16, margin=cfg.contact_margin, dt=cfg.dt,
        sweep_frames=4, sweep_floor=cfg.tile_sweep_floor,
        sweep_cap=cfg.tile_sweep_cap)[:2]
    live = np.ones(Nt, np.float32)
    M = tw.colliders.m
    assert (cfg.contact_margin, cfg.dt) == (0.05, 1 / 60)
    jout = _jax_manifold(
        {k: js[k] for k in ("px", "py", "an", "vx", "vy", "om")}, jc, jl,
        jnp.asarray(_n(pidx)), jnp.asarray(_n(act)),
        jnp.broadcast_to(jnp.asarray(live)[:, None, None], (Nt, 1, 256)),
        (jnp.asarray(_n(tbid), jnp.float32).reshape(Nt, 1, 256),
         jnp.asarray(_n(tl["cols"]), jnp.float32)[None]), Cs=Cs,
        n_colliders=M)
    ids = (tbid.reshape(Nt, 256), tl["cols"])
    tout = hopper.tile_manifold(ts, tc, tl, pidx, act, torch.as_tensor(live),
                                Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt,
                                event_ids=ids, n_colliders=M)
    assert len(tout) == 8
    np.testing.assert_array_equal(_n(jout[8]), _n(tout[7]))
    plain = hopper.tile_manifold(ts, tc, tl, pidx, act, torch.as_tensor(live),
                                 Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt)
    for a, b in zip(plain, tout[:7]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_n(jout[2]), _n(tout[1]))
    keys = _n(tout[7])
    a, b = keys // M, keys % M
    real = _n(tout[0])[:, ht.SOL["act"]] > 0
    assert real.sum() > 1000, "few active slots: vacuous"
    assert ((a < b) & (b < M))[real].all()
    if Cs < 16:
        assert (keys[~real & (_n(tout[1]) == 0)] == 0).all()
