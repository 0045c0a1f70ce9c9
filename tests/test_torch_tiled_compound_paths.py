"""Compound bodies on the sleeping and the event paths of the port's tile
engine, held against the JAX package (``interpret=True``) on the compound
scene of tests/test_tiled_compound.py 20 frames in
(tests/test_torch_tiled_compound.py): with every dynamic body left of x = 0
put to sleep, a 2-frame rollout with awake-prefix compaction and the keep
set widened to whole bodies; and a 2-frame rollout with events, whose keys
name collider pairs (a pair of bodies may touch through two).

Tolerances: counters, sleep counters, keys, keep flags and the partition
equal; poses 1e-4 and velocities 3e-2 (the tile engine's own tolerance
against the XLA tier, tests/test_tiled_compound.py).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import tiled as jt  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402

from _torch_parity import compound_resting  # noqa: E402
from test_sleep_tiers import _presleep  # noqa: E402
from test_torch_tiled_compound import (  # noqa: E402
    COUNTERS,
    _assert_bodies_close,
    _n,
    _port,
    _port_cfg,
)


@pytest.fixture(scope="module")
def resting():
    """The compound scene 20 frames in: ``(JAX world, port world, JAX
    config)``."""
    return compound_resting()


@pytest.fixture(scope="module")
def half_asleep(resting):
    """The resting compound world with every dynamic body left of x = 0
    asleep (counter run out, at rest), sleep on, K = 2: ``(world, cfg)`` in
    the JAX package."""
    jw, _, cfg = resting
    x = np.asarray(jw.bodies.pos)[:, 0]
    dyn = np.asarray(jw.bodies.inv_mass) > 0
    cfg = dataclasses.replace(cfg, sleep_velocity=0.05, sleep_frames=10)
    return _presleep(jw, np.flatnonzero(dyn & (x < 0)), 10), cfg


def test_compacted_rollout_with_sleepers_matches_jax(half_asleep):
    """Two frames with awake-prefix compaction (the second re-sorts into
    the partition): counters (``compacted_rows`` among them) and sleep
    counters equal, the poses and velocities to the tolerances."""
    jw, cfg = half_asleep
    jf, jd = jax.jit(lambda w: jt.tiled_rollout(w, cfg, 2,
                                                interpret=True))(jw)
    tf, td = st.tiled_rollout(_port(jw), _port_cfg(cfg), 2)
    assert {k: int(jd[k]) for k in COUNTERS} == {
        k: int(td[k]) for k in COUNTERS}
    assert int(td["compacted_rows"]) > 0, "nothing compacted: vacuous"
    _assert_bodies_close(jf, tf)


def test_keep_set_is_per_body_like_jax(half_asleep):
    """``_partition_perm`` with the owners (``ob_x``) on the sorted layout:
    the keep flags and the permutation equal to the JAX package's, and no
    body split between the kept prefix and the sleeping tail."""
    jw, cfg = half_asleep
    tcfg = _port_cfg(cfg)
    js, jc, _, _, _ = jt._enter_tiles(jw, cfg)
    ts, tc, _, _, _ = tt._enter_tiles(_port(jw), tcfg)
    Nt, kc = ts["px"].shape[0], cfg.max_colliders_per_body
    jboxes, jmova, jawake = jt._keep_boxes(js, jc, cfg,
                                           jnp.asarray([0.0, -9.81]))
    tboxes, tmova, tawake = tt._keep_boxes(ts, tc, tcfg,
                                           torch.tensor([0.0, -9.81]))
    tkey = tt._sort_key(tc["act"].reshape(-1), tc["mov"].reshape(-1),
                        ts["px"].reshape(-1))
    tperm = torch.argsort(tkey, stable=True)
    jperm = jnp.asarray(_n(tperm))
    jkey = jnp.asarray(_n(tkey))
    ob_t = tc["obody"].reshape(-1)[tperm]
    jp, jkept = jt._partition_perm(
        jkey[jperm], tuple(b[jperm] for b in jboxes), jmova[jperm],
        jawake[jperm], Nt, 256, ob_x=jnp.asarray(_n(ob_t)), kc=kc)
    tp, tkept = tt._partition_perm(
        tkey[tperm], tuple(b[tperm] for b in tboxes), tmova[tperm],
        tawake[tperm], Nt, ob_x=ob_t, kc=kc)
    np.testing.assert_array_equal(_n(jkept), _n(tkept))
    np.testing.assert_array_equal(_n(jp), _n(tp))
    mova = tmova[tperm]
    assert 0 < int((tkept & mova).sum()) < int(mova.sum()), "vacuous"
    same = ob_t[1:] == ob_t[:-1]
    assert torch.equal(tkept[1:][same], tkept[:-1][same])


def test_compound_rollout_with_events_matches_jax(resting):
    """Events on a compound world: each frame's keys equal the JAX
    package's, and a key's colliders belong to two different bodies."""
    jw, tw, cfg = resting
    jf, jd, jkeys = jax.jit(lambda w: jt.tiled_rollout(
        w, cfg, 2, interpret=True, with_events=True))(jw)
    tf, td, tkeys = st.tiled_rollout(tw, _port_cfg(cfg), 2, with_events=True)
    np.testing.assert_array_equal(_n(jkeys), _n(tkeys))
    assert {k: int(jd[k]) for k in COUNTERS} == {
        k: int(td[k]) for k in COUNTERS}
    _assert_bodies_close(jf, tf)
    M = tw.colliders.m
    k = tkeys[tkeys >= 0].long()
    assert k.numel() > 100, "few touches: vacuous"
    owner = tw.colliders.body_idx.long()
    assert bool((owner[k // M] != owner[k % M]).all())
