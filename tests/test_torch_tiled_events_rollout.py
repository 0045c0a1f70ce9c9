"""``tiled_rollout(..., with_events=True)`` against the JAX package's
(``interpret=True``) on ``scenes.pile(n_bodies=1021, sleep=False)`` (4
tiles) 20 frames into a port rollout (2 substeps, K = 4), carried across as
numpy: each frame's contact-event keys (K6's, compacted with the solve
slots), and the rollout otherwise unchanged by asking for them.

Tolerances: keys, counters and host syncs equal; the state to the tile
engine's own tolerance against the XLA tier (poses 5e-4, velocities 3e-2,
tests/test_torch_tiled_rollout.py); with and without events bitwise equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import tiled as jt  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import events as tev  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch import tiled as tt  # noqa: E402

from _torch_parity import events_pile, jax_to_numpy  # noqa: E402

COUNTERS = ("slot_overflow", "solve_overflow", "solve_dropped",
            "margin_dropped", "spec_dropped", "window_overflow",
            "joint_shard_overflow", "forced_resorts", "forced_rebuilds",
            "compacted_rows", "large_overflow")


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def rollouts():
    """3 frames with events of both packages from the same world."""
    jw, tw, cfg = events_pile()
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jf, jd, jkeys = jax.jit(lambda w: jt.tiled_rollout(
        w, jcfg, 3, interpret=True, with_events=True))(jw)
    syncs = tt.host_syncs
    tf, td, tkeys = st.tiled_rollout(tw, cfg, 3, with_events=True)
    return dict(jf=jf, jd=jd, jkeys=jkeys, tf=tf, td=td, tkeys=tkeys,
                syncs=tt.host_syncs - syncs, tw=tw, cfg=cfg)


def test_rollout_event_keys_match_jax(rollouts):
    """The per-frame keys equal frame by frame, the state and counters as
    the rollout without events holds them, one host sync a frame."""
    r = rollouts
    assert tuple(r["tkeys"].shape) == (3, 4, 8, 256)
    assert r["tkeys"].dtype == torch.int32
    np.testing.assert_array_equal(_n(r["jkeys"]), _n(r["tkeys"]))
    assert int((r["tkeys"] >= 0).sum()) > 3 * 300, "few touches: vacuous"
    assert r["syncs"] == 3
    a, b = jax_to_numpy(r["jf"]), tio.world_to_numpy(r["tf"])
    for k in ("bodies/pos", "bodies/angle"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-4, err_msg=k)
    for k in ("bodies/vel", "bodies/ang_vel"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-2, err_msg=k)
    assert {k: int(r["jd"][k]) for k in COUNTERS} == {
        k: int(r["td"][k]) for k in COUNTERS}


def test_rollout_with_events_equals_rollout_without(rollouts):
    """Asking for events changes nothing else: the same state bit for bit
    and the same counters; each frame's keys are the touching slots'."""
    r = rollouts
    tf, td = st.tiled_rollout(r["tw"], r["cfg"], 3)
    for k in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(tf.bodies, k), getattr(r["tf"].bodies, k))
    assert {k: int(v) for k, v in td.items()} == {
        k: int(v) for k, v in r["td"].items()}
    started, ended = tev.key_event_masks(r["tkeys"][0], r["tkeys"][1])
    assert not bool((started & (r["tkeys"][1] < 0)).any())
    assert not bool((ended & (r["tkeys"][0] < 0)).any())
