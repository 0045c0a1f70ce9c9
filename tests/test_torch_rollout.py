"""The port's ``batched_rollout`` (through the twins) against the JAX
package's ``batched_rollout(..., interpret=True)``: the same 2-world,
256-body batch (carried across as numpy, advanced into contact first) for
6 frames, with broadphase reuse (K = 4: guard, partner-aware tables) and
without (K = 1). Positions to 2e-3 (tests/test_frame2.py:344); every
counter equal. With K = 4, four slots per row and a sweep headroom below 1
make rows drop speculative candidates and the staleness guard force
rebuilds, so the counters are compared where they are not zero."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import starframe_tpu as sf  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import io as tio, parallel  # noqa: E402

from _torch_parity import numpy_to_jax  # noqa: E402

N_FRAMES = 6


@pytest.fixture(scope="module")
def start():
    """A batch 12 frames in (bottom rows on the ground), as numpy arrays,
    with its JAX-side template and config."""
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=2,
                                  seed=1, device="cpu")
    w, _, _ = parallel.batched_rollout(sc.world, sc.config, 0, 12,
                                       record=lambda _: None)
    like = sf.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=2)
    return tio.world_to_numpy(w), like.world, sc.config


@pytest.mark.parametrize("K", [4, 1])
def test_rollout_matches_jax(start, K):
    arrays, like, cfg = start
    cfg = dataclasses.replace(cfg, frames_per_broadphase=K, slot_capacity=4,
                              broadphase_budget_headroom=0.6)
    jcfg = sf.SolverConfig(**dataclasses.asdict(cfg))
    jf, jtraj, jd = sf.parallel.batched_rollout(
        numpy_to_jax(arrays, like), jcfg, 0, N_FRAMES, interpret=True)
    tf, ttraj, td = st.batched_rollout(
        tio.world_from_numpy(arrays, "cpu"), cfg, 0, N_FRAMES)

    assert sorted(jd) == sorted(td)  # one key set on the kernel path
    counters = {k: int(v) for k, v in td.items()}
    assert {k: int(v) for k, v in jd.items()} == counters
    if K > 1:
        assert counters["spec_dropped"] > 0 and counters["forced_rebuilds"] > 0
    else:
        assert counters["forced_rebuilds"] == 0
    np.testing.assert_allclose(np.asarray(jf.bodies.pos),
                               tf.bodies.pos.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(jtraj[0]), ttraj[0].numpy(),
                               rtol=0, atol=2e-3)
    assert int(tf.step_count[0]) == int(np.asarray(jf.step_count)[0])
    # the batch is in contact: bodies rest on the ground instead of falling
    y = tf.bodies.pos[..., 1]
    dyn = tf.bodies.inv_mass > 0
    assert float(y[dyn].min()) > 0.3


def test_batched_step_matches_one_frame_rollout(start):
    arrays, _, cfg = start
    cfg = dataclasses.replace(cfg, frames_per_broadphase=1)
    w0 = tio.world_from_numpy(arrays, "cpu")
    a, diag = st.batched_step(w0, cfg, 0, with_diag=True)
    b, _, d2 = st.make_batched_rollout(cfg, 0, 1, record=lambda _: None)(w0)
    assert torch.equal(a.bodies.pos, b.bodies.pos)
    assert sorted(diag) == sorted(d2)
    assert {k: int(v) for k, v in diag.items()} == {
        k: int(v) for k, v in d2.items()}
