"""Contact-pair keys of the batched path: the port's
``parallel.batched_step_events`` and ``batched_rollout(with_keys=True)``
against the JAX package's (tests/test_events_batched.py:105-190), without
and with solve-slot compaction (Cs = 4 of C = 8), at K = 1 and K = 3.

The scene is test_frame2.py's ``_scene`` (seed 21) through both builders,
two worlds, 22 frames into the port's twin so that bodies touch. Keys of
one frame from the same state and slot tables equal the reference's
exactly; a rollout's keys equal the port's step-by-step keys at K = 1
exactly and, at K = 3 (the tables carry a wider candidate set, so slots
order differently), as pair sets, as the reference's own test holds them.
The reference's rollout is held the same way at K = 3 with compaction.
With compaction the reference runs through a copy of its frame module
with one call repaired (``_torch_parity.repaired_reference``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from starframe_tpu import parallel as jpar  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch.events import keys_to_set  # noqa: E402

from _torch_parity import (  # noqa: E402
    build,
    build_pile,
    numpy_to_jax,
    repaired_reference,
    to_jax_tables,
)

CAP = dict(max_bodies=128, max_colliders=128, max_pairs=1024, max_joints=0,
           max_verts=4)
M, FRAMES = 128, 3
CFG = dict(substeps=4, slot_capacity=8)


@pytest.fixture(scope="module")
def start():
    """The 2-world batch 22 frames in: ``(JAX world, port world)``."""
    jw, _ = build(build_pile(JBuilder, JShape, seed=21), JCapacity(**CAP))
    tw, _ = build(build_pile(st.WorldBuilder, st.Shape, seed=21),
                  st.Capacity(**CAP))
    tw, _, _ = parallel.batched_rollout(parallel.replicate_world(tw, 2),
                                        st.SolverConfig(**CFG), 0, 22,
                                        record=lambda _: None)
    return numpy_to_jax(tio.world_to_numpy(tw), jpar.replicate_world(jw, 2)), tw


@pytest.fixture(scope="module")
def step_keys(start):
    """Per Cs in (0, 4): ``FRAMES`` frames of ``batched_step_events`` in
    each package from the same state and the port's tables: ``(JAX keys,
    port keys, JAX diag, port diag)`` a frame."""
    out = {}
    with repaired_reference():
        for Cs in (0, 4):
            cfg = st.SolverConfig(**CFG, batch_solve_capacity=Cs)
            jcfg = JConfig(**CFG, batch_solve_capacity=Cs)
            jw, tw = start
            frames = []
            for _ in range(FRAMES):
                tables = parallel.frame2_tables(tw, cfg)
                jw, jk, jd = jpar.batched_step_events(
                    jw, jcfg, interpret=True, tables=to_jax_tables(tables))
                tw, tk, td = parallel.batched_step_events(tw, cfg,
                                                          tables=tables)
                frames.append((np.asarray(jk), tk, jd, td))
            out[Cs] = frames
    return out


@pytest.mark.parametrize("Cs", [0, 4])
def test_step_keys_match_jax(step_keys, Cs):
    for f, (jk, tk, jd, td) in enumerate(step_keys[Cs]):
        assert tk.shape == (2, Cs or 8, M) and tk.dtype == torch.int32
        np.testing.assert_array_equal(jk, tk.numpy(), err_msg=f"frame {f}")
        assert (tk >= 0).sum() > 10, "no touching pair: vacuous"
        assert {k: int(jd[k]) for k in jd} == {k: int(td[k]) for k in jd}


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("Cs", [0, 4])
def test_rollout_keys_match_step_keys(start, step_keys, Cs, K):
    """``batched_rollout(with_keys=True)`` gives ``(record, keys)`` a frame:
    at K = 1 the keys of the step-by-step run (and so the reference's)
    exactly, at K = 3 the same pair sets; the record and the final state
    as without keys."""
    _, tw = start
    cfg = st.SolverConfig(**CFG, batch_solve_capacity=Cs,
                          frames_per_broadphase=K)
    final, (poses, keys), diag = parallel.batched_rollout(
        tw, cfg, 0, FRAMES, record=lambda w: w.bodies.pos, with_keys=True)
    plain, traj, _ = parallel.batched_rollout(
        tw, cfg, 0, FRAMES, record=lambda w: w.bodies.pos)
    assert torch.equal(final.bodies.pos, plain.bodies.pos)
    assert torch.equal(poses, traj)
    assert keys.shape == (FRAMES, 2, Cs or 8, M)
    for f, (jk, tk, _, _) in enumerate(step_keys[Cs]):
        if K == 1:
            assert torch.equal(keys[f], tk)
        for w in range(2):
            assert keys_to_set(keys[f, w], M) == keys_to_set(jk[w], M)


def test_jax_rollout_keys_match(start):
    """The reference's ``batched_rollout(with_keys=True)`` at K = 3 with
    compaction against the port's: the same pair sets each frame."""
    jw, tw = start
    kw = dict(CFG, batch_solve_capacity=4, frames_per_broadphase=3)
    with repaired_reference():
        _, (_, jkeys), jdiag = jpar.batched_rollout(
            jw, JConfig(**kw), 0, FRAMES, record=lambda w: None,
            interpret=True, with_keys=True)
    _, (_, keys), diag = parallel.batched_rollout(
        tw, st.SolverConfig(**kw), 0, FRAMES, record=lambda w: None,
        with_keys=True)
    for f in range(FRAMES):
        for w in range(2):
            assert keys_to_set(keys[f, w], M) == keys_to_set(
                np.asarray(jkeys[f, w]), M), (f, w)
    for k in ("slot_overflow", "solve_overflow", "owner_overflow"):
        assert int(jdiag[k]) == int(diag[k]) == 0, k


def test_keys_with_sleep_cover_touching_rows(start):
    """With sleep on, keys still come from ``touched`` and the compacted
    partner table (``partner_solve``), one key a touching slot."""
    _, tw = start
    cfg = dataclasses.replace(st.SolverConfig(**CFG), sleep_velocity=0.1,
                              batch_solve_capacity=4)
    w2, keys, diag = parallel.batched_step_events(tw, cfg)
    assert keys.shape == (2, 4, M)
    k = keys[keys >= 0]
    assert bool(((k // M) < (k % M)).all())
