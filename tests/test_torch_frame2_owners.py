"""Per-world collider-owner tables on the batched path
(``cfg.batch_uniform_topology=False``, K4's per-world form): the port's
``collider_owner_tables`` against the JAX package's, and the frame twin
with them against ``parallel.frame2_step(..., interpret=True)``.

Scenes are tests/test_frame2.py's: the iota pile ``_scene`` and the
compound scene ``_compound_scene`` (every 4th dynamic body owns 3
colliders), built by both builders. The owner tables and
``owner_overflow`` equal; over 3 frames of the heterogeneous batch (one
world of each, from frame 13, when both piles touch the ground) ``touched``
equal in the first and poses and velocities within tests/test_frame2.py's
bounds for that batch (1e-3 and 5e-2).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import parallel as jpar  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402

from _torch_parity import (  # noqa: E402
    build,
    build_compound128,
    build_pile,
    jax_to_numpy,
    numpy_to_jax,
    to_jax_tables,
)

CAP = dict(max_bodies=128, max_colliders=128, max_pairs=1024, max_joints=0,
           max_verts=4)
CFG = dict(substeps=4, slot_capacity=8, batch_uniform_topology=False,
           max_colliders_per_body=3)
SETTLE, FRAMES = 13, 3


def _worlds(builder_cls, shape_cls, capacity_cls):
    """World 0: the iota pile (seed 0); world 1: the compound scene."""
    out = []
    for b in (build_pile(builder_cls, shape_cls, seed=0),
              build_compound128(builder_cls, shape_cls)[0]):
        out.append(build(b, capacity_cls(**CAP))[0])
    return out


@pytest.fixture(scope="module")
def batches():
    ja, jb = _worlds(JBuilder, JShape, JCapacity)
    ta, tb = _worlds(st.WorldBuilder, st.Shape, st.Capacity)
    jw = jax.tree.map(lambda a, b: jnp.stack([a, b]), ja, jb)
    return jw, parallel.stack_worlds([ta, tb])


def test_owner_tables_match_jax(batches):
    """``(bcol, bmask, owner_overflow)`` equal to the reference's, at the
    scene's Kc = 3 and at Kc = 1, where the 3-collider compounds overflow
    (2 colliders past Kc each)."""
    jw, tw = batches
    for kc in (3, 1):
        ref = jpar.collider_owner_tables(
            jw, JConfig(batch_uniform_topology=False,
                        max_colliders_per_body=kc))
        got = parallel.collider_owner_tables(
            tw, st.SolverConfig(batch_uniform_topology=False,
                                max_colliders_per_body=kc))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert (int(got[2]) > 0) == (kc == 1)


def test_owner_csr_lists_each_world(batches):
    """The kernel's per-world CSR lists each body's active colliders,
    ascending, in each world."""
    _, tw = batches
    cfg = st.SolverConfig(**CFG)
    (start, idx), overflow = parallel.frame2_owners(tw, cfg)
    assert int(overflow) == 0
    cb = tw.colliders.body_idx
    act = (tw.colliders.flags & st.state.COL_ACTIVE) != 0
    for w in range(2):
        for n in range(tw.bodies.n):
            mine = torch.nonzero((cb[w] == n) & act[w]).flatten().tolist()
            got = idx[w, start[w, n]:start[w, n + 1]].tolist()
            assert got == mine, (w, n)


@pytest.fixture(scope="module")
def heterogeneous(batches):
    """The batch ``SETTLE`` frames in (the port's twin), then ``FRAMES``
    frames of each package from the same arrays and the same slot tables
    (built from the port's state): per frame ``(JAX, port)`` of ``(world,
    touched, aux)``."""
    jw, tw = batches
    cfg = st.SolverConfig(**CFG)
    tw, _, _ = parallel.batched_rollout(tw, cfg, 0, SETTLE,
                                        record=lambda _: None)
    jw = numpy_to_jax(tio.world_to_numpy(tw), jw)
    out = []
    for _ in range(FRAMES):
        tables = parallel.frame2_tables(tw, cfg)
        jw, jt, _, _, jaux = jpar.frame2_step(jw, JConfig(**CFG),
                                              interpret=True,
                                              tables=to_jax_tables(tables))
        tw, tt, _, _, taux = parallel.frame2_step(tw, cfg, tables=tables)
        out.append(((jw, np.asarray(jt), jaux), (tw, tt, taux)))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_heterogeneous_batch_matches_jax(heterogeneous, frame):
    (jw, jt, jaux), (tw, tt, taux) = heterogeneous[frame]
    if frame == 0:
        np.testing.assert_array_equal(jt, tt.numpy())
    assert float(tt.sum()) > 0, "no contact: vacuous"
    assert {k: int(v) for k, v in jaux.items()} == {
        k: int(v) for k, v in taux.items()}
    a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
    for k, tol in (("bodies/pos", 1e-3), ("bodies/angle", 1e-3),
                   ("bodies/vel", 5e-2), ("bodies/ang_vel", 5e-2)):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)


def test_uniform_batch_is_bitwise_the_uniform_path():
    """On a batch of one topology, per-world owner tables give bitwise the
    frame of world 0's lists, and a rollout's ``owner_overflow`` is 0."""
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=128, substeps=3,
                                  device="cpu")
    uni = dataclasses.replace(sc.config, slot_capacity=8)
    het = dataclasses.replace(uni, batch_uniform_topology=False)
    w, _, _ = parallel.batched_rollout(sc.world, uni, 0, 10,
                                       record=lambda _: None)
    a, _, da = parallel.batched_rollout(w, uni, 0, 3, record=lambda _: None)
    b, _, db = parallel.batched_rollout(w, het, 0, 3, record=lambda _: None)
    for f in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(a.bodies, f), getattr(b.bodies, f)), f
    assert {k: int(v) for k, v in da.items()} == {
        k: int(v) for k, v in db.items()}
