"""The slot-table broadphase twins (``hopper/slots.py``) against the JAX
package's Pallas kernels in interpret mode, on the same inputs: the
eligibility mask exactly, the slot tables with ``partner_aware`` off and on
(integer outputs equal, budget to rtol 1e-6). The edge cases the CUDA
kernels must meet are pinned here too: 200 colliders (not a multiple of 32
or 16) at C = 32 and C = 1 with rows past C in every tier, layers 0 and 31
(a negative mask), a sensor on a moving body, a collider inactive in one
world, and the colliders in a shuffled index order. Also: CPU tensors take
the twins and leave every kernel launch counter at 0."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from starframe_tpu.config import Capacity, SolverConfig  # noqa: E402
from starframe_tpu.pallas.slots import (  # noqa: E402
    build_elig_mask as j_elig,
    build_slot_tables as j_tables,
)
from starframe_tpu.parallel import (  # noqa: E402
    _frame2_arrays as j_arrays,
    _sweep_bounds as j_sweep,
    replicate_world as j_replicate,
)
from starframe_tpu.shapes import Shape  # noqa: E402
from starframe_tpu.state import WorldBuilder  # noqa: E402

from starframe_tpu_torch import hopper, io as tio, parallel  # noqa: E402
import starframe_tpu_torch as st  # noqa: E402

from _torch_parity import (  # noqa: E402
    build_pile,
    jax_to_numpy,
    numpy_to_jax,
    shuffle_colliders,
    slot_edge_arrays,
)

CFG = SolverConfig(slot_capacity=5, frames_per_broadphase=4)
EDGE_M = 200  # a partial last 32-partner chunk; rows not 16-byte aligned


@pytest.fixture(scope="module")
def worlds():
    """A 2-world batch with a sensor and a second collision layer; world 1
    is jostled (positions into contact, fast velocities, so rows fill all
    three tiers and overflow C). As (jax world, torch world)."""
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    jw, _ = build_pile(WorldBuilder, Shape, seed=5, sensor_idx=3,
                       layered=True).build(cap)
    arrays = jax_to_numpy(j_replicate(jw, 2))
    rng = np.random.default_rng(9)
    dyn = arrays["bodies/inv_mass"][1] > 0
    for key, scale in (("bodies/pos", 0.25), ("bodies/vel", 20.0)):
        x = arrays[key].copy()
        x[1, dyn] += rng.normal(scale=scale, size=x[1, dyn].shape).astype(
            np.float32)
        arrays[key] = x
    return numpy_to_jax(arrays, j_replicate(jw, 2)), tio.world_from_numpy(
        arrays, "cpu")


@pytest.fixture(scope="module")
def edge():
    """A 2-world batch of ``EDGE_M`` colliders (the ground and 199 mixed
    bodies, body 5 a sensor with mass) edited by ``slot_edge_arrays``, in
    the WorldBuilder's index order and shuffled. The JAX kernels take only
    multiples of 128, so their world pads the batch to 256 inactive-capped
    colliders and bodies; the port's holds the ``EDGE_M`` colliders alone.
    As ``{order: (jax world, torch world)}``."""
    cap = Capacity(max_bodies=256, max_colliders=256, max_pairs=8 * EDGE_M,
                   max_joints=0, max_verts=4)
    jw, _ = build_pile(WorldBuilder, Shape, n=EDGE_M, seed=3,
                       sensor_idx=4).build(cap)
    like = j_replicate(jw, 2)
    arrays = slot_edge_arrays(jax_to_numpy(like))
    out = {}
    for order, a in (("built", arrays),
                     ("shuffled", shuffle_colliders(arrays, n=EDGE_M))):
        cut = {k: (np.ascontiguousarray(v[:, :EDGE_M])
                   if k.startswith("colliders/") else v)
               for k, v in a.items()}
        out[order] = numpy_to_jax(a, like), tio.world_from_numpy(cut, "cpu")
    return out


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _elig_case(jw, tw, cfg):
    """The eligibility twin against ``_elig_kernel``; returns the mask."""
    jb, jc = j_arrays(jw, cfg)
    ref = j_elig(jc["cbody"], jc["layer"], jc["lmask"], jc["active"],
                 jc["sensor"], jb["responds"], jb["moves"], interpret=True)
    got = parallel.frame2_elig(tw, cfg).numpy()
    M = got.shape[-1]  # the JAX world may pad the colliders past M
    ref = _np(ref)
    np.testing.assert_array_equal(ref[:, :M, :M], got)
    assert not ref[:, M:].any() and not ref[:, :, M:].any()
    return got


def _slot_case(jw, tw, cfg, partner_aware):
    """The slot-table twin against ``_slot_kernel``; returns the twin's
    ``(count, count_touch, count_close)``."""
    jb, jc = j_arrays(jw, cfg)
    frames = 4 if partner_aware else 1
    if partner_aware:
        vx, vy = j_sweep(jw, cfg, frames), None
    else:
        vx, vy = jb["velx"], jb["vely"]
    elig = j_elig(jc["cbody"], jc["layer"], jc["lmask"], jc["active"],
                  jc["sensor"], jb["responds"], jb["moves"], interpret=True)
    ref = j_tables(
        jb["posx"], jb["posy"], jb["ang"], vx, vy, jb["responds"],
        jb["moves"], jc["cbody"], jc["vlx"], jc["vly"], jc["radius"],
        jc["layer"], jc["lmask"], jc["active"], jc["sensor"], elig,
        C=cfg.slot_capacity, margin=cfg.contact_margin,
        dt=cfg.dt * frames, interpret=True, partner_aware=partner_aware)
    tc = parallel.frame2_inputs(tw, cfg).k4
    M = tc.cbody.shape[1]
    *got, budget = hopper.build_slot_tables(
        _t(jb["posx"]), _t(jb["posy"]), _t(jb["ang"]), _t(vx),
        None if vy is None else _t(vy), tc.cbody, tc.vlx, tc.vly,
        tc.radius, _t(_np(elig)[:, :M, :M]), C=cfg.slot_capacity,
        margin=cfg.contact_margin, dt=cfg.dt * frames,
        partner_aware=partner_aware)
    M = budget.shape[-1]  # the JAX world may pad the colliders past M
    for name, a, b in zip(("partner", "slot_act", "count", "count_touch",
                           "count_close"), ref[:5], got):
        np.testing.assert_array_equal(_np(a)[..., :M], b.numpy(),
                                      err_msg=name)
        assert not _np(a)[..., M:].any(), name
    np.testing.assert_allclose(_np(ref[5])[..., :M], budget.numpy(),
                               rtol=1e-6, atol=0)
    return tuple(t.numpy() for t in got[2:5])


def test_elig_twin_matches_pallas(worlds):
    got = _elig_case(*worlds, CFG)
    # the rules bite: layers, sensors and static rows all remove pairs
    assert 0 < got.mean() < 0.7


@pytest.mark.parametrize("partner_aware", [False, True])
def test_slot_twin_matches_pallas(worlds, partner_aware):
    count, touch, close = _slot_case(*worlds, CFG, partner_aware)
    # the run is not vacuous: rows overflow C, and tiers differ
    assert count.max() > CFG.slot_capacity
    assert touch.max() > 0
    assert (close < count).any()


def test_elig_twin_matches_pallas_edge(edge):
    jw, tw = edge["built"]
    got = _elig_case(jw, tw, CFG)
    _elig_case(*edge["shuffled"], CFG)
    top = np.arange(EDGE_M) % 5 == 2  # layer 31, hitting only layer 31
    assert got[0][np.ix_(top, top)].any()
    assert not got[0][np.ix_(~top, top)].any()
    assert not got[0][np.ix_(top, ~top)].any()
    # collider 7 is inactive in world 1 only
    assert got[0, 7].any() and got[0, :, 7].any()
    assert not got[1, 7].any() and not got[1, :, 7].any()
    # the moving sensor (body 5) has a row and is a partner
    assert got[0, 0, 5] and got[0, 5].any()


@pytest.mark.parametrize("order, C, partner_aware", [
    ("built", 32, False), ("built", 32, True), ("built", 1, True),
    ("shuffled", 32, True)])
def test_slot_twin_matches_pallas_edge(edge, order, C, partner_aware):
    import dataclasses

    cfg = dataclasses.replace(CFG, slot_capacity=C)
    count, touch, close = _slot_case(*edge[order], cfg, partner_aware)
    # rows pass C within the touch tier, within the swept tier, and with
    # candidates in all three tiers
    assert (touch > C).any()
    assert ((close < C) & (count > C)).any() or C == 1
    assert ((touch > 0) & (close > touch) & (count > close)
            & (count > C)).any()


def test_sweep_bounds_match_jax(worlds):
    """The port's K-frame sweep bounds against the JAX package's, to the
    budget tolerance (XLA may fuse the chain into fused multiply-adds)."""
    jw, tw = worlds
    np.testing.assert_allclose(
        _np(j_sweep(jw, CFG, 4)), parallel._sweep_bounds(tw, CFG, 4).numpy(),
        rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_twins():
    counters = (hopper.build_elig_mask, hopper.build_slot_tables,
                hopper.run_frame2)
    for f in counters:
        f.launches = 0
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=2,
                                  device="cpu")
    w, traj, diag = st.batched_rollout(sc.world, sc.config, 0, 2)
    assert [f.launches for f in counters] == [0, 0, 0]
    assert traj[0].shape == (2, 2, 256, 2)
    assert int(diag["slot_overflow"]) == 0


def test_kernel_wrappers_check_their_inputs(worlds):
    _, tw = worlds
    inputs = parallel.frame2_inputs(tw, CFG)
    args = list(inputs.elig)
    with pytest.raises(ValueError, match="dtype"):
        hopper.build_elig_mask(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        hopper.build_elig_mask(*args[:6], args[6].t().contiguous().t())
    (posx, posy, ang, velx, vely, _), _ = parallel.frame2_planes(tw, CFG)
    k4 = inputs.k4
    with pytest.raises(ValueError, match="symmetric"):
        hopper.build_slot_tables(
            posx, posy, ang, velx, vely, k4.cbody, k4.vlx, k4.vly,
            k4.radius, parallel.frame2_elig(tw, CFG), C=8, margin=0.05,
            dt=0.1, partner_aware=True)
    with pytest.raises(ValueError, match="device"):
        hopper.build_elig_mask(*[a.to("meta") for a in args])
