"""The slot-table broadphase twins (``hopper/slots.py``) against the JAX
package's Pallas kernels in interpret mode, on the same inputs: the
eligibility mask exactly, the slot tables with ``partner_aware`` off and on
(integer outputs equal, budget to rtol 1e-6). Also: CPU tensors take the
twins and leave every kernel launch counter at 0."""

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

from _torch_parity import build_pile, jax_to_numpy  # noqa: E402

CFG = SolverConfig(slot_capacity=5, frames_per_broadphase=4)


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
    from _torch_parity import numpy_to_jax

    return numpy_to_jax(arrays, j_replicate(jw, 2)), tio.world_from_numpy(
        arrays, "cpu")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_elig_twin_matches_pallas(worlds):
    jw, tw = worlds
    jb, jc = j_arrays(jw, CFG)
    ref = j_elig(jc["cbody"], jc["layer"], jc["lmask"], jc["active"],
                 jc["sensor"], jb["responds"], jb["moves"], interpret=True)
    got = parallel.frame2_elig(tw, CFG)
    np.testing.assert_array_equal(_np(ref), got.numpy())
    # the rules bite: layers, sensors and static rows all remove pairs
    assert 0 < got.numpy().mean() < 0.7


@pytest.mark.parametrize("partner_aware", [False, True])
def test_slot_twin_matches_pallas(worlds, partner_aware):
    jw, tw = worlds
    jb, jc = j_arrays(jw, CFG)
    frames = 4 if partner_aware else 1
    if partner_aware:
        vx, vy = j_sweep(jw, CFG, frames), None
    else:
        vx, vy = jb["velx"], jb["vely"]
    elig = j_elig(jc["cbody"], jc["layer"], jc["lmask"], jc["active"],
                  jc["sensor"], jb["responds"], jb["moves"], interpret=True)
    ref = j_tables(
        jb["posx"], jb["posy"], jb["ang"], vx, vy, jb["responds"],
        jb["moves"], jc["cbody"], jc["vlx"], jc["vly"], jc["radius"],
        jc["layer"], jc["lmask"], jc["active"], jc["sensor"], elig,
        C=CFG.slot_capacity, margin=CFG.contact_margin,
        dt=CFG.dt * frames, interpret=True, partner_aware=partner_aware)
    *got, budget = hopper.build_slot_tables(
        _t(jb["posx"]), _t(jb["posy"]), _t(jb["ang"]), _t(vx),
        None if vy is None else _t(vy), _t(jc["cbody"]), _t(jc["vlx"]),
        _t(jc["vly"]), _t(jc["radius"]), _t(elig), C=CFG.slot_capacity,
        margin=CFG.contact_margin, dt=CFG.dt * frames,
        partner_aware=partner_aware)
    for name, a, b in zip(("partner", "slot_act", "count", "count_touch",
                           "count_close"), ref[:5], got):
        np.testing.assert_array_equal(_np(a), b.numpy(), err_msg=name)
    np.testing.assert_allclose(_np(ref[5]), budget.numpy(), rtol=1e-6,
                               atol=0)
    # the run is not vacuous: rows overflow C, and tiers differ
    count = got[2].numpy()
    assert count.max() > CFG.slot_capacity
    assert got[3].numpy().max() > 0
    assert (got[4].numpy() < count).any()


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
    body, col = parallel._frame2_arrays(tw, CFG)
    args = [col["cbody"], col["layer"], col["lmask"], col["active"],
            col["sensor"], body["responds"], body["moves"]]
    with pytest.raises(ValueError, match="dtype"):
        hopper.build_elig_mask(*args[:3], args[3].double(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        hopper.build_elig_mask(*args[:6], body["moves"].t().contiguous().t())
    with pytest.raises(ValueError, match="symmetric"):
        hopper.build_slot_tables(
            body["posx"], body["posy"], body["ang"], body["velx"],
            body["vely"], col["cbody"], col["vlx"], col["vly"],
            col["radius"], parallel.frame2_elig(tw, CFG), C=8, margin=0.05,
            dt=0.1, partner_aware=True)
    with pytest.raises(ValueError, match="device"):
        hopper.build_elig_mask(*[a.to("meta") for a in args])
