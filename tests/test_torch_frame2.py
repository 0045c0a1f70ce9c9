"""The frame twin (``hopper/frame2.py``) against the JAX package's
``run_frame2`` (Pallas, interpret mode) on the same inputs: a world batch
advanced into contact, its slot tables, one frame through both. ``touched``
equal; positions to 2e-4, angles to 5e-4 and velocities to 2e-2, the
frame-kernel bounds of tests/test_frame2.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu.pallas.frame2 import run_frame2 as j_run_frame2  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch.config import Capacity, SolverConfig  # noqa: E402

from _torch_parity import build_pile  # noqa: E402


def _pile(cfg):
    cap = Capacity(max_bodies=128, max_colliders=128, max_pairs=1024,
                   max_joints=0, max_verts=4)
    w, _ = build_pile(st.WorldBuilder, st.Shape, seed=6).build(
        cap, device="cpu")
    return st.replicate_world(w, 2), cfg


def _batched(cfg):
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=256, substeps=3,
                                  seed=2, device="cpu")
    return sc.world, cfg


CASES = {
    "pile128": (_pile, SolverConfig(substeps=4, slot_capacity=8), 18),
    "batched256": (_batched, SolverConfig(
        substeps=3, slot_capacity=8, frames_per_broadphase=4), 14),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_twin_matches_pallas(case):
    make, cfg, n_frames = CASES[case]
    worlds, cfg = make(cfg)
    # advance into contact (the twin's rollout), then take one frame's
    # inputs: body/collider arrays and fresh K-frame slot tables
    worlds, _, _ = parallel.batched_rollout(worlds, cfg, 0, n_frames,
                                            record=lambda _: None)
    body, col = parallel._frame2_arrays(worlds, cfg)
    partner, slot_act, *_ = parallel.frame2_tables(
        worlds, cfg, frames=cfg.frames_per_broadphase)
    W = body["posx"].shape[0]
    gravity = worlds.gravity.expand(W, 2).contiguous()
    inputs = [body[k] for k in ("posx", "posy", "ang", "velx", "vely",
                                "angvel", "invm", "invi", "dyn", "kin")]
    inputs += [col[k] for k in ("cbody", "vlx", "vly", "nverts", "radius",
                                "fric", "rest", "sensor")]
    inputs += [partner, slot_act]
    params = dict(C=cfg.slot_capacity, substeps=cfg.substeps,
                  iterations=cfg.iterations, h=cfg.dt / cfg.substeps,
                  dt=cfg.dt, margin=cfg.contact_margin,
                  compliance=cfg.contact_compliance,
                  relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
                  rest_threshold=cfg.restitution_threshold,
                  lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    ref = j_run_frame2(*[jnp.asarray(t.numpy()) for t in inputs],
                       gravity=jnp.asarray(gravity.numpy()), interpret=True,
                       **params)
    got = hopper.run_frame2(*inputs, gravity, **params)
    assert hopper.run_frame2.launches == 0  # CPU tensors took the twin

    touched = got[6].numpy()
    assert touched.sum() > 10, "no touching contacts: vacuous"
    np.testing.assert_array_equal(np.asarray(ref[6]), touched)
    names = ("posx", "posy", "ang", "velx", "vely", "angvel")
    tols = (2e-4, 2e-4, 5e-4, 2e-2, 2e-2, 2e-2)
    for name, a, b, tol in zip(names, ref[:6], got[:6], tols):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    # the frame moved things: contacts pushed back against gravity
    assert float(torch.abs(got[4] - body["vely"]).max()) > 0.1


def test_off_slice_configs_raise():
    sc = st.scenes.batched_worlds(n_worlds=1, n_bodies=256, substeps=2,
                                  device="cpu")
    import dataclasses

    for kw, what in ((dict(batch_solve_capacity=4), "compaction"),
                     (dict(batch_uniform_topology=False), "owner tables"),
                     (dict(sleep_velocity=0.1), "sleeping"),
                     (dict(use_pallas=False), "A3")):
        cfg = dataclasses.replace(sc.config, **kw)
        with pytest.raises(NotImplementedError, match=what):
            parallel.frame2_step(sc.world, cfg)
    # CCD is on the slice now (tests/test_torch_frame2_ccd.py)
    cfg = dataclasses.replace(sc.config, ccd=True)
    assert int(parallel.frame2_step(sc.world, cfg)[0].step_count) == 1
