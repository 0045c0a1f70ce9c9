"""The frame twin with joints (``hopper/frame2.py``) against the JAX
package's ``run_frame2(joints=...)`` (Pallas, interpret mode), both joint
tiers, on the same inputs: a jointed batch advanced into contact, its slot
tables and joint slots, one frame through both. ``touched`` equal;
positions to 2e-4, angles to 5e-4 and velocities to 2e-2, the frame-kernel
bounds of tests/test_frame2.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu.pallas.frame2 import run_frame2 as j_run_frame2  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch.config import Capacity, SolverConfig  # noqa: E402

from _torch_parity import build_jointed  # noqa: E402


def _jointed():
    b, cap = build_jointed(st.WorldBuilder, st.Shape)
    w, _ = b.build(Capacity(**cap), device="cpu")
    return st.replicate_world(w, 2), SolverConfig(substeps=4, slot_capacity=8)


def _mechanism():
    sc = st.scenes.batchify(
        st.scenes.mechanism(substeps=4, device="cpu"), 2)
    return sc.world, sc.config


SCENES = {"jointed": _jointed, "mechanism": _mechanism}
N_FRAMES = 30  # the wheel's paddles meet the circles, the pendulum swings


@pytest.mark.parametrize("solver", ["colored", "jacobi"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_frame_twin_with_joints_matches_pallas(name, solver):
    worlds, cfg = SCENES[name]()
    cfg = dataclasses.replace(cfg, joint_solver=solver)
    worlds, _, _ = parallel.batched_rollout(worlds, cfg, 0, N_FRAMES,
                                            record=lambda _: None)
    body, col = parallel._frame2_arrays(worlds, cfg)
    partner, slot_act, *_ = parallel.frame2_tables(worlds, cfg)
    joints, _ = parallel._frame2_joints(
        worlds, cfg, parallel.frame2_joint_slots(worlds, cfg))
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
                  lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
                  JC=cfg.joint_slot_capacity, joint_solver=solver,
                  n_colors=cfg.max_joint_colors, max_dpos_joint=cfg.max_dpos)
    # the JAX side pads the joint axis to 128 lanes (parallel.py:305-326);
    # padded rows are inactive and no slot points at them
    J = worlds.joints.j
    Jp = -(-J // 128) * 128
    j_joints = {}
    for k, v in joints.items():
        v = v.numpy()
        if v.ndim == 2:
            v = np.pad(v, ((0, 0), (0, Jp - J)),
                       constant_values=2 ** 20 if k == "jcolor" else 0)
        j_joints[k] = jnp.asarray(v)
    ref = j_run_frame2(*[jnp.asarray(t.numpy()) for t in inputs], j_joints,
                       jnp.asarray(gravity.numpy()), interpret=True,
                       **params)
    got = hopper.run_frame2(*inputs, gravity, joints=joints, **params)
    assert hopper.run_frame2.launches == 0  # CPU tensors took the twin

    touched = got[6].numpy()
    assert touched.sum() > 10, "no touching contacts: vacuous"
    np.testing.assert_array_equal(np.asarray(ref[6]), touched)
    names = ("posx", "posy", "ang", "velx", "vely", "angvel")
    tols = (2e-4, 2e-4, 5e-4, 2e-2, 2e-2, 2e-2)
    for field, a, b, tol in zip(names, ref[:6], got[:6], tols):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=tol, err_msg=field)
    # the joints acted: the same frame without them ends elsewhere
    free = hopper.run_frame2(*inputs, gravity, **{
        k: v for k, v in params.items()
        if k not in ("JC", "joint_solver", "n_colors", "max_dpos_joint")})
    assert float(torch.abs(free[1] - got[1]).max()) > 1e-3
