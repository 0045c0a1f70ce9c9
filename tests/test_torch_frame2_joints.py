"""The frame twin with joints (``hopper/frame2.py``) against the JAX
package's ``run_frame2(joints=...)`` (Pallas, interpret mode), both joint
tiers, on the same inputs: a jointed batch advanced into contact, its slot
tables and joint slots, one frame through both. ``touched`` equal;
positions to 2e-4, angles to 5e-4 and velocities to 2e-2, the frame-kernel
bounds of tests/test_frame2.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch.config import Capacity, SolverConfig  # noqa: E402

from _torch_parity import (  # noqa: E402
    build_jointed,
    frame2_args,
    jax_run_frame2,
)


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
    args, inputs = frame2_args(worlds, cfg,
                                  parallel.frame2_tables(worlds, cfg))
    ref = jax_run_frame2(args, inputs)
    got = hopper.run_frame2(*args, inputs)
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
    free = hopper.run_frame2(*args, dataclasses.replace(inputs,
                                                        joints=None))
    assert float(torch.abs(free[1] - got[1]).max()) > 1e-3
